"""makeinf: create a PRESTO `.inf` metadata sidecar
(src/makeinf.c analog — VERDICT round 5 missing micro-tool 2).

The reference is an interactive questionnaire; here every field is a
flag (scriptable), and `-i` runs the questionnaire for parity —
prompting with the current default, Enter keeps it.  The writer is
`io/infodata.write_inf`, the byte-compatible format already used by
every pipeline artifact.

  makeinf -o fake -N 1048576 -dt 6.4e-5 -freq 1400 -numchan 1024 \\
          -chanwid 0.39 -telescope GBT -object J0737-3039A

Host copy of ``presto_tpu/apps/makeinf.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.io.infodata import (ARTIFICIAL_TELESCOPE, InfoData,
                                          write_inf)


def build_parser():
    p = argparse.ArgumentParser(prog="makeinf")
    p.add_argument("-o", dest="outfile", type=str, required=True,
                   help="Output name (with or without .inf); also the "
                        "'data file name without suffix' field")
    p.add_argument("-i", dest="interactive", action="store_true",
                   help="Prompt for every field (reference makeinf "
                        "behavior); flags set the defaults shown")
    p.add_argument("-telescope", type=str,
                   default=ARTIFICIAL_TELESCOPE)
    p.add_argument("-instrument", type=str, default="Unknown")
    p.add_argument("-object", dest="object_", type=str,
                   default="Unknown")
    p.add_argument("-ra", type=str, default="00:00:00.0000",
                   help="J2000 RA (hh:mm:ss.ssss)")
    p.add_argument("-dec", type=str, default="00:00:00.0000",
                   help="J2000 Dec ([-]dd:mm:ss.ssss)")
    p.add_argument("-observer", type=str, default="Unknown")
    p.add_argument("-mjd", type=float, default=-1.0,
                   help="Epoch of observation (MJD)")
    p.add_argument("-bary", type=int, default=0, choices=(0, 1),
                   help="Data barycentered? (1 yes, 0 no)")
    p.add_argument("-N", type=float, required=True,
                   help="Number of bins in the time series")
    p.add_argument("-dt", type=float, required=True,
                   help="Width of each time series bin (sec)")
    p.add_argument("-band", type=str, default="Radio")
    p.add_argument("-fov", type=float, default=0.0,
                   help="Beam diameter (arcsec)")
    p.add_argument("-dm", type=float, default=0.0,
                   help="Dispersion measure (cm-3 pc)")
    p.add_argument("-freq", type=float, default=0.0,
                   help="Central freq of low channel (MHz)")
    p.add_argument("-freqband", type=float, default=0.0,
                   help="Total bandwidth (MHz)")
    p.add_argument("-numchan", type=int, default=1)
    p.add_argument("-chanwid", type=float, default=0.0,
                   help="Channel bandwidth (MHz)")
    p.add_argument("-analyzer", type=str, default="presto_tpu")
    p.add_argument("-notes", type=str, default="")
    return p


_PROMPTS = [
    ("telescope", "Telescope used", str),
    ("instrument", "Instrument used", str),
    ("object_", "Object being observed", str),
    ("ra", "J2000 Right Ascension (hh:mm:ss.ssss)", str),
    ("dec", "J2000 Declination (dd:mm:ss.ssss)", str),
    ("observer", "Data observed by", str),
    ("mjd", "Epoch of observation (MJD)", float),
    ("bary", "Barycentered? (1 yes, 0 no)", int),
    ("N", "Number of bins in the time series", float),
    ("dt", "Width of each time series bin (sec)", float),
    ("fov", "Beam diameter (arcsec)", float),
    ("dm", "Dispersion measure (cm-3 pc)", float),
    ("freq", "Central freq of low channel (MHz)", float),
    ("freqband", "Total bandwidth (MHz)", float),
    ("numchan", "Number of channels", int),
    ("chanwid", "Channel bandwidth (MHz)", float),
    ("analyzer", "Data analyzed by", str),
    ("notes", "Any additional notes", str),
]


def _interview(args, stdin=None) -> None:
    stdin = stdin or sys.stdin
    for attr, label, conv in _PROMPTS:
        cur = getattr(args, attr)
        sys.stdout.write("%s [%s]: " % (label, cur))
        sys.stdout.flush()
        line = stdin.readline()
        if not line:               # EOF: keep remaining defaults
            return
        s = line.strip()
        if s:
            setattr(args, attr, conv(s))


def info_from_args(args) -> InfoData:
    base = (args.outfile[:-4] if args.outfile.endswith(".inf")
            else args.outfile)
    mjd = float(args.mjd)
    mjd_i = int(mjd) if mjd >= 0 else -1
    return InfoData(
        name=base, telescope=args.telescope,
        instrument=args.instrument, object=args.object_,
        ra_str=args.ra, dec_str=args.dec, observer=args.observer,
        mjd_i=mjd_i, mjd_f=(mjd - mjd_i if mjd >= 0 else 0.0),
        bary=int(args.bary), N=float(args.N), dt=float(args.dt),
        band=args.band, fov=args.fov, dm=args.dm, freq=args.freq,
        freqband=args.freqband, num_chan=args.numchan,
        chan_wid=args.chanwid, analyzer=args.analyzer,
        notes=args.notes)


def main(argv=None, stdin=None) -> int:
    from presto_tpu_torch.apps.bary import join_dec_flag
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(join_dec_flag(argv))
    if args.interactive:
        _interview(args, stdin)
    info = info_from_args(args)
    path = write_inf(info, info.name + ".inf")
    print("makeinf: wrote %s" % path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
