"""bary: standalone topocentric<->barycentric time converter
(src/bary.c analog).

Host copy of ``presto_tpu/apps/bary.py`` for the PyTorch port, which
imports nothing from the JAX package.

Reads topocentric UTC MJDs from stdin (or files), one per line, and
prints barycentric TDB MJDs via the in-process barycentering chain
(astro/bary.py; the reference shells out to TEMPO).  `-inv` converts
the other way, iterating t_topo until barycenter(t_topo) matches the
input to sub-ns.

  echo 58000.5 | bary -ra 12:34:56.7 -dec -12:34:56.7 -obs GB
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.astro.bary import barycenter


def build_parser():
    p = argparse.ArgumentParser(
        prog="bary",
        description="Convert topocentric UTC MJDs (stdin or files, one "
                    "per line, '#' comments) to barycentric TDB MJDs.")
    p.add_argument("-ra", type=str, default="00:00:00.00",
                   help="J2000 RA of the source (hh:mm:ss.ssss)")
    p.add_argument("-dec", type=str, default="00:00:00.00",
                   help="J2000 Dec of the source ([+-]dd:mm:ss.ssss)")
    p.add_argument("-obs", type=str, default="GB",
                   help="Two-letter TEMPO observatory code")
    p.add_argument("-ephem", type=str, default="DE405",
                   help="Ephemeris (DE200/DE405, KEPLER, AUTO, or a .npz "
                        "table or .bsp kernel path)")
    p.add_argument("-inv", action="store_true",
                   help="Invert: read barycentric MJDs, print "
                        "topocentric")
    p.add_argument("-voverc", action="store_true",
                   help="Also print the site radial velocity (v/c) "
                        "column")
    p.add_argument("files", nargs="*",
                   help="Files of MJDs (default: stdin)")
    return p


def join_dec_flag(argv):
    """Fold '-dec -30:39:40' into '-dec=-30:39:40' so argparse does
    not mistake a negative declination for an option."""
    out, it = [], iter(argv)
    for a in it:
        if a == "-dec":
            v = next(it, None)
            out.append(a if v is None else "-dec=" + v)
        else:
            out.append(a)
    return out


def _read_mjds(files):
    streams = [open(f) for f in files] if files else [sys.stdin]
    mjds = []
    try:
        for stream in streams:
            for line in stream:
                s = line.split("#", 1)[0].strip()
                if s:
                    mjds.append(float(s))
    finally:
        for stream in streams:
            if stream is not sys.stdin:
                stream.close()
    return np.asarray(mjds, np.float64)


def topo_to_bary(mjds, args):
    return barycenter(mjds, args.ra, args.dec, obs=args.obs,
                      ephem=args.ephem)


def bary_to_topo(mjds, args, iters: int = 4):
    """Invert barycenter() by fixed-point iteration: the correction
    varies over hours while its magnitude is <~0.6 s, so each pass
    gains ~5 orders of magnitude; 4 passes reach float64 floor."""
    topo = np.array(mjds, np.float64)
    voverc = np.zeros_like(topo)
    for _ in range(iters):
        b, voverc = barycenter(topo, args.ra, args.dec, obs=args.obs,
                               ephem=args.ephem)
        topo = topo - (np.atleast_1d(b) - mjds)
    return topo, np.atleast_1d(voverc)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(join_dec_flag(argv))
    mjds = _read_mjds(args.files)
    if mjds.size == 0:
        print("bary: no MJDs on input", file=sys.stderr)
        return 1
    if args.inv:
        out, voverc = bary_to_topo(mjds, args)
    else:
        out, voverc = topo_to_bary(mjds, args)
        out, voverc = np.atleast_1d(out), np.atleast_1d(voverc)
    for t, v in zip(out, voverc):
        if args.voverc:
            print("%.12f  %+.10e" % (t, v))
        else:
            print("%.12f" % t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
