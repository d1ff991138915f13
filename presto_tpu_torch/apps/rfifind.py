"""rfifind CLI: RFI statistics + mask generation from raw data.

PyTorch counterpart of ``presto_tpu/apps/rfifind.py`` (clig/rfifind_cmd
.cli; src/rfifind.c:53-): -time/-blocks, -timesig, -freqsig, -chanfrac,
-intfrac, -zapchan, -zapints, -zerodm, -mask, -ignorechan, -clip and
-nocompute (re-threshold from an existing .stats).  Writes
<o>_rfifind.mask and <o>_rfifind.stats (binary parity with the JAX
package and the reference), <o>_rfifind.inf, and <o>_rfifind_quality
.json, the reader's ingest quality report, whose quarantined stretches
become zapped intervals.  The intervals stream through the reader's
prefetching feeder and the pinned upload ring (pipeline/fusion
.feed_blocks); the per-cell statistics run on the device.

Unless -noplot is given, the mask summary plot is drawn to
<o>_rfifind.png (plotting/rfiplot; -rfips adds <o>_rfifind.ps, -xwin and
-rfixwin show it where a display is up).  Without matplotlib such a run
raises ImportError before any work.  The raw input is
whatever apps/common.open_raw_args opens: SIGPROC or PSRFITS, one file
or several as one observation (-psrfits/-filterbank choose the format);
-blocks sizes the intervals by the reader's block (NSBLK for PSRFITS,
2400 spectra for SIGPROC).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np

from presto_tpu_torch.apps.common import (add_common_flags, add_raw_flags,
                                          block_prep, fil_to_inf,
                                          obs_metadata, open_raw_args)
from presto_tpu_torch.io.infodata import read_inf, write_inf
from presto_tpu_torch.io.maskfile import read_statsfile
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.rfifind import (rfifind_from_stats,
                                             rfifind_stream,
                                             write_rfifind_products)
from presto_tpu_torch.utils.ranges import parse_ranges


def build_parser():
    p = argparse.ArgumentParser(prog="rfifind")
    add_common_flags(p)
    p.add_argument("-time", type=float, default=30.0,
                   help="Seconds per interval (use this or -blocks)")
    p.add_argument("-blocks", type=int, default=0,
                   help="Raw-data blocks per interval (beats -time; a "
                        "SIGPROC block is 2400 spectra)")
    p.add_argument("-timesig", type=float, default=10.0)
    p.add_argument("-freqsig", type=float, default=4.0)
    p.add_argument("-chanfrac", type=float, default=0.7)
    p.add_argument("-intfrac", type=float, default=0.3)
    p.add_argument("-zapchan", type=str, default=None,
                   help="Channels to zap, e.g. '0:3,45'")
    p.add_argument("-zapints", type=str, default=None)
    p.add_argument("-ignorechan", type=str, default=None,
                   help="Channels to ignore (zapped from the start)")
    p.add_argument("-clip", type=float, default=6.0)
    p.add_argument("-zerodm", action="store_true",
                   help="Subtract the per-sample band mean before "
                        "computing statistics")
    p.add_argument("-mask", type=str, default=None,
                   help="Existing .mask to apply while computing")
    p.add_argument("-nocompute", action="store_true",
                   help="Re-threshold from the existing "
                        "_rfifind.stats/.inf (no raw data read)")
    p.add_argument("-noplot", action="store_true",
                   help="Skip the mask summary plot")
    p.add_argument("-xwin", action="store_true",
                   help="Also draw plots to the screen")
    p.add_argument("-rfips", action="store_true",
                   help="Also write the summary plot as PostScript")
    p.add_argument("-rfixwin", action="store_true",
                   help="Show RFI instances on screen (with -xwin)")
    add_raw_flags(p, start_flags=False)
    p.add_argument("rawfiles", nargs="*")
    return p


def _plots(args, res, outbase):
    if args.noplot:
        return
    from presto_tpu_torch.plotting import plot_rfifind
    plot_rfifind(res, outbase + "_rfifind.png")
    print("rfifind: mask plot -> %s_rfifind.png" % outbase)
    if args.rfips:
        plot_rfifind(res, outbase + "_rfifind.ps")
        print("rfifind: mask plot -> %s_rfifind.ps" % outbase)
    if args.xwin or args.rfixwin:
        if os.environ.get("DISPLAY") or os.environ.get("MPLBACKEND"):
            import matplotlib.pyplot as plt
            plt.show()
        else:
            print("rfifind: no display available for -xwin/-rfixwin "
                  "(plots were written to files)")


def _zaps(args):
    """(zap_chans with -ignorechan merged in, zap_ints)."""
    zap_chans = parse_ranges(args.zapchan) if args.zapchan else []
    if args.ignorechan:
        zap_chans = sorted(set(zap_chans)
                           | set(parse_ranges(args.ignorechan)))
    zap_ints = parse_ranges(args.zapints) if args.zapints else []
    return zap_chans, zap_ints


def _run_nocompute(args):
    outbase = args.outfile or "rfifind_out"
    stats = read_statsfile(outbase + "_rfifind.stats")
    info = read_inf(outbase + "_rfifind")
    zap_chans, zap_ints = _zaps(args)
    res = rfifind_from_stats(
        stats, dt=info.dt, lofreq=info.freq, chanwidth=info.chan_wid,
        timesigma=args.timesig, freqsigma=args.freqsig,
        chantrigfrac=args.chanfrac, inttrigfrac=args.intfrac,
        mjd=info.mjd_i + info.mjd_f, zap_chans=zap_chans,
        zap_ints=zap_ints)
    res.info = {"filenm": getattr(info, "name", "") or "-",
                "telescope": info.telescope, "ra": info.ra_str,
                "dec": info.dec_str, "chanfrac": args.chanfrac,
                "intfrac": args.intfrac}
    write_rfifind_products(res, outbase)
    print("rfifind -nocompute: re-thresholded %d ints x %d chans, "
          "%.1f%% masked -> %s_rfifind.mask"
          % (res.mask.numint, res.mask.numchan,
             100 * res.masked_fraction(), outbase))
    _plots(args, res, outbase)
    return res


def run(args, device="cuda"):
    dev = resolve_device(device)
    if not args.noplot:     # a run that draws needs matplotlib: raise now
        from presto_tpu_torch.plotting import pyplot
        pyplot("rfifind's mask plot (-noplot skips it)")
    if args.nocompute:
        return _run_nocompute(args)
    if not args.rawfiles:
        raise SystemExit("rfifind: no raw files given")
    fb = open_raw_args(args.rawfiles, args)
    hdr = fb.header
    zap_chans, zap_ints = _zaps(args)
    if args.blocks > 0:
        # spectra_per_subint analog: NSBLK for PSRFITS, 2400 for
        # SIGPROC (rfifind.c:214, sigproc_fb.c:388)
        ptsperint = args.blocks * int(fb.ptsperblk)
    else:
        ptsperint = max(1, int(args.time / hdr.tsamp + 0.5))
    numint = hdr.N // ptsperint
    prep = block_prep(args, hdr.nchans, hdr.tsamp)
    with contextlib.closing(fusion.feed_blocks(
            fb, prep, ptsperint, numint, dev)) as feed:
        res = rfifind_stream((cells for _start, cells in feed), hdr.nchans,
                             ptsperint, dt=hdr.tsamp, lofreq=hdr.lofreq,
                             chanwidth=abs(hdr.foff),
                             timesigma=args.timesig,
                             freqsigma=args.freqsig,
                             chantrigfrac=args.chanfrac,
                             inttrigfrac=args.intfrac, mjd=hdr.tstart,
                             zap_chans=zap_chans, zap_ints=zap_ints)
    outbase = args.outfile or "rfifind_out"
    # ingest quarantine -> mask integration: stretches the reader
    # quarantined while streaming (NaN/Inf scrubs, zero-fill runs,
    # short reads) become zapped intervals exactly like statistical
    # RFI, and the report itself is written next to the mask
    quality = fb.quality
    extra = quality.zap_intervals(ptsperint, res.mask.numint)
    if extra:
        res.mask.zap_ints = np.asarray(
            sorted(set(res.mask.zap_ints.tolist()) | set(extra)), np.int32)
    if not quality.clean:
        print("rfifind: %s" % quality.summary())
    quality.write(outbase + "_rfifind_quality.json")
    write_rfifind_products(res, outbase)
    write_inf(fil_to_inf(fb, outbase + "_rfifind", hdr.N),
              outbase + "_rfifind.inf")
    tel, ra, dec = obs_metadata(fb)
    res.info = {"filenm": args.rawfiles[0], "telescope": tel,
                "ra": ra, "dec": dec, "chanfrac": args.chanfrac,
                "intfrac": args.intfrac}    # plot info block
    fb.close()
    print("rfifind: %d ints x %d chans, %.1f%% masked -> %s_rfifind.mask"
          % (res.mask.numint, res.mask.numchan,
             100 * res.masked_fraction(), outbase))
    _plots(args, res, outbase)
    return res


def main(argv=None, device="cuda"):
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("rfifind"):
        return run(args, device=device)


if __name__ == "__main__":
    main()
