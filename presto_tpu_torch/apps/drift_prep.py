"""drift_prep: split a raw drift scan into overlapping per-pointing
filterbank files (the GBT350_drift_prep.py / GUPPI_drift_prep.py
analog, bin/GBT350_drift_prep.py:17-33).

    python -m presto_tpu_torch.apps.drift_prep scan.fil          # all
    python -m presto_tpu_torch.apps.drift_prep -num 3 scan.fil   # one
    python -m presto_tpu_torch.apps.drift_prep -nmax scan.fil    # count

Host copy of ``presto_tpu/apps/drift_prep.py`` for the PyTorch port.
Unlike the Spigot-only reference script this reads anything open_raw
can (SIGPROC/PSRFITS, multi-file scans) and computes per-pointing RA
from the sidereal drift rate (pipeline/driftprep.py).
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.pipeline.driftprep import (ORIG_N, OVERLAP_FACTOR,
                                                 plan_pointings,
                                                 split_drift_scan)


def build_parser():
    p = argparse.ArgumentParser(prog="drift_prep")
    p.add_argument("-num", type=int, default=None,
                   help="cut only this pointing (0..NMAX); default all")
    p.add_argument("-nmax", action="store_true",
                   help="print NMAX (highest pointing number) and exit")
    p.add_argument("-orign", type=int, default=ORIG_N,
                   help="samples per pointing (default %d)" % ORIG_N)
    p.add_argument("-overlap", type=float, default=OVERLAP_FACTOR,
                   help="pointing overlap fraction (default %.2f)"
                   % OVERLAP_FACTOR)
    p.add_argument("-prefix", type=str, default="drift")
    p.add_argument("-outdir", type=str, default=".")
    p.add_argument("rawfiles", nargs="+")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.nmax:
        fb = open_raw(args.rawfiles)
        try:
            hdr = fb.header
            plan = plan_pointings(int(fb.nspectra), hdr.tsamp,
                                  hdr.tstart, hdr.src_raj,
                                  hdr.src_dej, orig_N=args.orign,
                                  overlap_factor=args.overlap)
        finally:
            fb.close()
        print(len(plan) - 1)
        return 0
    paths = split_drift_scan(args.rawfiles, outdir=args.outdir,
                             orig_N=args.orign,
                             overlap_factor=args.overlap,
                             pointing=args.num, prefix=args.prefix)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
