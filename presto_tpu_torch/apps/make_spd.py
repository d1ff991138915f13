"""make_spd: build .spd diagnostic bundles for top single-pulse cands.

Host copy of ``presto_tpu/apps/make_spd.py`` for the PyTorch port.

Reference flow (lib/python/singlepulse/make_spd.py): for each selected
candidate, cut raw + dedispersed waterfalls from the raw file and save
everything plot_spd needs.  The JAX package's plot_spd renders the
PNGs; it needs matplotlib and is not in the port.
"""

from __future__ import annotations

import argparse
import os
import sys

from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.search.singlepulse import read_singlepulse
from presto_tpu_torch.singlepulse.spd import make_spd


def build_parser():
    p = argparse.ArgumentParser(prog="make_spd")
    p.add_argument("-n", type=int, default=5,
                   help="Bundle the N highest-sigma candidates")
    p.add_argument("--window", type=float, default=0.2,
                   help="Cutout length, seconds")
    p.add_argument("--nsub", type=int, default=32)
    p.add_argument("--downsamp", type=int, default=1)
    p.add_argument("-o", type=str, default=None,
                   help="Output basename (default: raw file root)")
    p.add_argument("rawfile")
    p.add_argument("spfiles", nargs="+")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cands = []
    for f in args.spfiles:
        cands.extend(read_singlepulse(f))
    cands.sort(key=lambda c: -c.sigma)
    top = cands[:args.n]
    base = args.o or os.path.splitext(args.rawfile)[0]
    reader = open_raw([args.rawfile])
    try:
        for i, c in enumerate(top):
            out = "%s_DM%.2f_%.3fs.spd" % (base, c.dm, c.time)
            make_spd(out, c, reader, context=cands,
                     window_sec=args.window, nsub=args.nsub,
                     downsamp=args.downsamp)
            print("make_spd: [%d/%d] %s (sigma=%.1f)"
                  % (i + 1, len(top), out, c.sigma))
    finally:
        reader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
