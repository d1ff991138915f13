"""plot_spd: render .spd single-pulse diagnostic bundles to PNG.

Host copy of ``presto_tpu/apps/plot_spd.py`` for the PyTorch port, which
imports nothing from the JAX package; drawing needs matplotlib
(ImportError naming it where it is missing).
"""

from __future__ import annotations

import argparse
import os
import sys

from presto_tpu_torch.singlepulse.spd import read_spd


def build_parser():
    p = argparse.ArgumentParser(prog="plot_spd")
    p.add_argument("-o", type=str, default=None,
                   help="Output file (single input only); default "
                        "<input>.png")
    p.add_argument("spdfiles", nargs="+")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import plot_spd
    if args.o and len(args.spdfiles) > 1:
        raise SystemExit("-o only valid with a single .spd input")
    for f in args.spdfiles:
        out = args.o or (os.path.splitext(f)[0] + ".png")
        plot_spd(read_spd(f), out)
        print("plot_spd: %s -> %s" % (f, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
