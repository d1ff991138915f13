"""downsample: average a .dat time series by an integer factor
(src/downsample.c parity: writes <root>_DS<fact>.dat + .inf).

Host copy of ``presto_tpu/apps/downsample.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf, write_inf


def downsample_series(data: np.ndarray, fact: int) -> np.ndarray:
    keep = (len(data) // fact) * fact
    return data[:keep].reshape(-1, fact).mean(axis=1).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="downsample")
    p.add_argument("-factor", "-f", "--factor", type=int, default=2,
                   help="The factor to downsample the data")
    p.add_argument("-o", dest="outfile", type=str, default=None,
                   help="Name of the output time series file "
                        "(with suffix)")
    p.add_argument("datfile")
    args = p.parse_args(argv)
    base = os.path.splitext(args.datfile)[0]
    data = datfft.read_dat(args.datfile)
    out = downsample_series(data, args.factor)
    outbase = (os.path.splitext(args.outfile)[0] if args.outfile
               else "%s_DS%d" % (base, args.factor))
    datfft.write_dat(outbase + ".dat", out)
    if os.path.exists(base + ".inf"):
        info = read_inf(base + ".inf")
        info.name = outbase
        info.N = len(out)
        info.dt = info.dt * args.factor
        # on/off bin pairs reference sample indices: rescale them
        # (downsample.c divides by the factor the same way)
        info.onoff = [(a // args.factor,
                       min(b // args.factor, len(out) - 1))
                      for a, b in info.onoff]
        write_inf(info, outbase + ".inf")
    print("downsample: %s x%d -> %s.dat (%d pts)"
          % (args.datfile, args.factor, outbase, len(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
