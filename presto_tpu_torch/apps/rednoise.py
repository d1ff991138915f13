"""rednoise: de-redden a .fft file (src/rednoise.c parity: divide the
spectrum by a running log-spaced median-block noise level; writes
<root>_red.fft).

Host copy of ``presto_tpu/apps/rednoise.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


from presto_tpu_torch.io import datfft
from presto_tpu_torch.ops.rednoise import deredden


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rednoise")
    p.add_argument("-startwidth", type=int, default=6,
                   help="Accepted for parity (deredden chooses widths)")
    p.add_argument("-endwidth", type=int, default=100)
    p.add_argument("-endfreq", type=float, default=6.0)
    p.add_argument("fftfile")
    args = p.parse_args(argv)
    base = os.path.splitext(args.fftfile)[0]
    amps = datfft.read_fft(args.fftfile)      # complex64 packed bins
    out = deredden(amps)
    outfile = base + "_red.fft"
    datfft.write_fft(outfile, out)
    if os.path.exists(base + ".inf"):
        shutil.copy(base + ".inf", base + "_red.inf")
    print("rednoise: %s -> %s" % (args.fftfile, outfile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
