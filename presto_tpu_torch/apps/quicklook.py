"""quicklook: quick statistics + top spectral peaks of a .dat/.fft
(src/quicklook.c spirit: a fast sanity check before a full search).

PyTorch counterpart of ``presto_tpu/apps/quicklook.py``: a .dat's packed
real FFT runs on ``device`` (ops/fftpack); a .fft is read as it is.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.search.accel import resolve_device


def main(argv=None, device="cuda") -> int:
    dev = resolve_device(device)
    p = argparse.ArgumentParser(prog="quicklook")
    p.add_argument("-n", type=int, default=10,
                   help="Number of top peaks to list")
    p.add_argument("datafile")
    args = p.parse_args(argv)
    base, ext = os.path.splitext(args.datafile)
    if ext == ".dat":
        data = datfft.read_dat(args.datafile)
        print("N=%d  mean=%.6g  std=%.6g  min=%.6g  max=%.6g"
              % (len(data), data.mean(), data.std(), data.min(),
                 data.max()))
        n = 1 << int(np.floor(np.log2(len(data))))
        x = torch.from_numpy(data[:n] - data[:n].mean()).to(dev)
        packed = fftpack.realfft_packed_pairs(x).cpu().numpy()
        powers = (packed ** 2).sum(axis=-1)
    elif ext == ".fft":
        d = datfft.read_fft(args.datafile)    # complex64 packed bins
        powers = np.abs(d) ** 2
        n = 2 * len(powers)
        print("N=%d complex bins" % len(powers))
    else:
        raise SystemExit("quicklook needs a .dat or .fft file")
    dt = None
    if os.path.exists(base + ".inf"):
        dt = read_inf(base + ".inf").dt
    med = np.median(powers[1:])
    norm = powers / (med / np.log(2.0))
    k = np.argsort(norm[1:])[::-1][:args.n] + 1
    print("%6s %14s %12s" % ("bin", "freq(Hz)" if dt else "freq(1/N)",
                             "power/med"))
    for b in k:
        fr = b / (n * dt) if dt else b / n
        print("%6d %14.6f %12.2f" % (b, fr, norm[b]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
