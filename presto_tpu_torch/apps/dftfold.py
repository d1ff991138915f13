"""dftfold: DFT vector folding of a .dat time series at one frequency.

Parity with src/dftfold.c (Ransom & Eikenberry vector-addition method):
the series is split into -n sub-vectors; each contributes its complex
DFT amplitude at the folding Fourier frequency; the output
<base>_<rr>.dftvec records the vector walk (phase evolution across the
observation).  Flags: -n, -r (Fourier bins) / -f (Hz) / -p (s),
-norm (power normalization) / -fftnorm (local power from <base>.fft).

Host copy of ``presto_tpu/apps/dftfold.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf


def dft_subvectors(data: np.ndarray, rr: float, numvect: int,
                   norm: float = 1.0) -> np.ndarray:
    """Complex DFT amplitude of each of numvect equal segments at
    Fourier frequency rr (bins over the FULL series) — the recurrence
    loop of dftfold.c:112-142, vectorized.  Returns [numvect] complex."""
    N = data.size
    n = N // numvect
    d = np.asarray(data[:n * numvect], np.float64).reshape(numvect, n)
    theta = -2.0 * np.pi * rr / float(N)
    # phase of global sample index j = i*n + k
    k = np.arange(n)
    seg_ph = np.exp(1j * theta * k)[None, :]
    start_ph = np.exp(1j * theta * (np.arange(numvect) * n))[:, None]
    vec = (d * seg_ph * start_ph).sum(axis=1)
    return norm * vec


def write_dftvector(path: str, vec: np.ndarray, n: int, dt: float,
                    r: float, norm: float, T: float) -> None:
    """Binary dftvector (include/dftfold.h:3-11 field order)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<2i", n, len(vec)))
        f.write(struct.pack("<4d", dt, r, norm, T))
        np.asarray(vec, np.complex64).tofile(f)


def read_dftvector(path: str):
    with open(path, "rb") as f:
        n, numvect = struct.unpack("<2i", f.read(8))
        dt, r, norm, T = struct.unpack("<4d", f.read(32))
        vec = np.fromfile(f, np.complex64, numvect)
    return dict(n=n, numvect=numvect, dt=dt, r=r, norm=norm, T=T,
                vector=vec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dftfold")
    p.add_argument("-n", type=int, default=16,
                   help="The number of DFT sub-vectors to save")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-r", type=float, help="Fourier frequency, bins")
    g.add_argument("-f", type=float, help="Frequency, Hz")
    g.add_argument("-p", type=float, help="Period, s")
    p.add_argument("-norm", type=float, default=None,
                   help="Raw power divided by this normalizes")
    p.add_argument("-fftnorm", action="store_true",
                   help="Use local power from <base>.fft as the norm")
    p.add_argument("datfile")
    args = p.parse_args(argv)
    base = os.path.splitext(args.datfile)[0]
    data = datfft.read_dat(base + ".dat")
    info = read_inf(base + ".inf")
    N = data.size
    T = N * info.dt
    if args.r is not None:
        rr = args.r
    elif args.f is not None:
        rr = args.f * T
    else:
        rr = T / args.p
    norm = 1.0
    if args.norm is not None:
        norm = 1.0 / np.sqrt(args.norm)
    elif args.fftnorm:
        from presto_tpu_torch.search.optimize import get_localpower
        amps = datfft.read_fft(base + ".fft")
        norm = 1.0 / np.sqrt(get_localpower(amps, rr))
    vec = dft_subvectors(data, rr, args.n, norm)
    tot = vec.sum()
    power = tot.real ** 2 + tot.imag ** 2
    print("dftfold: folding r=%.5f (f=%.11g Hz, p=%.14g s)"
          % (rr, rr / T, T / rr))
    print("  sub-vectors=%d  pts each=%d  norm const=%g"
          % (args.n, N // args.n, norm * norm))
    print("  vector sum = %.3f + %.3fi   total phase = %.2f deg   "
          "total power = %.2f"
          % (tot.real, tot.imag,
             float(np.degrees(np.angle(tot)) % 360.0), power))
    out = "%s_%.3f.dftvec" % (base, rr)
    write_dftvector(out, vec, N // args.n, info.dt, rr, norm, T)
    print("  wrote %s" % out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
