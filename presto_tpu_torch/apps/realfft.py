"""realfft: forward/inverse packed real FFT of .dat/.fft files.

PyTorch counterpart of ``presto_tpu/apps/realfft.py``, with its flags
(src/realfft.c:32-): positional data files, -fwd/-inv to force the
direction (default: .dat -> forward, .fft -> inverse), -del to remove
the input after success, -disk/-mem to force the out-of-core or the
in-core path, -tmpdir for the out-of-core scratch, -outdir for the
results.  Like the reference (src/realfft.c:179, include/meminfo.h:4),
a series longer than ops/oocfft.MAXREALFFT floats goes to the two-pass
disk FFT (host, disk-bound; its bytes equal the JAX package's).

The in-core transform runs through ``torch.fft`` on ``device`` at every
length (ops/fftpack): the JAX package sends lengths that are not
7-smooth through host pocketfft, because XLA can make a dense DFT of
them; cuFFT takes any length, so the port has no such branch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf, write_inf
from presto_tpu_torch.ops import fftpack, oocfft
from presto_tpu_torch.search.accel import resolve_device


def build_parser():
    p = argparse.ArgumentParser(prog="realfft")
    p.add_argument("-fwd", action="store_true")
    p.add_argument("-inv", action="store_true")
    p.add_argument("-del", dest="delete", action="store_true",
                   help="Remove the input file on success")
    p.add_argument("-disk", action="store_true",
                   help="Force the out-of-core two-pass disk FFT")
    p.add_argument("-mem", action="store_true",
                   help="Force the in-core FFT regardless of size")
    p.add_argument("-tmpdir", type=str, default=None,
                   help="Scratch directory for out-of-core temp files")
    p.add_argument("-outdir", type=str, default=None,
                   help="Directory where result files will reside")
    p.add_argument("datafiles", nargs="+")
    return p


def forward_packed(data: np.ndarray, device) -> np.ndarray:
    """The packed spectrum (complex64 [n//2]) of the even-length prefix
    of host series ``data``, transformed on ``device``."""
    n = data.size & ~1
    x = torch.as_tensor(np.ascontiguousarray(data[:n]), device=device)
    return fftpack.np_pairs_to_complex64(
        fftpack.realfft_packed_pairs(x).cpu().numpy())


def inverse_series(amps: np.ndarray, device) -> np.ndarray:
    """The float32 series of host packed spectrum ``amps``, transformed
    on ``device``."""
    p = torch.as_tensor(fftpack.np_complex64_to_pairs(amps), device=device)
    return fftpack.irealfft_packed_pairs(p).cpu().numpy()


def run_one(path: str, forward: bool, delete: bool,
            disk: bool = False, mem: bool = False,
            tmpdir: str | None = None, outdir: str | None = None,
            device="cuda") -> str:
    """Transform one file; returns the path written."""
    base, _ext = os.path.splitext(path)
    info = read_inf(base)
    obase = (os.path.join(outdir, os.path.basename(base)) if outdir
             else base)
    if forward:
        src = base + ".dat"
        out = obase + ".fft"
        nfloats = os.path.getsize(src) // 4
        if not mem and nfloats >= 8 and (disk or
                                         nfloats > oocfft.MAXREALFFT):
            oocfft.realfft_ooc(src, out, forward=True, tmpdir=tmpdir)
        else:
            datfft.write_fft(out, forward_packed(datfft.read_dat(src),
                                                 device))
    else:
        src = base + ".fft"
        out = obase + ".dat"
        namps = os.path.getsize(src) // 8
        if not mem and namps >= 4 and (disk or
                                       2 * namps > oocfft.MAXREALFFT):
            oocfft.realfft_ooc(src, out, forward=False, tmpdir=tmpdir)
        else:
            datfft.write_dat(out, inverse_series(datfft.read_fft(src),
                                                 device))
    write_inf(info, obase + ".inf")
    if delete:
        os.remove(src)
    print("realfft: wrote %s" % out)
    return out


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    for path in args.datafiles:
        ext = os.path.splitext(path)[1]
        forward = args.fwd or (ext == ".dat" and not args.inv)
        run_one(path, forward, args.delete, disk=args.disk,
                mem=args.mem, tmpdir=args.tmpdir, outdir=args.outdir,
                device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
