"""search_bin: phase-modulation (miniFFT) binary pulsar search CLI.

PyTorch counterpart of ``presto_tpu/apps/search_bin.py``, with its
flags (clig/search_bin_cmd.cli): reads a .fft (+.inf) file, writes
<base>_bin<harmsum>.cand (binary rawbincand records) and
<base>_bin<harmsum>.txt (candidate table).  The search runs on
``device`` (search/phasemod).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.apps.common import load_spectrum
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.phasemod import (PhaseModConfig,
                                              rawbin_report,
                                              search_phasemod,
                                              write_bincands)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="search_bin",
        description="Phase-modulation binary search of a long FFT")
    p.add_argument("-ncand", type=int, default=100)
    p.add_argument("-minfft", type=int, default=32)
    p.add_argument("-maxfft", type=int, default=65536)
    p.add_argument("-flo", type=float, default=None,
                   help="Lowest freq (Hz) to search")
    p.add_argument("-fhi", type=float, default=None)
    p.add_argument("-rlo", type=float, default=1.0)
    p.add_argument("-rhi", type=float, default=None)
    p.add_argument("-lobin", type=int, default=0)
    p.add_argument("-overlap", type=float, default=0.25)
    p.add_argument("-harmsum", type=int, default=3)
    p.add_argument("-stack", type=int, default=0)
    p.add_argument("-numbetween", type=int, default=2, choices=(1, 2),
                   help="Points to interpolate per Fourier bin (2 = "
                        "bins + interbins, 1 = raw bins only)")
    p.add_argument("-interbin", action="store_true")
    p.add_argument("-noalias", action="store_true")
    p.add_argument("fftfile")
    return p


def run(args, device="cuda"):
    dev = resolve_device(device)
    if args.stack > 0:
        # stacked mode: the file holds pre-summed float32 POWERS, not
        # complex amplitudes (search_bin.c:243-246 read_float_file)
        from presto_tpu_torch.io.infodata import read_inf
        base = args.fftfile[:-4] if args.fftfile.endswith(".fft") \
            else args.fftfile
        spec = np.fromfile(base + ".fft", dtype=np.float32)
        info = read_inf(base)
    else:
        spec, info = load_spectrum(args.fftfile)
    N = float(info.N)
    T = N * info.dt
    rlo = args.rlo if args.flo is None else np.floor(args.flo * T)
    rhi = args.rhi if args.fhi is None else np.ceil(args.fhi * T)
    cfg = PhaseModConfig(ncand=args.ncand, minfft=args.minfft,
                         maxfft=args.maxfft, rlo=rlo, rhi=rhi,
                         lobin=args.lobin, overlap=args.overlap,
                         harmsum=args.harmsum, interbin=args.interbin,
                         numbetween=args.numbetween,
                         noalias=args.noalias, stack=args.stack)
    cands = search_phasemod(spec, N, info.dt, cfg, device=dev)
    base = args.fftfile[:-4] if args.fftfile.endswith(".fft") \
        else args.fftfile
    write_bincands("%s_bin%d.cand" % (base, args.harmsum), cands)
    with open("%s_bin%d.txt" % (base, args.harmsum), "w") as f:
        f.write(rawbin_report(cands))
    print("search_bin: %d candidates -> %s_bin%d.cand" %
          (len(cands), base, args.harmsum))
    return cands


def main(argv=None, device="cuda"):
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("search_bin"):
        run(args, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
