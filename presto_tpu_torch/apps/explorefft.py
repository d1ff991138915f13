"""explorefft: browse a .fft power spectrum (src/explorefft.c parity).

Interactive (zoom/pan/harmonic markers) when a GUI matplotlib backend
is available; otherwise renders the requested window to a PNG — the
same viewer logic either way (plotting/explore.py).

Host copy of ``presto_tpu/apps/explorefft.py`` for the PyTorch port,
which imports nothing from the JAX package. The viewer needs matplotlib,
which the card machine does not have: there a run raises ImportError
naming it before it reads the spectrum.
"""

from __future__ import annotations

import argparse

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.plotting.explore import (SpectrumView, render_spectrum,
                                               run_explorer)


def build_parser():
    p = argparse.ArgumentParser(prog="explorefft")
    p.add_argument("fftfile")
    p.add_argument("-lof", type=float, default=None,
                   help="Low frequency (Hz) of the initial window")
    p.add_argument("-hif", type=float, default=None,
                   help="High frequency (Hz) of the initial window")
    p.add_argument("-png", default=None,
                   help="Render to this PNG instead of interacting")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import pyplot
    pyplot("explorefft")
    base = args.fftfile[:-4] if args.fftfile.endswith(".fft") \
        else args.fftfile
    amps = datfft.read_fft(base + ".fft")
    info = read_inf(base)
    T = float(info.N) * info.dt
    powers = (amps.real ** 2 + amps.imag ** 2).astype(np.float64)
    powers[0] = amps[0].real ** 2        # packed DC
    lobin, numbins = 0, 0
    if args.lof is not None or args.hif is not None:
        lo = max(0.0, args.lof or 0.0)
        hi = args.hif if args.hif is not None else len(powers) / T
        lobin = int(lo * T)
        numbins = max(32, int((hi - lo) * T))
    view = SpectrumView(powers=powers, T=T, lobin=lobin,
                        numbins=numbins)
    mode = run_explorer(view, render_spectrum, out_png=args.png)
    if mode != "interactive":
        print("explorefft: wrote %s" % mode)
    return 0


if __name__ == "__main__":
    main()
