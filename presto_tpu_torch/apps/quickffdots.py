"""quickffdots: contour image of the f-fdot plane around one frequency.

Twin of bin/quickffdots.py: reads a .fft, computes the summed-harmonic
f-fdot power plane in a +-w_r x +-w_z window around the given
frequency (power_at_rz on the Fourier-interpolated grid — the same
matched-filter math accelsearch maximizes), and renders filled
contours at the reference's absolute power levels, reporting the peak.

Host copy of ``presto_tpu/apps/quickffdots.py`` for the PyTorch port,
which imports nothing from the JAX package. The contours need
matplotlib, which the card machine does not have: there a run raises
ImportError naming it before it reads the spectrum.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from presto_tpu_torch.io.datfft import read_fft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.search.optimize import power_at_rz

# absolute contour powers + alphas (bin/quickffdots.py:10-12)
ABS_CONVALS = np.asarray([5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 1e6])


def build_parser():
    p = argparse.ArgumentParser(
        prog="quickffdots",
        description="f-fdot contour window around a frequency")
    p.add_argument("-numharm", type=int, default=4,
                   help="harmonics to sum (default 4)")
    p.add_argument("-wr", type=float, default=10.0,
                   help="half-width in Fourier bins (default 10)")
    p.add_argument("-wz", type=float, default=20.0,
                   help="half-width in z (default 20)")
    p.add_argument("-nr", type=int, default=61)
    p.add_argument("-nz", type=int, default=41)
    p.add_argument("-o", "--output", default="")
    p.add_argument("fftfile")
    p.add_argument("freq", type=float, help="center frequency (Hz)")
    return p


def ffdot_window(amps, r0, numharm, wr, wz, nr, nz):
    rs = r0 + np.linspace(-wr, wr, nr)
    zs = np.linspace(-wz, wz, nz)
    plane = np.zeros((nz, nr))
    for h in range(1, numharm + 1):
        for iz, z in enumerate(zs):
            for ir, r in enumerate(rs):
                plane[iz, ir] += power_at_rz(amps, r * h, z * h)
    return rs, zs, plane


def main(argv=None):
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("quickffdots")
    base = os.path.splitext(args.fftfile)[0]
    amps = read_fft(args.fftfile)
    info = read_inf(base)
    T = info.N * info.dt
    # median-normalize locally like accelsearch's block norm
    r0 = args.freq * T
    lo = max(0, int(r0) - 4096)
    seg = amps[lo:int(r0) + 4096]
    norm = 1.0 / np.sqrt(np.median(np.abs(seg) ** 2) / np.log(2.0))
    amps = amps * norm
    rs, zs, plane = ffdot_window(amps, r0, args.numharm, args.wr,
                                 args.wz, args.nr, args.nz)
    iz, ir = np.unravel_index(np.argmax(plane), plane.shape)
    print("peak: f=%.9g Hz  fdot=%.4g Hz/s  power=%.2f (numharm=%d)"
          % (rs[ir] / T, zs[iz] / T ** 2, plane[iz, ir], args.numharm))
    fig, ax = plt.subplots(figsize=(7, 6))
    levels = [v for v in ABS_CONVALS if v < plane.max()] + \
        [max(plane.max() * 1.01, 1.0)]
    if len(levels) < 2:
        levels = [plane.max() / 2, plane.max() * 1.01]
    cs = ax.contourf(rs / T, zs / T ** 2, plane, levels=levels,
                     cmap="magma")
    fig.colorbar(cs, ax=ax, label="summed power")
    ax.plot(rs[ir] / T, zs[iz] / T ** 2, "c+", ms=12)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("fdot (Hz/s)")
    ax.set_title("%s  %d-harmonic f-fdot window"
                 % (os.path.basename(args.fftfile), args.numharm))
    out = args.output or base + ".ffdots.png"
    fig.savefig(out, dpi=100)
    plt.close(fig)
    print("quickffdots: wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
