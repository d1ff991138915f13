"""window: show the Fourier-interpolation window response
(src/window.c: the power response of an off-grid sinusoid through the
r-interpolation kernel).  Writes a PNG + prints the half-power width.

Host copy of ``presto_tpu/apps/window.py`` for the PyTorch port, which
imports nothing from the JAX package. The plot needs matplotlib, which
the card machine does not have: there a run raises ImportError naming it
before it computes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.ops.responses import gen_r_response


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="window")
    p.add_argument("-numbetween", type=int, default=16,
                   help="Interpolation oversampling")
    p.add_argument("-o", type=str, default="window.png")
    args = p.parse_args(argv)
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("window")
    nb = args.numbetween
    # response over +/-4 bins around the peak
    resp = np.asarray(gen_r_response(0.0, nb, 8 * nb))  # complex
    power = np.abs(resp) ** 2
    power = power / power.max()
    r = (np.arange(len(power)) - len(power) // 2) / nb

    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(r, power, "k-")
    ax.set_xlabel("Fourier bin offset r")
    ax.set_ylabel("Normalized power")
    ax.set_title("Fourier interpolation window")
    fig.tight_layout()
    fig.savefig(args.o, dpi=100)
    plt.close(fig)
    half = np.sum(power >= 0.5) / nb
    print("window: half-power width %.3f bins -> %s" % (half, args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
