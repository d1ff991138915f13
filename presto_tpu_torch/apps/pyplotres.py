"""pyplotres: plot timing residuals from a resid2.tmp
(bin/pyplotres.py, non-interactive: renders residuals vs MJD and vs
orbital phase to a PNG).

Host copy of ``presto_tpu/apps/pyplotres.py`` for the PyTorch port,
which imports nothing from the JAX package; the figure needs matplotlib
(ImportError naming it where it is missing).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.io.residuals import read_residuals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pyplotres")
    p.add_argument("-s", "--seconds", action="store_true",
                   help="Plot residuals in seconds (default: phase)")
    p.add_argument("-o", type=str, default="residuals.png")
    p.add_argument("residfile", nargs="?", default="resid2.tmp")
    args = p.parse_args(argv)
    r = read_residuals(args.residfile)
    y = r.postfit_sec if args.seconds else r.postfit_phs
    ylabel = "Residual (s)" if args.seconds else "Residual (phase)"
    err = r.uncertainty * 1e-6 if args.seconds else \
        np.zeros_like(r.uncertainty)

    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("pyplotres")
    has_orb = np.any(r.orbit_phs != 0.0)
    fig, axes = plt.subplots(1, 2 if has_orb else 1,
                             figsize=(10 if has_orb else 7, 4.5),
                             squeeze=False)
    ax = axes[0, 0]
    ax.errorbar(r.bary_TOA, y, yerr=err if args.seconds else None,
                fmt="k.", ms=4, capsize=2)
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.set_xlabel("MJD")
    ax.set_ylabel(ylabel)
    if has_orb:
        ax2 = axes[0, 1]
        ax2.plot(r.orbit_phs % 1.0, y, "k.", ms=4)
        ax2.axhline(0.0, color="0.6", lw=0.8)
        ax2.set_xlabel("Orbital phase")
    rms = float(np.sqrt(np.mean(y ** 2)))
    fig.suptitle("%d TOAs, rms = %.4g %s"
                 % (r.numTOAs, rms, "s" if args.seconds else "turns"))
    fig.tight_layout()
    fig.savefig(args.o, dpi=100)
    plt.close(fig)
    print("pyplotres: %d TOAs rms=%.4g -> %s"
          % (r.numTOAs, rms, args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
