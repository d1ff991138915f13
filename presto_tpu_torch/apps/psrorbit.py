"""psrorbit: show the orbital modulation of a binary pulsar
(src/psrorbit.c: plots observed period/velocity vs orbital phase).
Writes a PNG (and prints a short table) for given orbit params or a
catalog pulsar.

Host copy of ``presto_tpu/apps/psrorbit.py`` for the PyTorch port, which
imports nothing from the JAX package. The figure needs matplotlib, which
the card machine does not have: there it raises ImportError.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psrorbit")
    p.add_argument("-psr", type=str, default=None,
                   help="Pulsar name from the catalog")
    p.add_argument("-p", type=float, default=None, help="Spin period, s")
    p.add_argument("-porb", type=float, default=None,
                   help="Orbital period, s")
    p.add_argument("-x", type=float, default=None,
                   help="a sin(i)/c, lt-s")
    p.add_argument("-e", type=float, default=0.0)
    p.add_argument("-w", type=float, default=0.0)
    p.add_argument("-o", type=str, default="psrorbit.png")
    args = p.parse_args(argv)

    if args.psr:
        from presto_tpu_torch.utils.catalog import default_catalog
        psr = default_catalog().params(args.psr)
        if psr is None or psr.orb is None or not psr.orb.p:
            raise SystemExit("psrorbit: %s not found or not a binary"
                             % args.psr)
        # catalog orbital period is in days until psrepoch()
        p_psr, orbp, x = 1.0 / psr.f, psr.orb.p * 86400.0, psr.orb.x
        e, w = psr.orb.e, psr.orb.w
    else:
        if not (args.p and args.porb and args.x):
            raise SystemExit("psrorbit: need -psr or all of -p -porb -x")
        p_psr, orbp, x, e, w = args.p, args.porb, args.x, args.e, args.w

    from presto_tpu_torch.search.orbitfit import OrbitFit, predicted_period
    fit = OrbitFit(p_psr=p_psr, p_orb=orbp, x=x, T0=0.0, e=e, w=w)
    t = np.linspace(0.0, orbp, 512)
    pd = predicted_period(t, fit)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(t / orbp, (pd - p_psr) * 1e3, "k-")
    ax.set_xlabel("Orbital phase")
    ax.set_ylabel("Period deviation (ms)")
    ax.set_title("P=%.6g s  Porb=%.6g s  x=%.4g lt-s  e=%.3g"
                 % (p_psr, orbp, x, e))
    fig.tight_layout()
    fig.savefig(args.o, dpi=100)
    plt.close(fig)
    dev = np.ptp(pd) / 2.0
    print("psrorbit: max period deviation +/-%.6g ms -> %s"
          % (dev * 1e3, args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
