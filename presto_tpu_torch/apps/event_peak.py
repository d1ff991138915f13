"""event_peak: H-test/Kuiper peak search over (f, fdot) for events.

Twin of bin/event_peak.py: reads an event-time file (seconds, or days
if the span is under 100 — the reference's heuristic), grids (f, fd)
around the given center over one Fourier-resolution width, and
reports the H-test and Kuiper peaks with their significances.

Host copy of ``presto_tpu/apps/event_peak.py`` for the PyTorch port,
which imports nothing from the JAX package. The -o plot needs
matplotlib, which the card machine does not have: there a run with -o
raises ImportError naming it before it reads the events.
"""

from __future__ import annotations

import argparse

import numpy as np

from presto_tpu_torch.utils.events import htest, kuiper_uniform_test


def build_parser():
    p = argparse.ArgumentParser(
        prog="event_peak",
        description="(f, fdot) significance peak around a candidate")
    p.add_argument("-n", type=int, default=41,
                   help="grid points per axis (default 41)")
    p.add_argument("-width", type=float, default=2.0,
                   help="search width in Fourier bins 1/T (default 2)")
    p.add_argument("-o", "--output", default="",
                   help="optional contour plot PNG")
    p.add_argument("eventfile")
    p.add_argument("fctr", type=float)
    p.add_argument("fdctr", type=float, nargs="?", default=0.0)
    return p


def calc_phases(ev, f, fd):
    return np.mod(ev * (f + 0.5 * fd * ev), 1.0)


def main(argv=None):
    args = build_parser().parse_args(argv)
    plt = None
    if args.output:
        from presto_tpu_torch.plotting import pyplot
        plt = pyplot("event_peak -o")
    ev = np.sort(np.loadtxt(args.eventfile, usecols=(0,), ndmin=1))
    print("Read %d events from '%s'" % (ev.size, args.eventfile))
    ev = ev - ev.min()
    T = ev.max()
    if T <= 100.0:         # days heuristic (bin/event_peak.py:12-17)
        ev *= 86400.0
        T *= 86400.0
        print("Assuming the events are in DAYS (T = %.3f d)"
              % (T / 86400.0))
    else:
        print("Assuming the events are in seconds (T = %.1f s)" % T)
    df = args.width / T
    dfd = args.width / T ** 2
    fs = args.fctr + np.linspace(-df, df, args.n)
    fds = args.fdctr + np.linspace(-dfd, dfd, args.n)
    H = np.zeros((args.n, args.n))
    K = np.zeros((args.n, args.n))
    for i, fd in enumerate(fds):
        for j, f in enumerate(fs):
            ph = calc_phases(ev, f, fd)
            H[i, j] = htest(ph)[0]
            K[i, j] = kuiper_uniform_test(ph)[0]
    ih, jh = np.unravel_index(np.argmax(H), H.shape)
    ik, jk = np.unravel_index(np.argmax(K), K.shape)
    # H-test false-alarm: P ~ exp(-0.4 H) (de Jager & Busching 2010)
    print("H-test peak : H=%.2f at f=%.10g fd=%.4g  "
          "(log10 P ~ %.2f)"
          % (H[ih, jh], fs[jh], fds[ih],
             -0.4 * H[ih, jh] / np.log(10.0)))
    _, kp = kuiper_uniform_test(calc_phases(ev, fs[jk], fds[ik]))
    print("Kuiper peak : V=%.4f at f=%.10g fd=%.4g  (P=%.3g)"
          % (K[ik, jk], fs[jk], fds[ik], kp))
    if args.output:
        fig, ax = plt.subplots(figsize=(7, 6))
        cs = ax.contourf(fs, fds, H, 20, cmap="magma")
        fig.colorbar(cs, ax=ax, label="H statistic")
        ax.plot(fs[jh], fds[ih], "c+", ms=12)
        ax.set_xlabel("f (Hz)")
        ax.set_ylabel("fdot (Hz/s)")
        fig.savefig(args.output, dpi=100)
        plt.close(fig)
        print("event_peak: wrote", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
