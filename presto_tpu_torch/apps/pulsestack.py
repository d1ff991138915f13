"""pulsestack: plot single pulses / subintegrations from a .dat file.

Working-subset twin of the reference's bin/pulsestack.py (whose full
option surface targets PGPLOT + legacy event formats): folds a
time series at a constant period and renders either a stacked-line
plot or a 2-D image of pulse (or subintegration) profiles, plus an
integrated profile panel.  Events files (one arrival time per line,
seconds) are folded the same way.

Host copy of ``presto_tpu/apps/pulsestack.py`` for the PyTorch port,
which imports nothing from the JAX package: the stack is NumPy, and the
figure needs matplotlib (ImportError naming it where it is missing).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from presto_tpu_torch.io.datfft import read_dat
from presto_tpu_torch.io.infodata import read_inf


def build_parser():
    p = argparse.ArgumentParser(
        prog="pulsestack",
        description="Stack of single pulses / subints from a .dat")
    p.add_argument("-p", "--period", type=float, required=True,
                   help="fold period (s)")
    p.add_argument("-n", "--nbins", type=int, default=128,
                   help="profile bins (default 128)")
    p.add_argument("--nsub", type=int, default=0,
                   help="stack subintegrations of this many pulses "
                        "instead of single pulses (0 = single pulses)")
    p.add_argument("--start", type=float, default=0.0,
                   help="start time (s) into the file")
    p.add_argument("--end", type=float, default=0.0,
                   help="end time (s; 0 = end of file)")
    p.add_argument("--lines", action="store_true",
                   help="stacked-line plot instead of an image")
    p.add_argument("--events", action="store_true",
                   help="input is an events text file (s)")
    p.add_argument("-o", "--output", default="",
                   help="output image (default <infile>.stack.png)")
    p.add_argument("infile")
    return p


def stack_series(series, dt, period, nbins, nsub=0, t0=0.0):
    """[npulse (or nsubint), nbins] mean-binned pulse stack + counts."""
    n = series.size
    t = t0 + dt * np.arange(n)
    pulse = np.floor(t / period).astype(np.int64)
    pulse -= pulse[0]
    ph = np.mod(t / period, 1.0)
    b = np.minimum((ph * nbins).astype(np.int64), nbins - 1)
    if nsub > 1:
        pulse //= nsub
    rows = int(pulse[-1]) + 1
    acc = np.zeros((rows, nbins))
    cnt = np.zeros((rows, nbins))
    np.add.at(acc, (pulse, b), series)
    np.add.at(cnt, (pulse, b), 1.0)
    with np.errstate(invalid="ignore"):
        prof = acc / np.maximum(cnt, 1.0)
    return prof, cnt


def main(argv=None):
    args = build_parser().parse_args(argv)
    base, ext = os.path.splitext(args.infile)
    if args.events or ext in (".txt", ".events"):
        ev = np.loadtxt(args.infile, usecols=(0,), ndmin=1)
        ev = np.sort(ev) - ev.min()
        dt = args.period / args.nbins
        n = int(np.ceil(ev.max() / dt)) + 1
        series = np.bincount(np.minimum(
            (ev / dt).astype(np.int64), n - 1),
            minlength=n).astype(np.float64)
    else:
        series = read_dat(args.infile).astype(np.float64)
        try:
            dt = read_inf(base).dt
        except Exception:
            raise SystemExit("pulsestack: no .inf for %s (dt unknown)"
                             % args.infile)
    i0 = int(args.start / dt)
    i1 = int(args.end / dt) if args.end else series.size
    series = series[i0:i1]
    prof, cnt = stack_series(series, dt, args.period, args.nbins,
                             args.nsub, t0=i0 * dt)
    from presto_tpu_torch.plotting import pyplot
    plt = pyplot("pulsestack")
    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(7, 9), sharex=True,
        gridspec_kw={"height_ratios": [1, 4]})
    integ = np.nansum(prof * cnt, axis=0) / np.maximum(
        cnt.sum(axis=0), 1.0)
    phase = (np.arange(args.nbins) + 0.5) / args.nbins
    ax0.plot(phase, integ, "k-", drawstyle="steps-mid")
    ax0.set_ylabel("integrated")
    label = ("subint (%d pulses)" % args.nsub) if args.nsub > 1 \
        else "pulse number"
    if args.lines:
        p = prof - np.nanmin(prof)
        step = np.nanmax(p) or 1.0
        for i in range(prof.shape[0]):
            ax1.plot(phase, p[i] + i * step, "k-", lw=0.6)
        ax1.set_ylim(0, (prof.shape[0] + 1) * step)
    else:
        ax1.imshow(prof, aspect="auto", origin="lower",
                   extent=[0, 1, 0, prof.shape[0]], cmap="viridis",
                   interpolation="nearest")
    ax1.set_xlabel("pulse phase")
    ax1.set_ylabel(label)
    ax0.set_title("%s  p=%.9gs  %d %s x %d bins"
                  % (os.path.basename(args.infile), args.period,
                     prof.shape[0],
                     "subints" if args.nsub > 1 else "pulses",
                     args.nbins))
    out = args.output or base + ".stack.png"
    fig.savefig(out, dpi=100)
    plt.close(fig)
    print("pulsestack: %d rows -> %s" % (prof.shape[0], out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
