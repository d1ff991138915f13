"""filter_zerolags: high-pass a zero-lag (DC power) time series.

Twin of bin/filter_zerolags.py: reads a float32 stream of per-sample
zero-lag powers, fits/removes the slow baseline with a Chebyshev-II
low-pass (the reference's scipy.signal iirdesign + filtfilt recipe:
2 Hz corner, 0.8/1.2 pass/stop fractions, 3/30 dB), and writes the
baseline-subtracted (or the baseline) stream as <base>.subzerolags —
the detrended zero-lags feed clipping/RFI excision.

Host copy of ``presto_tpu/apps/filter_zerolags.py`` for the PyTorch
port, which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="filter_zerolags",
        description="detrend a .zerolags float32 stream")
    p.add_argument("-dt", type=float, default=0.00008192,
                   help="sample time (s; reference default 81.92 us)")
    p.add_argument("-flo", type=float, default=2.0,
                   help="low-pass corner frequency (Hz)")
    p.add_argument("-baseline", action="store_true",
                   help="write the baseline itself, not data-baseline")
    p.add_argument("-o", "--output", default="")
    p.add_argument("infile")
    return p


def lowpass_baseline(zls, dt, flo=2.0, passband=0.8, stopband=1.2,
                     max_pass_atten=3.0, min_stop_atten=30.0):
    from scipy import signal
    nyq = 0.5 / dt
    wp = flo * passband / nyq
    ws = flo * stopband / nyq
    b, a = signal.iirdesign(wp, ws, max_pass_atten, min_stop_atten,
                            ftype="cheby2")
    return signal.filtfilt(b, a, zls.astype(np.float64))


def main(argv=None):
    args = build_parser().parse_args(argv)
    zls = np.fromfile(args.infile, "<f4")
    if zls.size < 32:
        raise SystemExit("filter_zerolags: only %d samples" % zls.size)
    base = lowpass_baseline(zls, args.dt, args.flo)
    out = (base if args.baseline else zls - base).astype(np.float32)
    stem = args.infile
    for suf in (".zerolags", ".dat"):
        if stem.endswith(suf):
            stem = stem[:-len(suf)]
            break
    path = args.output or stem + ".subzerolags"
    out.tofile(path)
    print("filter_zerolags: %d samples, baseline rms %.4g -> %s"
          % (zls.size, float(np.std(base)), path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
