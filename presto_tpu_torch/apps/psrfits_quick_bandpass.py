"""psrfits_quick_bandpass: average/stdev bandpass of PSRFITS data.

Host copy of ``presto_tpu/apps/psrfits_quick_bandpass.py`` for the
PyTorch port (twin of bin/psrfits_quick_bandpass.py): reads a sample of
subints, computes the per-channel mean and standard deviation and writes
<base>.bandpass (chan, freq, mean, stdev columns), and with -plot
<base>.bandpass.png, which needs matplotlib (ImportError naming it,
before any file is read, where it is missing).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from presto_tpu_torch.io.psrfits import PsrfitsFile


def build_parser():
    p = argparse.ArgumentParser(
        prog="psrfits_quick_bandpass",
        description="mean/stdev bandpass of PSRFITS search data")
    p.add_argument("-nsub", type=int, default=16,
                   help="number of subints to sample (default 16)")
    p.add_argument("-plot", action="store_true")
    p.add_argument("-o", "--output", default="")
    p.add_argument("fitsfiles", nargs="+")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plot:
        from presto_tpu_torch.plotting import pyplot
        plt = pyplot("psrfits_quick_bandpass -plot")
    with PsrfitsFile(args.fitsfiles) as pf:
        nch = pf.nchan
        nspec = pf.nspectra
        blk = pf.nsblk
        nsub_avail = max(1, nspec // blk)
        picks = np.unique(np.linspace(
            0, nsub_avail - 1, min(args.nsub, nsub_avail)
        ).astype(int))
        s1 = np.zeros(nch)
        s2 = np.zeros(nch)
        n = 0
        for i in picks:
            d = pf.read_spectra(i * blk, blk).astype(np.float64)
            s1 += d.sum(axis=0)
            s2 += (d * d).sum(axis=0)
            n += d.shape[0]
        means = s1 / n
        stdevs = np.sqrt(np.maximum(s2 / n - means ** 2, 0.0))
        freqs = np.asarray(pf.freqs, np.float64)
    base = os.path.splitext(args.fitsfiles[0])[0]
    out = args.output or base + ".bandpass"
    with open(out, "w") as f:
        f.write("# Chan   Freq(MHz)     Mean       StDev\n")
        for i in range(nch):
            f.write("%6d  %9.3f  %9.3f  %9.3f\n"
                    % (i, freqs[i], means[i], stdevs[i]))
    print("psrfits_quick_bandpass: %d subints, %d chans -> %s"
          % (len(picks), nch, out))
    if args.plot:
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(freqs, means, "-k", label="mean")
        ax.plot(freqs, means + stdevs, "-r", lw=0.7, label="+1 sigma")
        ax.plot(freqs, means - stdevs, "-r", lw=0.7)
        ax.set_xlabel("frequency (MHz)")
        ax.set_ylabel("counts")
        ax.legend()
        fig.savefig(out + ".png", dpi=100)
        plt.close(fig)
        print("wrote", out + ".png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
