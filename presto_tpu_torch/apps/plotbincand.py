"""plotbincand: display a phase-modulation binary candidate
(src/plotbincand.c rebuilt on matplotlib).

Given a .fft file and a candidate from the search_bin output, renders
the reference's three diagnostic views as one figure:
  1. the power spectrum region around the candidate, divided by the
     local power level (outliers pruned like prune_powers);
  2. the miniFFT of those powers vs binary period;
  3. a ZOOMFACT=10x Fourier-interpolated zoom on the candidate peak.
Usage parity: plotbincand <base> <candnum> [lofreq] [numsumpow]
(argument CLI like the reference, plus optional flags).

Host copy of ``presto_tpu/apps/plotbincand.py`` for the PyTorch port,
which imports nothing from the JAX package. The figure needs matplotlib,
which the card machine does not have: there it raises ImportError.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

ZOOMFACT = 10
ZOOMNEIGHBORS = 20


def _minifft_norm_powers(powers: np.ndarray, numsumpow: int = 1):
    """realfft of a power series, normalized like plotbincand.c:
    norm = sqrt(n * numsumpow) / DC; returns (complex minifft, norm,
    locpow)."""
    n = powers.size
    mf = np.fft.rfft(powers)[:n // 2]
    dc = mf[0].real or 1.0
    locpow = dc / n
    norm = np.sqrt(float(n) * numsumpow) / dc
    mf = mf * norm
    mf[0] = 1.0 + 1.0j
    return mf, norm, locpow


def _interp_zoom(mf: np.ndarray, r0: float):
    """|interpolated miniFFT|^2 at nzoom points around bin r0 (the
    reference's corr_complex r-response interpolation, via the exact
    Fourier-interpolation dot product)."""
    from presto_tpu_torch.search.optimize import power_at_rz
    rs = (r0 - ZOOMNEIGHBORS
          + np.arange(2 * ZOOMFACT * ZOOMNEIGHBORS) / ZOOMFACT)
    rs = np.clip(rs, 0, mf.size - 1)
    pows = np.array([power_at_rz(mf, r, 0.0) for r in rs])
    return rs, pows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="plotbincand")
    p.add_argument("base", help=".fft basename (without suffix)")
    p.add_argument("candnum", type=int)
    p.add_argument("lofreq", type=int, nargs="?", default=0)
    p.add_argument("numsumpow", type=int, nargs="?", default=1)
    p.add_argument("-candfile", type=str, default=None,
                   help="Candidate file (default <base>_bin*.cand)")
    p.add_argument("-o", type=str, default=None,
                   help="Output image (default "
                        "<base>_bin_cand_<n>.png)")
    args = p.parse_args(argv)

    import glob

    from presto_tpu_torch.io import datfft
    from presto_tpu_torch.io.infodata import read_inf
    from presto_tpu_torch.search.phasemod import prune_powers, read_bincands

    base = args.base[:-4] if args.base.endswith(".fft") else args.base
    candfile = args.candfile
    if candfile is None:
        matches = sorted(glob.glob(base + "_bin*.cand"))
        if not matches:
            raise SystemExit("plotbincand: no %s_bin*.cand file"
                             % base)
        candfile = matches[0]
    cands = read_bincands(candfile)
    if not (1 <= args.candnum <= len(cands)):
        raise SystemExit("plotbincand: candnum %d out of range (1-%d)"
                         % (args.candnum, len(cands)))
    c = cands[args.candnum - 1]
    info = read_inf(base)
    T = info.N * info.dt
    amps = datfft.read_fft(base + ".fft")

    nfft = int(c.mini_N)
    lobin = int(c.full_lo_r) - args.lofreq
    lobin = max(0, min(lobin, amps.size - nfft))
    seg = amps[lobin:lobin + nfft]
    powers = (seg.real.astype(np.float64) ** 2
              + seg.imag.astype(np.float64) ** 2)
    powers = prune_powers(powers, args.numsumpow)
    mf, norm, locpow = _minifft_norm_powers(powers, args.numsumpow)
    mfpow = np.abs(mf) ** 2
    # c.mini_r is already in rfft-bin units of this miniFFT
    rs, zoom = _interp_zoom(mf, c.mini_r)

    print("Binary candidate %d of %s:" % (args.candnum, candfile))
    print("  P_psr ~ %.9g s   P_orb ~ %.6g s   sigma = %.2f"
          % (c.psr_p, c.orb_p, c.mini_sigma))
    print("  miniFFT: %d bins from full-FFT bin %g" % (nfft,
                                                       c.full_lo_r))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(3, 1, figsize=(8, 9))
    freqs = (lobin + args.lofreq + np.arange(nfft)) / T
    axes[0].plot(freqs, powers / locpow, "k-", lw=0.5)
    axes[0].set_xlabel("Pulsar Frequency (Hz)")
    axes[0].set_ylabel("Power / Local Power")
    axes[0].set_title("Spectrum region (outliers pruned)")
    # miniFFT bin k <-> orbital period T * k / mini_N (phasemod.py's
    # orb_p = full_T * mini_r / mini_N), period GROWING with bin
    periods = T * np.arange(1, mfpow.size) / float(nfft)
    axes[1].semilogx(periods, mfpow[1:], "k-", lw=0.5)
    axes[1].set_xlabel("Binary Period (s)")
    axes[1].set_ylabel("Normalized Power")
    axes[1].set_title("miniFFT")
    axes[2].plot(T * rs / float(nfft), zoom, "k-")
    axes[2].set_xlabel("Binary Period (s)")
    axes[2].set_ylabel("Normalized Power")
    axes[2].set_title("Candidate peak (%dx interpolation)" % ZOOMFACT)
    fig.suptitle("%s binary candidate %d" % (base, args.candnum))
    fig.tight_layout()
    out = args.o or "%s_bin_cand_%d.png" % (base, args.candnum)
    fig.savefig(out, dpi=100)
    plt.close(fig)
    print("plotbincand: wrote %s" % out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
