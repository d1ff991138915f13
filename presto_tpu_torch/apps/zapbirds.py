"""zapbirds: excise periodic interference from .fft files.

Host copy of the zapbirds half of ``presto_tpu/apps/zapbirds.py`` for
the PyTorch port, which imports nothing from the JAX package.  Zapping
stays on the host: zap_bins' median, phase and the order of its ranges
fix the bytes.  ``makezaplist`` is not in the port yet (it needs the
pulsar catalog's epochs and binary velocities).

Parity targets:
  zapbirds (src/zapbirds.c:205-):
    -zap -zapfile F [-baryv v] file.fft   rewrite the FFT with every
        (freq,width) range in F replaced by local-median-level noise
        (zapping.c semantics, ops.rednoise.zap_bins).
    -in F -out G [-baryv v] file.fft      examine each 'freq numharm'
        line of F around its predicted bins and emit measured
        (freq,width) pairs to G.  The reference does this with an
        interactive PGPLOT loop (process_bird, zapbirds.c:70-200); here
        the boundaries are found automatically by expanding around the
        peak while the locally-normalized power stays above threshold.

Frame conventions (birdzap.c:52-68, zapbirds.c:31-41): zapfile lines
are topocentric unless 'B'-prefixed; a barycentered FFT needs topo
freqs scaled by (1+baryv); measured bary freqs are divided by (1+baryv)
before being written back out as topocentric.
"""

from __future__ import annotations

import argparse

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.ops.rednoise import (birds_to_bin_ranges,
                                           read_birds_bary, zap_bins)
from presto_tpu_torch.utils.catalog import default_birds_path


def build_parser():
    p = argparse.ArgumentParser(
        prog="zapbirds",
        description="Automatically zap interference from an FFT.")
    p.add_argument("-zap", action="store_true",
                   help="Zap the birds in the FFT from 'zapfile'")
    p.add_argument("-zapfile", type=str, default=None,
                   help="File of freqs/widths (Hz) to zap (with -zap)")
    p.add_argument("-defaultbirds", action="store_true",
                   help="With -zap and no -zapfile: use the shipped "
                        "default birdie list (power-mains harmonics, "
                        "the lib/parkes_birds.txt analog)")
    p.add_argument("-in", dest="inzapfile", type=str, default=None,
                   help="File of freqs (Hz) and # harmonics to measure")
    p.add_argument("-out", dest="outzapfile", type=str, default=None,
                   help="Output file of measured freqs and widths (Hz)")
    p.add_argument("-baryv", type=float, default=0.0,
                   help="Radial velocity (v/c) towards target during obs")
    p.add_argument("infile", help=".fft file (a matching .inf must exist)")
    return p


def _measure_bird(amps: np.ndarray, predbin: float, T: float,
                  window: int = 200, thresh: float = 5.0,
                  min_width_bins: float = 4.0):
    """Measure the (lofreq, hifreq) extent (Hz, FFT frame) of a birdie
    near Fourier bin `predbin`, or None if nothing significant.

    Replaces the interactive boundary-marking of process_bird
    (zapbirds.c:70-200): normalize powers by the local median level
    (average = median/ln2, calc_median_powers usage zapbirds.c:96-99),
    take the peak in the window, then expand while power > thresh.
    """
    n = amps.size
    lo = max(1, int(predbin) - window // 2)
    hi = min(n, int(predbin) + window // 2)
    if hi - lo < 8:
        return None
    seg = amps[lo:hi]
    powers = seg.real.astype(np.float64) ** 2 + seg.imag ** 2
    med = np.median(powers)
    if med <= 0:
        return None
    norm = powers / (med / np.log(2.0))
    peak = int(np.argmax(norm))
    # detection needs to clear the expected max of `window` exponential
    # noise powers (ln window) by a wide margin; `thresh` only governs
    # how far the boundaries expand once a real bird is found
    detect = max(thresh, np.log(norm.size) + 7.0)
    if norm[peak] < detect:
        return None
    left = peak
    while left > 0 and norm[left - 1] > thresh:
        left -= 1
    right = peak
    while right < norm.size - 1 and norm[right + 1] > thresh:
        right += 1
    # pad half a bin each side; enforce a minimum zap width
    lobin, hibin = lo + left - 0.5, lo + right + 0.5
    if hibin - lobin < min_width_bins:
        mid = 0.5 * (lobin + hibin)
        lobin, hibin = mid - min_width_bins / 2, mid + min_width_bins / 2
    return lobin / T, hibin / T


def zap_amps(amps: np.ndarray, zapfile: str, T: float, N: int,
             baryv: float = 0.0):
    """In-memory -zap: the zapfile's ranges replaced by local-median
    noise in a COPY of ``amps``.  Returns (zapped, nranges).  Shared
    by the file path below and the survey's seam search
    (pipeline/survey.seam_fft_search), which zaps the device-FFT'd
    spectrum without a .fft round-trip; zap_bins is deterministic, so
    both produce identical bytes from identical spectra."""
    hibin = N / 2
    birds = read_birds_bary(zapfile)
    ranges = birds_to_bin_ranges(birds, T, baryv)
    kept = []
    for lob, hib in ranges:
        if lob >= hibin - 1:     # zapbirds.c:295-299 clamp + early stop
            break
        kept.append((lob, min(hib, hibin - 1)))
    return zap_bins(amps, kept), len(kept)


def zap_pairs_batch(pairs_host: np.ndarray, zapfile: str, T: float,
                    N: int, baryv: float = 0.0) -> np.ndarray:
    """In-memory -zap over a BATCH of packed-pair spectra
    ([ntrials, numbins, 2] float32, the seam's download layout):
    every row zapped with the same deterministic zap_amps, rows
    rewritten in place.  Shared by the survey's fused search
    (pipeline/survey.seam_fft_search) for both the single-device and
    the DM-sharded seam paths — all trials of a fan-out share T and N,
    so one parsed zapfile covers the batch; zapped bytes are identical
    to per-file `zapbirds -zap` on the same spectra."""
    for i in range(pairs_host.shape[0]):
        amps = fftpack.np_pairs_to_complex64(pairs_host[i])
        amps, _nz = zap_amps(amps, zapfile, T, N, baryv)
        pairs_host[i] = np.stack([amps.real, amps.imag], -1)
    return pairs_host


def zap_fft_file(fftpath: str, zapfile: str, baryv: float = 0.0) -> int:
    """-zap path: rewrite fftpath with the zapfile's ranges replaced by
    local-median noise.  Returns the number of ranges zapped."""
    base = fftpath[:-4] if fftpath.endswith(".fft") else fftpath
    info = read_inf(base)
    T = info.dt * info.N
    amps = datfft.read_fft(fftpath)
    out, nz = zap_amps(amps, zapfile, T, info.N, baryv)
    datfft.write_fft(fftpath, out)
    return nz


def measure_birds(fftpath: str, inzapfile: str, outzapfile: str,
                  baryv: float = 0.0) -> int:
    """-in/-out path: measure widths of listed freqs' harmonics and
    write a 'freq width' zapfile (topocentric, like birdie_create's
    /(1+baryv) conversion zapbirds.c:31-41)."""
    base = fftpath[:-4] if fftpath.endswith(".fft") else fftpath
    info = read_inf(base)
    T = info.dt * info.N
    amps = datfft.read_fft(fftpath)
    n = amps.size

    entries = []
    with open(inzapfile) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            freq = float(parts[0])
            numharm = int(parts[1]) if len(parts) > 1 else 1
            entries.append((freq, numharm))

    found = []
    for freq, numharm in entries:
        barybase = freq * (1.0 + baryv)   # topo list, bary FFT frame
        for harm in range(1, numharm + 1):
            predbin = barybase * T * harm
            if predbin >= n - 1:
                break
            m = _measure_bird(amps, predbin, T)
            if m is None:
                continue
            lof, hif = (f / (1.0 + baryv) for f in m)
            found.append((0.5 * (lof + hif), hif - lof))
    found.sort()
    with open(outzapfile, "w") as f:
        f.write("# Measured birdies from %s\n" % fftpath)
        f.write("# %17s  %17s\n" % ("Freq(Hz)", "Width(Hz)"))
        for freq, width in found:
            f.write("%17.14g  %17.14g\n" % (freq, width))
    return len(found)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.zap and not (args.inzapfile and args.outzapfile):
        raise SystemExit("zapbirds: need -zap -zapfile F, or -in F -out G")
    if args.zap:
        if not args.zapfile and args.defaultbirds:
            args.zapfile = default_birds_path()
        if not args.zapfile:
            raise SystemExit("zapbirds: -zap requires -zapfile "
                             "(or -defaultbirds)")
        nz = zap_fft_file(args.infile, args.zapfile, args.baryv)
        print("zapbirds: zapped %d ranges in %s" % (nz, args.infile))
    else:
        nf = measure_birds(args.infile, args.inzapfile, args.outzapfile,
                           args.baryv)
        print("zapbirds: wrote %d measured birdies to %s"
              % (nf, args.outzapfile))


if __name__ == "__main__":
    main()
