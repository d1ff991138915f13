"""zapbirds + makezaplist: excise periodic interference from .fft files.

Host copy of ``presto_tpu/apps/zapbirds.py`` for the PyTorch port,
which imports nothing from the JAX package.  Zapping stays on the host:
zap_bins' median, phase and the order of its ranges fix the bytes.

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
  makezaplist.py (bin/makezaplist.py): .birds -> .zaplist expansion of
    harmonic trains ('freq width numharm [grow [bary]]') and catalog
    pulsars ('P name numharm', widened by utils/catalog.binary_velocity
    for binaries).

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
from presto_tpu_torch.utils.catalog import (binary_velocity,
                                            default_birds_path, psrepoch)


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


# ----------------------------------------------------------------- #
# makezaplist: .birds -> .zaplist (bin/makezaplist.py)

def makezaplist(birdsfile: str, min_psr_harm_bins: float = 40.0) -> str:
    """Expand a .birds file into a sorted .zaplist.

    Line formats (makezaplist.py:37-85):
      'freq width'                     one birdie
      'freq width numharm [grow [bary]]'  harmonic train; grow!=0
                                       scales the width with harmonic
      'P psrname numharm'              catalog pulsar: zap numharm
                                       harmonics with a minimum width
                                       of 40/T Hz (Doppler-broadened by
                                       the orbit when the pulsar is in
                                       a binary)
    Requires <root>.inf beside the .birds file for T.
    """
    if not birdsfile.endswith(".birds"):
        raise SystemExit("the birdie file must end in '.birds'")
    root = birdsfile[:-len(".birds")]
    info = read_inf(root)
    T = info.dt * info.N
    min_psr_width = min_psr_harm_bins / T
    birds = []   # (freq, width, bary)
    npsr = nfreq = ntrain = 0
    with open(birdsfile) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line[0] == "P":
                _, psrname, numharm = line.split()
                birds.extend(_psr_birds(psrname, int(numharm),
                                        info.mjd_i + info.mjd_f, T,
                                        min_psr_width))
                npsr += 1
                continue
            words = line.split()
            if len(words) >= 3:
                freq, width = float(words[0]), float(words[1])
                numharm = int(words[2])
                grow = int(words[3]) if len(words) >= 4 else 0
                bary = int(words[4]) if len(words) >= 5 else 0
                ntrain += 1
                for harm in range(1, numharm + 1):
                    w = width * harm if grow else width
                    birds.append((freq * harm, w, bary))
            else:
                nfreq += 1
                width = float(words[1]) if len(words) > 1 else 0.0
                birds.append((float(words[0]), width, 0))
    print("Read %d freqs, %d pulsars, and %d harmonic series."
          % (nfreq, npsr, ntrain))
    birds.sort()
    out = root + ".zaplist"
    with open(out, "w") as f:
        f.write("# This file created automatically with makezaplist\n")
        f.write("# Lines beginning with '#' are comments\n")
        f.write("# Lines beginning with 'B' are barycentric freqs "
                "(i.e. PSR freqs)\n")
        f.write("# %20s  %20s\n" % ("Freq", "Width"))
        f.write("# %s  %s\n" % ("-" * 20, "-" * 20))
        for freq, width, bary in birds:
            pre = "B" if bary else " "
            f.write("%s %20.15g  %20.15g\n" % (pre, freq, width))
    print("Wrote '%s'" % out)
    return out


def _psr_birds(psrname: str, numharm: int, epoch: float, T: float,
               min_psr_width: float):
    """Barycentric zap entries for a catalog pulsar's harmonics,
    widened by the orbital Doppler range when binary
    (makezaplist.py:44-62)."""
    psr = psrepoch(psrname, epoch)
    out = []
    if psr.orb is not None and psr.orb.p:
        minv, maxv = binary_velocity(T, psr.orb)
        midv = 0.5 * (maxv + minv)
        for harm in range(1, numharm + 1):
            midf = (1.0 + midv) * psr.f * harm
            width = (maxv - minv) * psr.f * harm
            if 0.1 * width < min_psr_width:
                width = width + min_psr_width
            else:
                width = width * 1.1
            out.append((midf, width, 1))
    else:
        for harm in range(1, numharm + 1):
            out.append((psr.f * harm, min_psr_width, 1))
    return out


def makezaplist_main(argv=None):
    p = argparse.ArgumentParser(
        prog="makezaplist",
        description="Turn a .birds file into a .zaplist")
    p.add_argument("birdsfile", help="file ending in .birds; a matching"
                   " .inf must exist")
    args = p.parse_args(argv)
    makezaplist(args.birdsfile)


if __name__ == "__main__":
    main()
