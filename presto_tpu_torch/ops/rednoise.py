"""Spectral whitening (de-reddening) and birdie zapping.

Host copy of ``presto_tpu/ops/rednoise.py`` for the PyTorch port, which
imports nothing from the JAX package.

Parity targets:
  deredden   accel_utils.c:1301-1374 — divide amplitudes by sqrt of a
             piecewise-linear local median power, block length growing
             logarithmically (initial 6, max 200, buflen=6*ln(binnum)).
  zapbirds   zapping.c / birdzap.c — replace amplitudes in given bin
             ranges with the local median level.

Host-side numpy: sequential adaptive blocks, run once per spectrum.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np


def deredden(amps: np.ndarray, inplace: bool = False) -> np.ndarray:
    """Whiten a packed complex spectrum by log-spaced median blocks.

    amps: complex64/128 array of Fourier amplitudes (bin 0 = DC).
    Returns the normalized spectrum (amps / sqrt(local_median/ln2)),
    with amps[0] set to 1.0 like the reference.
    """
    out = amps if inplace else amps.copy()
    n = out.size
    if n < 8:
        return out
    powers = (out.real.astype(np.float64) ** 2
              + out.imag.astype(np.float64) ** 2)
    out[0] = 1.0 + 0.0j

    initialbuflen, maxbuflen = 6, 200
    binnum, numwrote = 1, 1
    buflen = initialbuflen
    mean_old = np.median(powers[binnum:binnum + buflen]) / np.log(2.0)
    dslope = 1.0

    # first half block: flat normalization (accel_utils.c:1327-1334)
    norm = 1.0 / np.sqrt(max(mean_old, 1e-30))
    end = min(binnum + buflen // 2, n)
    out[numwrote:end] *= norm
    numwrote = end
    binnum += buflen
    lastbuflen = buflen
    buflen = min(int(initialbuflen * np.log(binnum)), maxbuflen)

    while binnum + buflen < n:
        mean_new = np.median(powers[binnum:binnum + buflen]) / np.log(2.0)
        dslope = (mean_new - mean_old) / (0.5 * (lastbuflen + buflen))
        end = binnum + buflen // 2
        ii = np.arange(end - numwrote, dtype=np.float64)
        local = np.maximum(mean_old + dslope * ii, 1e-30)
        out[numwrote:end] *= 1.0 / np.sqrt(local)
        numwrote = end
        binnum += buflen
        lastbuflen = buflen
        mean_old = mean_new
        buflen = min(int(initialbuflen * np.log(binnum)), maxbuflen)

    ii = np.arange(n - numwrote, dtype=np.float64)
    local = np.maximum(mean_old + dslope * ii, 1e-30)
    out[numwrote:] *= 1.0 / np.sqrt(local)
    return out


def read_birds(path: str) -> List[Tuple[float, float]]:
    """Parse a .birds zap file: lines of 'freq width' (Hz), '#' comments.
    Parity: the zapfile format consumed by zapbirds (zapbirds.c /
    lib/parkes_birds.txt).  'B'-prefixed lines (already-barycentric
    birds, get_birdies birdzap.c:52-56) are folded in here with their
    prefix stripped; use read_birds_bary when the flag matters."""
    return [(f, w) for f, w, _ in read_birds_bary(path)]


def read_birds_bary(path: str) -> List[Tuple[float, float, bool]]:
    """Like read_birds but keeps the barycentric flag: returns
    (freq_hz, width_hz, is_bary) per line.  Lines starting with 'B'
    mark frequencies already in the barycentric frame (no topo->bary
    velocity shift should be applied to them — birdzap.c:52-62)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            bary = line.startswith("B")
            if bary:
                line = line[1:]
            parts = line.split()
            freq = float(parts[0])
            width = float(parts[1]) if len(parts) > 1 else 0.0
            out.append((freq, width, bary))
    return out


def zap_bins(amps: np.ndarray, ranges: Iterable[Tuple[float, float]],
             localwidth: int = 20) -> np.ndarray:
    """Replace amplitudes in [lobin, hibin] ranges with the local median
    amplitude level (random phase preserved from the original bins'
    phases like zapping.c's median substitution keeps noise statistics).

    ranges: (lobin, hibin) pairs in Fourier bins (float ok).
    """
    out = amps.copy()
    n = out.size
    for lob, hib in ranges:
        lo = max(1, int(np.floor(lob)))
        hi = min(n - 1, int(np.ceil(hib)))
        if hi < lo:
            continue
        ctx_lo = max(1, lo - localwidth)
        ctx_hi = min(n, hi + 1 + localwidth)
        ctx = np.concatenate([out[ctx_lo:lo], out[hi + 1:ctx_hi]])
        if ctx.size == 0:
            level = 0.0
        else:
            level = np.sqrt(np.median(ctx.real ** 2 + ctx.imag ** 2) / 2.0)
        phases = np.angle(out[lo:hi + 1])
        out[lo:hi + 1] = level * np.exp(1j * phases)
    return out


def birds_to_bin_ranges(birds, T: float, baryv: float = 0.0):
    """(freq, width[, is_bary]) Hz -> sorted (lobin, hibin) Fourier-bin
    ranges, shifting topocentric birdie frequencies by the average
    barycentric velocity as zapbirds does (get_birdies birdzap.c:52-68:
    topo lines get f *= 1+baryv to match a barycentered FFT; 'B' lines
    are already barycentric and pass through unshifted)."""
    out = []
    for bird in birds:
        freq, width = bird[0], bird[1]
        is_bary = bird[2] if len(bird) > 2 else False
        f = freq if is_bary else freq * (1.0 + baryv)
        half = max(width / 2.0, 0.0)
        out.append(((f - half) * T, (f + half) * T))
    return sorted(out)
