"""Phase-modulation (miniFFT) binary pulsar search on one device.

PyTorch counterpart of ``presto_tpu/search/phasemod.py``.  Reference
algorithm (src/minifft.c:204-367 search_minifft + src/search_bin.c:187-340
driver): a binary pulsar's orbital motion phase-modulates its spin
frequency, spraying sidebands around the spin bin of the long FFT.
FFT-ing short windows ("miniFFTs") of the POWER SPECTRUM turns that
periodic sideband comb back into a sharp peak at the orbital period.
Windows of every power-of-2 size in [minfft, maxfft] (stride =
overlap*fftlen) slide over the big FFT's powers; each is miniFFT-ed,
interbinned or Fourier-interpolated, harmonic-summed (with the aliased
wrap-around past the miniFFT Nyquist) and its top MININCANDS candidates
go into a global list.

On the device, for one window size, all windows of a chunk are one
batched program (``_minifft_topk``): the rfft (zero-padded x2 for
interpolation), the normalization by each window's own DC bin, the
interbin and alias constructions, the cumulative harmonic stages as
gathers and a top-k per (window, stage) with ties to the lowest index,
as ``jax.lax.top_k`` orders them.  Each pruned chunk is uploaded once and
its windows are views of it (``Tensor.unfold``).  Before anything crosses
to the host the device drops the values that cannot reach MINRETURNSIG
(each stage's ``power_for_sigma`` cut, lowered by POWCUT_MARGIN); the
survivors get ``candidate_sigma`` and the JAX package's per-window
selection, vectorized.  ``prune_powers`` (a NumPy median of an even
count averages the two middle values), the chunk walk and the merge stay
on the host.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.ops.stats import candidate_sigma, power_for_sigma
from presto_tpu_torch.search.accel import _topk_desc, resolve_device

MININCANDS = 6          # per-miniFFT candidates kept (search_bin.c:5)
MINORBP = 300.0         # min orbital period, s (search_bin.c:8)
MINRETURNSIG = 1.5      # minifft.c:8
PRUNELEV = 25           # select.c:3
NEWLEV = 5              # select.c:4
# the device cut keeps every value at or above power_for_sigma(
# MINRETURNSIG, h, numindep) lowered by this share: candidate_sigma
# reaches MINRETURNSIG no lower than 4e-16 of that power below it (up to
# 2.1e-5 above it in its asymptotic branch), and the float32 cut rounds
# by at most 6e-8
POWCUT_MARGIN = 1e-6


@dataclass
class RawBinCand:
    """Python analog of struct RAWBINCAND (presto.h:221-232)."""
    full_N: float = 0.0
    full_T: float = 0.0
    full_lo_r: float = 0.0
    mini_N: float = 0.0
    mini_r: float = 0.0
    mini_power: float = 0.0
    mini_numsum: float = 0.0
    mini_sigma: float = 0.0
    psr_p: float = 0.0
    orb_p: float = 0.0

    def to_bytes(self) -> bytes:
        return struct.pack("<10d", self.full_N, self.full_T,
                           self.full_lo_r, self.mini_N, self.mini_r,
                           self.mini_power, self.mini_numsum,
                           self.mini_sigma, self.psr_p, self.orb_p)

    @classmethod
    def from_bytes(cls, b: bytes) -> "RawBinCand":
        vals = struct.unpack("<10d", b)
        return cls(*vals)


def write_bincands(path: str, cands: Sequence[RawBinCand]) -> None:
    """Binary .cand artifact: packed little-endian rawbincand records
    (search_bin.c:373-380 chkfwrite of the struct array)."""
    with open(path, "wb") as f:
        for c in cands:
            f.write(c.to_bytes())


def read_bincands(path: str) -> List[RawBinCand]:
    raw = open(path, "rb").read()
    return [RawBinCand.from_bytes(raw[i:i + 80])
            for i in range(0, len(raw) - 79, 80)]


def prune_powers(powers: np.ndarray, numsumpow: int = 1) -> np.ndarray:
    """Chop powers far above the median (strong coherent signals/RFI)
    to NEWLEV*median.  Parity: prune_powers (select.c:10-40)."""
    med = float(np.median(powers))
    cutoff = med * PRUNELEV / np.sqrt(numsumpow)
    return np.where(powers > cutoff, NEWLEV * med, powers)


# ----------------------------------------------------------------------
# Device program: batched miniFFT -> spread -> harmonic stages -> top-k
# ----------------------------------------------------------------------

def _minifft_topk(windows: torch.Tensor, numsumpow: float, fftlen: int,
                  interbin: bool, checkaliased: bool, numharm: int,
                  lobin: int, hibin: int, k: int, numbetween: int = 2):
    """windows: [B, fftlen] float32 (pruned big-FFT powers).

    Returns (vals[B, numharm, k], idx[B, numharm, k]) on the windows'
    device: per harmonic stage, the k strongest summed powers and their
    spread-bin indices (stage s sums s+1 harmonics), ties to the lowest
    index.  Bin index jj at stage h means mini_r = (jj/numbetween)/h
    (numbetween=1: raw bins only, no interpolation — the reference's
    -numbetween 1).
    """
    B = windows.shape[0]
    if numbetween == 1:
        sp = torch.fft.rfft(windows, dim=-1)
        spread = sp[:, :fftlen // 2]
    elif interbin:
        # even spread bins are the rfft amplitudes, odd ones the interbin
        # differences scaled by pi/4, the exact interbinning constant for
        # a tone midway (the reference's 2/pi recovers 0.66 of its power;
        # the JAX package deviates for sensitivity, and so does the port)
        sp = torch.fft.rfft(windows, dim=-1)           # [B, fftlen/2+1]
        even = sp[:, :-1]
        odd = (math.pi / 4.0) * (sp[:, :-1] - sp[:, 1:])
        spread = torch.stack([even, odd], dim=-1).reshape(B, fftlen)
    else:
        # Fourier interpolation: zero-pad to 2*fftlen then rfft
        # (minifft.c:62-68 doc) -> first fftlen bins searched
        sp = torch.fft.rfft(windows, n=2 * fftlen, dim=-1)
        spread = sp[:, :fftlen]
    dc = spread[:, :1].real
    scale = float(np.sqrt(np.float32(fftlen) * np.float32(numsumpow)))
    amp = spread * (scale / dc)
    pows = amp.abs() ** 2
    pows[:, 0] = 1.0                                   # minifft.c:226
    if checkaliased:
        # wrap powers past the miniFFT Nyquist so harmonic sums can
        # reach aliased orbital harmonics (minifft.c:298-303)
        pows = torch.cat([pows, pows.new_ones((B, 1)),
                          pows[:, 1:].flip(-1)], dim=1)  # [B, 2*len]
    M = pows.shape[1]
    jjs = torch.arange(M, device=pows.device)
    ninf = torch.tensor(-math.inf, dtype=pows.dtype, device=pows.device)
    sums = pows
    out_vals, out_idx = [], []
    for h in range(1, numharm + 1):
        if h > 1:
            sums = sums + pows[:, (jjs + h // 2) // h]
        valid = (jjs >= lobin * h) & (jjs < hibin)
        v, i = _topk_desc(torch.where(valid[None, :], sums, ninf), k)
        out_vals.append(v)
        out_idx.append(i)
    return torch.stack(out_vals, dim=1), torch.stack(out_idx, dim=1)


def _stage_cuts(numharm: int, lobin: int, hibin: int):
    """Each stage's numindep (the JAX loop's, interpolated bins counted)
    and the float32 power below which candidate_sigma stays under
    MINRETURNSIG -> (numindep[numharm], cuts[numharm])."""
    hs = np.arange(1, numharm + 1, dtype=np.float64)
    numindep = np.maximum((hibin - lobin + 1.0) / hs, 1.0)
    cuts = power_for_sigma(MINRETURNSIG, hs, numindep) * (1.0 - POWCUT_MARGIN)
    return numindep, cuts.astype(np.float32)


def _select(b, s, v, jj, numindep, T, full_N, lo_rs, numminifft, dr
            ) -> List[RawBinCand]:
    """The JAX package's per-window candidate loop over the device's
    survivors (window b, stage s, value v, spread bin jj, in (b, s, rank)
    order): the finite values whose candidate_sigma reaches MINRETURNSIG,
    each window's sorted by -sigma (stable) and cut to MININCANDS,
    windows in order."""
    fin = np.isfinite(v)
    b, s, v, jj = b[fin], s[fin], v[fin].astype(np.float64), jj[fin]
    if not v.size:
        return []
    h = (s + 1).astype(np.float64)
    sig = np.asarray(candidate_sigma(v, h, numindep[s]), np.float64)
    keep = sig >= MINRETURNSIG
    b, h, v, jj, sig = b[keep], h[keep], v[keep], jj[keep], sig[keep]
    order = np.lexsort((np.arange(b.size), -sig, b))
    b, h, v, jj, sig = b[order], h[order], v[order], jj[order], sig[order]
    rank = np.arange(b.size) - np.searchsorted(b, b, side="left")
    keep = rank < MININCANDS
    b, h, v, jj, sig = b[keep], h[keep], v[keep], jj[keep], sig[keep]
    mini_N = 2.0 * numminifft
    lo = np.asarray(lo_rs, np.float64)[b]
    mini_r = dr * jj.astype(np.float64) / h
    psr_p = T / (lo + numminifft)
    orb_p = T * mini_r / mini_N
    return [RawBinCand(full_N=full_N, full_T=T, full_lo_r=a, mini_N=mini_N,
                       mini_r=r, mini_power=pw, mini_numsum=n,
                       mini_sigma=sg, psr_p=pp, orb_p=op)
            for a, r, pw, n, sg, pp, op in zip(
                lo.tolist(), mini_r.tolist(), v.tolist(), h.tolist(),
                sig.tolist(), psr_p.tolist(), orb_p.tolist())]


def search_minifft_batch(windows, T: float, full_N: float,
                         lo_rs: np.ndarray,
                         min_orb_p: float = MINORBP,
                         max_orb_p: Optional[float] = None,
                         numharm: int = 3, interbin: bool = False,
                         numbetween: int = 2,
                         checkaliased: bool = True,
                         numsumpow: int = 1,
                         device="cuda") -> List[RawBinCand]:
    """Search a batch of same-length power windows on ``device``.

    windows: [B, fftlen] (NumPy or a tensor); lo_rs[B] = big-FFT bin of
    each window start.  Returns up to MININCANDS candidates per window
    with sigma >= MINRETURNSIG, unsorted (caller merges): the JAX
    package's list.  Parity: search_minifft (minifft.c:204-367).
    """
    dev = resolve_device(device)
    B, fftlen = windows.shape
    numminifft = fftlen // 2
    if numbetween not in (1, 2):
        raise ValueError("numbetween must be 1 or 2")
    if interbin:
        # interbinning implies 2 points/bin; the reference overrides
        # numbetween rather than honoring -numbetween 1
        # (minifft.c:67-70)
        numbetween = 2
    if max_orb_p is None:
        max_orb_p = T / 2.0 if not checkaliased else T / 1.2
    lobin = max(int(np.ceil(2 * numminifft * min_orb_p / T)), 1)
    hibin = min(int(np.floor(2 * numminifft * max_orb_p / T)),
                2 * numminifft - 1)
    lobin *= numbetween
    hibin *= numbetween
    if hibin <= lobin:
        return []
    wins = torch.as_tensor(windows, dtype=torch.float32, device=dev)
    vals, idx = _minifft_topk(wins, numsumpow, fftlen, interbin,
                              checkaliased, numharm, lobin, hibin,
                              MININCANDS, numbetween=numbetween)
    numindep, cuts = _stage_cuts(numharm, lobin, hibin)
    keep = vals >= torch.from_numpy(cuts).to(dev)[None, :, None]
    b, s, _j = keep.nonzero(as_tuple=True)
    b, s, v, jj = (x.cpu().numpy() for x in (b, s, vals[keep], idx[keep]))
    return _select(b, s, v, jj, numindep, T, full_N, lo_rs, numminifft,
                   1.0 / numbetween)


def not_already_there_rawbin(newcand: RawBinCand,
                             cands: List[RawBinCand]) -> bool:
    """True unless a stronger candidate with the same miniFFT length
    and nearly the same mini_r is already listed (minifft.c:425-447)."""
    for c in cands:
        if c.mini_sigma == 0.0:
            break
        if (c.mini_N == newcand.mini_N
                and abs(c.mini_r - newcand.mini_r) < 0.6
                and c.mini_sigma > newcand.mini_sigma):
            return False
    return True


def merge_rawbin_cands(master: List[RawBinCand],
                       new: Sequence[RawBinCand],
                       maxcands: int) -> List[RawBinCand]:
    """Insert new candidates into the sigma-sorted master list with the
    reference's dedup rule, truncating to maxcands.

    The JAX package admits every new candidate the rule lets in, then
    sorts and truncates.  Only a stronger candidate can reject one, so
    the walk in descending sigma stops once maxcands entries (old ones
    of at least its sigma, admitted new ones) would sort ahead of the
    next: the list is the same, and a window batch of many thousand
    candidates costs maxcands admissions, not a quadratic scan."""
    old = np.array([c.mini_sigma for c in master], np.float64)
    admitted = 0
    for c in sorted(new, key=lambda c: -c.mini_sigma):
        if admitted + int((old >= c.mini_sigma).sum()) >= maxcands:
            break
        if not_already_there_rawbin(c, master):
            master.append(c)
            admitted += 1
    master.sort(key=lambda c: -c.mini_sigma)
    del master[maxcands:]
    return master


# ----------------------------------------------------------------------
# The search_bin driver over a full spectrum
# ----------------------------------------------------------------------

@dataclass
class PhaseModConfig:
    """search_bin knobs (clig/search_bin_cmd.cli defaults)."""
    ncand: int = 100
    minfft: int = 32
    maxfft: int = 65536
    rlo: float = 1.0
    rhi: Optional[float] = None
    lobin: int = 0
    overlap: float = 0.25
    harmsum: int = 3
    interbin: bool = False
    noalias: bool = False
    numbetween: int = 2     # 1: raw bins only; 2: + interpolated bins
    stack: int = 0          # >0: input is stacked power spectra


def search_phasemod(fft_or_powers, N: float, dt: float,
                    cfg: Optional[PhaseModConfig] = None,
                    device="cuda") -> List[RawBinCand]:
    """Full phase-modulation search of a spectrum on ``device``.

    fft_or_powers: complex64 spectrum or [n, 2] float32 pairs
    (cfg.stack==0), or pre-summed float powers (cfg.stack>0), on the
    host.  N, dt describe the ORIGINAL time series.  Mirrors
    search_bin.c:187-340: chunked scan, prune_powers, per-size
    overlapping windows, global candidate merge.
    """
    dev = resolve_device(device)
    cfg = cfg or PhaseModConfig()
    T = N * dt
    nbins = len(fft_or_powers)
    if cfg.stack == 0:
        arr = np.asarray(fft_or_powers)
        if arr.ndim == 2 and arr.shape[-1] == 2:
            # [n,2] re/im pairs (the packed-.fft loader convention)
            powers_all = (arr.astype(np.float32) ** 2).sum(axis=-1)
        else:
            powers_all = (np.abs(arr) ** 2).astype(np.float32)
        numsumpow = 1
    else:
        arr = np.asarray(fft_or_powers, np.float32)
        if arr.ndim != 1:
            raise ValueError(
                "stack>0 input must be a 1-D float power array "
                "(pre-summed spectra), got shape %r" % (arr.shape,))
        powers_all = arr
        numsumpow = cfg.stack
    rlo = max(int(cfg.rlo), cfg.lobin)
    rhi = int(cfg.rhi) if cfg.rhi else cfg.lobin + nbins - 1
    rhi = min(rhi, cfg.lobin + nbins - 1)
    min_orb_p = MINORBP
    max_orb_p = T / 2.0 if cfg.noalias else T / 1.2

    maxfft = cfg.maxfft
    numtoread = 6 * cfg.maxfft
    master: List[RawBinCand] = []
    filepos = rlo - cfg.lobin
    while filepos + cfg.lobin < rhi:
        binsleft = rhi - (filepos + cfg.lobin)
        if binsleft < cfg.minfft:
            break
        if binsleft < numtoread:
            numtoread = maxfft
            while binsleft < numtoread and maxfft > cfg.minfft:
                maxfft //= 2
                numtoread = maxfft
        chunk = powers_all[filepos:filepos + numtoread]
        if filepos == 0:
            chunk = chunk.copy()
            chunk[0] = 1.0
        chunk = prune_powers(chunk, numsumpow)
        chunk_d = torch.from_numpy(
            np.ascontiguousarray(chunk, np.float32)).to(dev)
        fftlen = maxfft
        while fftlen >= cfg.minfft:
            stride = max(int(cfg.overlap * fftlen), 1)
            limit = len(chunk) - int((1.0 - cfg.overlap) * maxfft)
            starts = np.arange(0, max(limit, 1), stride)
            starts = starts[starts + fftlen <= len(chunk)]
            if len(starts) == 0:
                fftlen >>= 1
                continue
            # the starts are 0, stride, 2 stride, ...: the first windows
            # of the chunk's unfold, views of the uploaded chunk
            wins = chunk_d.unfold(0, fftlen, stride)[:len(starts)]
            lo_rs = starts + filepos + cfg.lobin
            new = search_minifft_batch(
                wins, T, N, lo_rs, min_orb_p, max_orb_p,
                numharm=cfg.harmsum, interbin=cfg.interbin,
                numbetween=cfg.numbetween,
                checkaliased=not cfg.noalias, numsumpow=numsumpow,
                device=dev)
            master = merge_rawbin_cands(master, new, 2 * cfg.ncand)
            fftlen >>= 1
        filepos += numtoread - int((1.0 - cfg.overlap) * maxfft)
    return master[:cfg.ncand]


def rawbin_report(cands: Sequence[RawBinCand]) -> str:
    """Text candidate table (file_rawbin_candidates analog)."""
    lines = ["#  Sigma   Power  Numsum   MiniFFT    mini_r     "
             "PSR_p(s)      Orb_p(s)    lo_r"]
    for i, c in enumerate(cands):
        lines.append(
            "%3d %7.3f %8.2f   %2.0f   %8.0f %10.3f  %12.6g  %12.4f %9.0f"
            % (i + 1, c.mini_sigma, c.mini_power, c.mini_numsum,
               c.mini_N, c.mini_r, c.psr_p, c.orb_p, c.full_lo_r))
    return "\n".join(lines) + "\n"
