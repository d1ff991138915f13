"""Single-pulse (matched-filter) search on a torch device.

PyTorch counterpart of ``presto_tpu/search/singlepulse.py``, with the
same names.  Reference algorithm (bin/single_pulse_search.py:252-516):
per series, linear-detrend 1000-sample blocks, robust per-block stds
with a 4-sigma bad-block cut, normalize to RMS 1, then slide
fftlen=8192 chunks (chunklen=8000 + overlap) over the series, convolve
each with the boxcar kernels of widths [1, 2, 3, 4, 6, 9, 14, 20, 30,
...] by an rfft multiply, threshold above sigma, and greedily prune
nearby weaker events.

The device work is torch ops on the search's ``device`` (CUDA unless
the caller asks for the CPU): the batched detrend over [nblocks,
detrendlen] (``_detrend_blocks``), the batched rfft -> kernel-bank
multiply -> irfft with a per-(chunk, width) top-k and exact
above-threshold counts (``_convolve_topk``), and in the resident path
the per-file top-G compaction (``_resident_pipeline``).  The host keeps
the bad-block logic and the pruning, with the JAX package's arithmetic
and candidate order.  What differs, none of which changes a result:

  * the per-row top-k is ``torch.topk``, whose tie order is unspecified:
    up to the row's capacity the above-threshold set does not depend on
    it, and a row with more hits than its capacity is taken again by a
    stable sort, so the lowest index wins a tie as in ``jax.lax.top_k``;
  * the resident pipeline runs its files in sub-batches whose smoothed
    output stays under ``SMOOTH_BYTES`` (the JAX package maps one file
    at a time);
  * no padding of chunk groups to one shape (it bounds XLA recompiles).

``agreement`` is the one rule by which the tests and ``chip_smoke.py``
hold two event lists of the same series (card and CPU, port and JAX
package) together: float32 FFTs differ between devices in the last bits,
so a line near the threshold, a ``%7.2f`` boundary or a prune near-tie
may differ, and every such line is reported.
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.io.atomic import atomic_open
from presto_tpu_torch.search.accel import (_topk_desc,
                                           check_full_f32_matmul,
                                           resolve_device)

DEFAULT_DOWNFACTS = (2, 3, 4, 6, 9, 14, 20, 30, 45, 70, 100, 150, 220, 300)
MAX_DOWNFACT = 30
# smoothed-output bytes of one sub-batch of the resident pipeline (its
# complex product takes about twice as much again)
SMOOTH_BYTES = 1 << 30


@dataclass(order=True)
class SPCandidate:
    """One single-pulse event (sorted by sample bin, like the reference)."""
    bin: int
    sigma: float = field(compare=False)
    time: float = field(compare=False)
    downfact: int = field(compare=False)
    dm: float = field(compare=False, default=0.0)

    def __str__(self) -> str:
        return "%7.2f %7.2f %13.6f %10d     %3d\n" % (
            self.dm, self.sigma, self.time, self.bin, self.downfact)


def boxcar_kernels(downfacts: Sequence[int], fftlen: int) -> np.ndarray:
    """Circular centered boxcar kernels, RMS-preserving 1/sqrt(w) norm.

    Parity: make_fftd_kerns (bin/single_pulse_search.py:45-61); the
    tap layout reproduces scipy.signal.convolve centering.  Width 1 is
    the identity (raw, un-smoothed search path).
    """
    kerns = np.zeros((len(downfacts), fftlen), dtype=np.float32)
    for i, df in enumerate(downfacts):
        if df == 1:
            kerns[i, 0] = 1.0
            continue
        if df % 2:
            kerns[i, :df // 2 + 1] = 1.0
            kerns[i, -(df // 2):] = 1.0
        else:
            kerns[i, :df // 2 + 1] = 1.0
            if df > 2:
                kerns[i, -(df // 2 - 1):] = 1.0
        kerns[i] /= np.sqrt(df)
    return kerns


def _detrend_blocks(blocks: torch.Tensor, detrendlen: int, fast: bool):
    """Batched per-block detrend + robust std on ``blocks``' device.

    blocks: [nblocks, detrendlen] float32.
    fast=False: remove per-block linear least-squares fit (the
    reference's scipy.signal.detrend(type='linear') loop).  fast=True:
    remove the per-block median only (the -f/--fast path); for an even
    count the median is the mean of the two middle values, as
    ``jnp.median`` computes it.
    Robust std: central 95% of the sorted residuals, with the 1.148
    clipped-Gaussian correction (single_pulse_search.py:380-393).
    Returns (resid [nblocks, detrendlen], stds [nblocks]).
    """
    n = detrendlen
    if fast:
        s = torch.sort(blocks, dim=-1).values
        med = (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5
        resid = blocks - med[:, None]
    else:
        check_full_f32_matmul(blocks.device, "single pulse: the detrend")
        tc = torch.arange(n, dtype=torch.float32,
                          device=blocks.device) - (n - 1) / 2.0
        tvar = (tc ** 2).sum()
        xbar = blocks.mean(dim=-1, keepdim=True)
        slope = ((blocks - xbar) @ tc) / tvar
        resid = blocks - xbar - slope[:, None] * tc
    s = torch.sort(resid, dim=-1).values
    inner = s[:, n // 40: n - n // 40]
    stds = torch.sqrt((inner ** 2).sum(dim=-1) / (0.95 * n)) * 1.148
    return resid, stds


def flag_bad_blocks(stds: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Identify blocks with outlying stds (dropouts / bursts of RFI).

    Parity: the locut/hicut split-off of the sorted stds and the
    +/-4 sigma cut (single_pulse_search.py:395-416).  Returns
    (bad_block_indices, median_stds, std_stds).
    """
    nb = len(stds)
    if nb < 4:
        return np.empty(0, dtype=np.int64), float(np.median(stds)), 0.0
    ss = np.sort(stds.astype(np.float64))
    locut = int(np.argmax(ss[1:nb // 2 + 1] - ss[:nb // 2])) + 1
    hicut = int(np.argmax(ss[nb // 2 + 1:] - ss[nb // 2:-1])) + nb // 2 - 2
    if hicut <= locut:
        locut, hicut = 0, nb
    std_stds = float(np.std(ss[locut:hicut]))
    median_stds = float(ss[(locut + hicut) // 2])
    lo, hi = median_stds - 4.0 * std_stds, median_stds + 4.0 * std_stds
    bad = np.flatnonzero((stds < lo) | (stds > hi))
    return bad, median_stds, std_stds


def _topk_rows(good: torch.Tensor, k: int, counts: torch.Tensor):
    """Top-k of each row, descending, where ``counts`` holds each row's
    number of values above the threshold.  torch.topk's tie order is
    unspecified, which only matters in a row with more hits than k:
    those rows are taken again by a stable sort (lowest index first on
    a tie, the jax.lax.top_k rule)."""
    vals, idx = torch.topk(good, k, dim=-1, largest=True, sorted=True)
    over = counts > k
    if bool(over.any()):
        sel = over.nonzero(as_tuple=True)
        v, i = _topk_desc(good[sel], k)
        vals[sel] = v
        idx[sel] = i
    return vals, idx


def _convolve_topk(chunks: torch.Tensor, kern_f: torch.Tensor,
                   threshold: float, fftlen: int, overlap: int, k: int):
    """Batched boxcar matched filter + per-row candidate extraction.

    chunks: [B, fftlen] normalized data; kern_f: [W, fftlen // 2 + 1]
    complex64 kernel bank on the same device.  Returns (vals [B, W, k],
    idx [B, W, k], counts [B, W]) where (vals, idx) are the top-k
    smoothed samples of the central chunklen window and counts is the
    exact number above threshold (overflow detector for the
    fixed-capacity extraction)."""
    cf = torch.fft.rfft(chunks, dim=-1)
    sm = torch.fft.irfft(cf[:, None, :] * kern_f[None, :, :], n=fftlen,
                         dim=-1)
    good = sm[..., overlap:fftlen - overlap]
    counts = (good > threshold).sum(dim=-1)
    vals, idx = _topk_rows(good, k, counts)
    return vals, idx, counts


def prune_related1(bins: List[int], vals: List[float],
                   downfact: int) -> Tuple[List[int], List[float]]:
    """Drop weaker events within downfact/2 bins of a stronger one
    (same width).  Parity: prune_related1
    (bin/single_pulse_search.py:63-88)."""
    toremove = set()
    for i in range(len(bins) - 1):
        if i in toremove:
            continue
        for j in range(i + 1, len(bins)):
            if abs(bins[j] - bins[i]) > downfact // 2:
                break
            if j in toremove:
                continue
            if vals[i] > vals[j]:
                toremove.add(j)
            else:
                toremove.add(i)
    keepb = [b for i, b in enumerate(bins) if i not in toremove]
    keepv = [v for i, v in enumerate(vals) if i not in toremove]
    return keepb, keepv


def prune_related2(cands: List[SPCandidate],
                   downfacts: Sequence[int]) -> List[SPCandidate]:
    """Cross-width pruning over the merged, bin-sorted candidate list.
    Parity: prune_related2 (bin/single_pulse_search.py:90-117)."""
    maxdf = max(downfacts) if downfacts else 1
    toremove = set()
    for i in range(len(cands) - 1):
        if i in toremove:
            continue
        x = cands[i]
        for j in range(i + 1, len(cands)):
            y = cands[j]
            if abs(y.bin - x.bin) > maxdf // 2:
                break
            if j in toremove:
                continue
            prox = max(x.downfact // 2, y.downfact // 2, 1)
            if abs(y.bin - x.bin) <= prox:
                if x.sigma > y.sigma:
                    toremove.add(j)
                else:
                    toremove.add(i)
    return [c for i, c in enumerate(cands) if i not in toremove]


def prune_border_cases(cands: List[SPCandidate],
                       offregions: Sequence[Tuple[int, int]]
                       ) -> List[SPCandidate]:
    """Drop events within a half-width of a data/padding boundary.
    Parity: prune_border_cases (bin/single_pulse_search.py:119-136)."""
    out = []
    for c in cands:
        lo = c.bin - c.downfact // 2
        hi = c.bin + c.downfact // 2
        clipped = any(hi > off and lo < on for off, on in offregions)
        if not clipped:
            out.append(c)
    return out


@dataclass
class SinglePulseSearch:
    """Configured matched-filter search over one normalized series, on
    ``device`` (CUDA unless the caller passes "cpu"; no CUDA device
    raises)."""
    threshold: float = 5.0
    maxwidth: float = 0.0          # seconds; 0 => bin cap MAX_DOWNFACT
    detrendlen: int = 1000
    fast_detrend: bool = False
    badblocks: bool = True
    chunklen: int = 8000
    fftlen: int = 8192
    topk: int = 256
    batch_chunks: int = 64
    device: str = "cuda"

    def __post_init__(self):
        self._dev = resolve_device(self.device)

    def downfacts_for(self, dt: float) -> List[int]:
        if self.maxwidth > 0.0:
            dfs = [x for x in DEFAULT_DOWNFACTS if x * dt <= self.maxwidth]
        else:
            dfs = [x for x in DEFAULT_DOWNFACTS if x <= MAX_DOWNFACT]
        return dfs or [DEFAULT_DOWNFACTS[0]]

    def _blocks_for(self, ts: np.ndarray) -> np.ndarray:
        dlen = self.detrendlen
        roundN = (len(ts) // dlen) * dlen
        return np.asarray(ts[:roundN], np.float32).reshape(-1, dlen)

    def _detrend(self, blocks) -> Tuple[torch.Tensor, torch.Tensor]:
        return _detrend_blocks(torch.as_tensor(blocks, device=self._dev),
                               self.detrendlen, self.fast_detrend)

    def _bad_blocks(self, stds: np.ndarray):
        """(adjusted stds, bad block indices) of one series' block stds:
        the bad-block cut (with ``badblocks``) and the zero-variance
        guard, bad blocks' stds replaced by the median."""
        # Constant (zero-variance) blocks — padding, dropouts — are
        # always bad: without the guard 0/0 NaNs (or huge roundoff
        # amplification) would poison every chunk whose convolution
        # window overlaps them.  Detrend roundoff leaves std ~1e-7
        # rather than exact 0, so the cut is relative to the median.
        medstd = float(np.median(stds)) if stds.size else 0.0
        zerostd = np.flatnonzero(stds <= 1e-4 * medstd)
        if self.badblocks:
            bad, med, _ = flag_bad_blocks(stds)
            bad = np.union1d(bad, zerostd)
            stds = stds.copy()
            stds[bad] = med if med > 0.0 else 1.0
        else:
            bad = zerostd
            stds = np.where(stds <= 0.0, 1.0, stds)
        return stds, bad

    def _finish_normalize(self, resid: np.ndarray, stds: np.ndarray):
        """Host-side half of normalize: bad-block logic + scaling."""
        if stds.size == 0:
            return (np.zeros(0, np.float32), stds,
                    np.empty(0, dtype=np.int64))
        stds, bad = self._bad_blocks(stds)
        normed = resid / stds[:, None]
        normed[bad] = 0.0
        return normed.reshape(-1), stds, bad

    def normalize(self, ts: np.ndarray):
        """Detrend + normalize; returns (normed series, stds, bad_blocks).
        Bad blocks are zeroed (they still participate in convolution
        overlaps, matching single_pulse_search.py:425-430)."""
        resid, stds = self._detrend(self._blocks_for(ts))
        return self._finish_normalize(resid.cpu().numpy(),
                                      stds.cpu().numpy())

    def normalize_many(self, series_list):
        """normalize() for many series in ONE detrend call (blocks are
        independent, so all files' blocks stack along axis 0)."""
        blist = [self._blocks_for(ts) for ts in series_list]
        counts = [b.shape[0] for b in blist]
        if sum(counts) == 0:
            return [self._finish_normalize(
                np.zeros((0, self.detrendlen), np.float32),
                np.zeros(0, np.float32)) for _ in blist]
        resid, stds = self._detrend(np.concatenate(blist, axis=0))
        resid = resid.cpu().numpy()
        stds = stds.cpu().numpy()
        out, o = [], 0
        for c in counts:
            out.append(self._finish_normalize(resid[o:o + c],
                                              stds[o:o + c]))
            o += c
        return out

    def _chunk_geometry(self, widths):
        """(widths, chunklen, fftlen, overlap, kern_f) — the one source
        of chunk layout for the single and batched paths; kern_f is the
        complex64 kernel bank on the search's device (the JAX package's
        float32 pairs, as complex)."""
        chunklen, fftlen = self.chunklen, self.fftlen
        if self.detrendlen > chunklen:
            chunklen = self.detrendlen
            fftlen = int(2 ** np.ceil(np.log2(chunklen)))
        overlap = (fftlen - chunklen) // 2
        kf = np.fft.rfft(boxcar_kernels(widths, fftlen))
        kern_f = torch.as_tensor(kf.astype(np.complex64), device=self._dev)
        return widths, chunklen, fftlen, overlap, kern_f

    @staticmethod
    def _padded_chunks(normed, numchunks, chunklen, overlap):
        """Overlap-padded copy of the series for chunk extraction."""
        N = len(normed)
        padded = np.zeros(overlap + numchunks * chunklen + overlap,
                          dtype=np.float32)
        padded[overlap:overlap + min(N, numchunks * chunklen)] = \
            normed[:numchunks * chunklen]
        return padded

    def _convolve_rows(self, rows, kern_f, fftlen, overlap, k):
        """_convolve_topk over host rows [B, fftlen], results on the host."""
        vals, idx, counts = _convolve_topk(
            torch.as_tensor(np.stack(rows), device=self._dev), kern_f,
            float(np.float32(self.threshold)), fftlen, overlap, k)
        return vals.cpu().numpy(), idx.cpu().numpy(), counts.cpu().numpy()

    def search_normalized(self, normed: np.ndarray, dt: float,
                          dm: float = 0.0,
                          downfacts: Optional[Sequence[int]] = None
                          ) -> List[SPCandidate]:
        """Run the batched matched filter over an RMS=1 series."""
        if downfacts is None:
            downfacts = self.downfacts_for(dt)
        widths, chunklen, fftlen, overlap, kern_f = \
            self._chunk_geometry(widths=[1] + list(downfacts))
        N = len(normed)
        numchunks = max(N // chunklen, 1)
        padded = self._padded_chunks(normed, numchunks, chunklen,
                                     overlap)
        cands: List[SPCandidate] = []
        for c0 in range(0, numchunks, self.batch_chunks):
            c1 = min(c0 + self.batch_chunks, numchunks)
            vals, idx, counts = self._convolve_rows(
                [padded[c * chunklen:c * chunklen + fftlen]
                 for c in range(c0, c1)], kern_f, fftlen, overlap,
                min(self.topk, chunklen))
            for ci in range(c1 - c0):
                _collect_chunk_hits(vals[ci], idx[ci], counts[ci],
                                    c0 + ci, widths, chunklen, N, dt,
                                    dm, cands)
        cands.sort()
        cands = prune_related2(cands, widths)
        return cands

    def search_many(self, series_list, dt: float,
                    dms: Sequence[float],
                    offregions_list=None):
        """Batched matched filter over MANY series (the survey's DM
        fan-out): the overlapped chunks of every file share the device
        calls.  Per-file results match search() exactly (same chunking,
        pruning, bad-block cuts).

        Returns a list of (cands, stds, bad) triples.
        """
        nf = len(series_list)
        if offregions_list is None:
            offregions_list = [()] * nf
        preps = self.normalize_many([np.asarray(ts, np.float32)
                                     for ts in series_list])
        widths, chunklen, fftlen, overlap, kern_f = \
            self._chunk_geometry(
                widths=[1] + list(self.downfacts_for(dt)))

        rows = []
        owners = []                       # (file_idx, chunknum)
        Ns = []
        for fi, (normed, stds, bad) in enumerate(preps):
            N = len(normed)
            Ns.append(N)
            numchunks = max(N // chunklen, 1)
            padded = self._padded_chunks(normed, numchunks, chunklen,
                                         overlap)
            for c in range(numchunks):
                rows.append(padded[c * chunklen:c * chunklen + fftlen])
                owners.append((fi, c))

        per_file: List[List[SPCandidate]] = [[] for _ in range(nf)]
        k = min(self.topk, chunklen)
        B = self.batch_chunks
        for g0 in range(0, len(rows), B):
            group = rows[g0:g0 + B]
            vals, idx, counts = self._convolve_rows(group, kern_f, fftlen,
                                                    overlap, k)
            for ri in range(len(group)):
                fi, chunknum = owners[g0 + ri]
                _collect_chunk_hits(vals[ri], idx[ri], counts[ri],
                                    chunknum, widths, chunklen,
                                    Ns[fi], dt, dms[fi], per_file[fi])

        out = []
        for fi, (normed, stds, bad) in enumerate(preps):
            cands = sorted(per_file[fi])
            cands = prune_related2(cands, widths)
            cands = self._post_filter(cands, bad, offregions_list[fi])
            out.append((cands, stds, bad))
        return out

    def block_scales(self, stds_all: np.ndarray):
        """The host half of the resident path's normalization, per file
        of the [nf, nblk] stds: (scales 1/std [nf, nblk] float32, masks
        [nf, nblk] float32 with 0 for bad blocks, bad block indices per
        file)."""
        nf, nblk = stds_all.shape
        scales = np.empty((nf, nblk), np.float32)
        masks = np.ones((nf, nblk), np.float32)
        bads = []
        for fi in range(nf):
            stds, bad = self._bad_blocks(stds_all[fi])
            scales[fi] = 1.0 / stds
            masks[fi, bad] = 0.0
            bads.append(bad)
        return scales, masks, bads

    def search_many_resident(self, series, dt: float,
                             dms: Sequence[float],
                             offregions_list=None, G: int = 2048,
                             obs=None):
        """search_many with the series DEVICE-RESIDENT end to end (the
        survey's seam regime: the dedispersed series are already on the
        device).  Only small arrays cross the boundary: per-block stds
        down, normalization scales up, and the compacted top-G
        above-threshold hits down.

        series: [nf, N] float32, a tensor (used as it is, on its own
        device: the search runs there) or a numpy array (uploaded once to
        the search's device).  Results match
        search_many exactly (same chunking, pruning, bad-block cuts)
        unless a file has more than G above-threshold top-k samples
        (heavy RFI): that file goes through search_many on the same
        device, the JAX package's own path.  ``obs`` receives the unit
        cost of the call (obs/costmodel kind "sp_search") for its shape.
        """
        nf = int(series.shape[0])
        N = int(series.shape[1])
        if offregions_list is None:
            offregions_list = [()] * nf
        if isinstance(series, torch.Tensor):
            if series.device.type != self._dev.type:
                raise ValueError("single pulse: series on %s, search on %s"
                                 % (series.device, self._dev))
            if series.device != self._dev:
                # a shard's series on another card: the whole call runs
                # there, the overflow path included
                return replace(self, device=series.device) \
                    .search_many_resident(series, dt, dms, offregions_list,
                                          G=G, obs=obs)
            dev = series
        else:
            dev = torch.as_tensor(np.asarray(series, np.float32),
                                  device=self._dev)
        dlen = self.detrendlen
        nblk = N // dlen
        widths, chunklen, fftlen, overlap, kern_f = \
            self._chunk_geometry(widths=[1] + list(self.downfacts_for(dt)))
        if obs is not None:
            from presto_tpu_torch.obs import costmodel
            costmodel.probe(obs, "sp_search", nf=nf, N=nblk * dlen,
                            nwidths=len(widths), chunklen=chunklen,
                            fftlen=fftlen)
        # pass 1: detrend once; residuals stay RESIDENT for pass 2,
        # only the tiny stds cross to the host
        roundN = nblk * dlen
        resid, stds_dev = _detrend_blocks(
            dev[:, :roundN].reshape(nf * nblk, dlen), dlen,
            self.fast_detrend)
        stds_all = stds_dev.cpu().numpy().reshape(nf, nblk)
        scales, masks, bads = self.block_scales(stds_all)
        # pass 2: normalize + frames + convolve + compact, on device
        k = min(self.topk, chunklen)
        tv, ti, tb, counts = _resident_pipeline(
            resid, torch.as_tensor(scales, device=resid.device),
            torch.as_tensor(masks, device=resid.device), kern_f,
            float(np.float32(self.threshold)), dlen, nblk, chunklen,
            fftlen, overlap, k, G)
        del resid
        out = []
        for fi in range(nf):
            capped = np.minimum(counts[fi], k).sum()
            if capped > G:
                # compaction overflow (pathological RFI): the host path
                row = dev[fi].cpu().numpy()
                out.append(self.search_many([row], dt, [dms[fi]],
                                            [offregions_list[fi]])[0])
                continue
            cands = self.decode_hits(tv[fi], ti[fi], tb[fi], widths,
                                     chunklen, k, nblk * dlen, dt,
                                     dms[fi])
            cands = self._post_filter(cands, bads[fi],
                                      offregions_list[fi])
            # adjusted stds, matching _finish_normalize's return
            out.append((cands, 1.0 / scales[fi], bads[fi]))
        return out

    def decode_hits(self, tv, ti, tb, widths, chunklen, k, roundN, dt,
                    dm) -> List[SPCandidate]:
        """One file's compacted hits (host arrays [G]) -> candidates,
        pruned per (chunk, width) and across widths.  The (chunk, width)
        groups are taken in the iteration order of a set of their keys,
        as the JAX package takes them: two candidates with one bin keep
        that order through the stable sort, and prune_related2 depends
        on it."""
        W = len(widths)
        good = tv > self.threshold
        chunk = ti[good] // (W * k)
        wi = (ti[good] // k) % W
        vals = tv[good]
        bins = tb[good] + chunk * chunklen
        cands: List[SPCandidate] = []
        for c, w in set(zip(chunk.tolist(), wi.tolist())):
            sel = (chunk == c) & (wi == w)
            df = widths[w]
            b = bins[sel]
            v = vals[sel]
            order = np.argsort(b)
            bl, vl = prune_related1([int(x) for x in b[order]],
                                    [float(x) for x in v[order]], df)
            for bb, vv in zip(bl, vl):
                # the host path bounds bins by the detrend-truncated
                # normed length, not the raw N
                if bb < roundN:
                    cands.append(SPCandidate(bin=bb, sigma=vv,
                                             time=bb * dt, downfact=df,
                                             dm=dm))
        cands.sort()
        return prune_related2(cands, widths)

    def _post_filter(self, cands, bad, offregions):
        """Bad-block cut + off-region border pruning (shared by the
        single and batched search paths)."""
        if len(bad):
            badset = set(int(b) for b in bad)
            dlen = self.detrendlen
            cands = [c for c in cands if (c.bin // dlen) not in badset]
        if offregions:
            cands = prune_border_cases(cands, offregions)
        return cands

    def search(self, ts: np.ndarray, dt: float, dm: float = 0.0,
               offregions: Sequence[Tuple[int, int]] = ()
               ) -> Tuple[List[SPCandidate], np.ndarray, np.ndarray]:
        """Full pipeline: detrend/normalize -> matched filter -> prune.
        Returns (candidates, per-block stds, bad block indices)."""
        normed, stds, bad = self.normalize(ts)
        cands = self.search_normalized(normed, dt, dm=dm)
        return self._post_filter(cands, bad, offregions), stds, bad


def resident_frames(resid: torch.Tensor, scales: torch.Tensor,
                    badmask: torch.Tensor, detrendlen: int, nblk: int,
                    chunklen: int, fftlen: int,
                    overlap: int) -> torch.Tensor:
    """Normalized, overlap-padded frames [nf, F, fftlen] (a strided view
    of one padded copy) from the detrend residuals [nf*nblk, detrendlen]
    and the host's scales and bad-block mask [nf, nblk]."""
    nf = scales.shape[0]
    roundN = nblk * detrendlen
    normed = (resid.reshape(nf, nblk, detrendlen)
              * (scales * badmask)[:, :, None]).reshape(nf, roundN)
    F = max(roundN // chunklen, 1)
    # the host path copies only F*chunklen samples into its padded
    # buffer (zeros beyond): the last chunk's right overlap reads zeros
    keep = min(F * chunklen, roundN)
    padded = torch.zeros((nf, (F - 1) * chunklen + fftlen),
                         dtype=torch.float32, device=resid.device)
    padded[:, overlap:overlap + keep] = normed[:, :keep]
    return padded.unfold(1, fftlen, chunklen)


def compact_hits(vals: torch.Tensor, idx: torch.Tensor, threshold: float,
                 G: int):
    """Per file, the top-G above-threshold entries of its [F, W, k]
    top-k values (rows [nb, F, W, k]): (tv [nb, G] with -1 for empty
    slots, ti [nb, G] the flat (chunk, width, slot) index, tb [nb, G]
    the matched-filter bin).  A stable sort: ties go to the lowest
    flat index, as jax.lax.top_k orders them."""
    nb = vals.shape[0]
    flatv = torch.where(vals > threshold, vals,
                        torch.full((), -1.0, dtype=vals.dtype,
                                   device=vals.device)).reshape(nb, -1)
    g = min(G, flatv.shape[1])
    tv, ti = _topk_desc(flatv, g)
    tb = torch.gather(idx.reshape(nb, -1), 1, ti)
    if g < G:
        tv = torch.nn.functional.pad(tv, (0, G - g), value=-1.0)
        ti = torch.nn.functional.pad(ti, (0, G - g))
        tb = torch.nn.functional.pad(tb, (0, G - g))
    return tv, ti, tb


def _resident_pipeline(resid, scales, badmask, kern_f, threshold,
                       detrendlen, nblk, chunklen, fftlen, overlap, k, G):
    """Device half of search_many_resident: detrend residuals
    [nf*nblk, detrendlen] (kept resident from the stds pass) ->
    per-file compacted hits, in sub-batches of files whose smoothed
    output fits SMOOTH_BYTES.  Returns host arrays (tv [nf, G], ti [nf,
    G], tb [nf, G], counts [nf, F, W]): the global top-G above-threshold
    smoothed samples per file with their flat (chunk, width) encoding
    and matched-filter bin, plus exact per-(chunk, width) hit counts
    (capacity/overflow checks)."""
    frames = resident_frames(resid, scales, badmask, detrendlen, nblk,
                             chunklen, fftlen, overlap)
    nf, F = frames.shape[0], frames.shape[1]
    W = kern_f.shape[0]
    per = max(1, SMOOTH_BYTES // (F * W * fftlen * 4))
    outs = []
    for f0 in range(0, nf, per):
        fr = frames[f0:f0 + per]
        nb = fr.shape[0]
        vals, idx, counts = _convolve_topk(fr.reshape(nb * F, fftlen),
                                           kern_f, threshold, fftlen,
                                           overlap, k)
        tv, ti, tb = compact_hits(vals.reshape(nb, F, W, k),
                                  idx.reshape(nb, F, W, k), threshold, G)
        outs.append([a.cpu().numpy() for a in
                     (tv, ti, tb, counts.reshape(nb, F, W))])
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))


def _collect_chunk_hits(vals_c, idx_c, counts_c, chunknum, widths,
                        chunklen, N, dt, dm, cands):
    """Turn one chunk's top-k device results into pruned candidates
    (shared by the single and batched search paths)."""
    for wi, df in enumerate(widths):
        nhit = int(counts_c[wi])
        if nhit == 0:
            continue
        if nhit > vals_c.shape[-1]:
            # Capacity overflow: pathological chunk (heavy RFI).
            # Keep the top-k strongest; the bad-block cut should
            # normally have zeroed such data.
            nhit = vals_c.shape[-1]
        v = vals_c[wi, :nhit]
        b = idx_c[wi, :nhit] + chunknum * chunklen
        order = np.argsort(b)
        bl, vl = prune_related1([int(x) for x in b[order]],
                                [float(x) for x in v[order]], df)
        for bb, vv in zip(bl, vl):
            if bb >= N:
                continue
            cands.append(SPCandidate(bin=bb, sigma=vv, time=bb * dt,
                                     downfact=df, dm=dm))


class SinglePulseStream:
    """Incremental (online) single-pulse search over a growing series.

    The explicit-carry counterpart of :meth:`SinglePulseSearch.search`:
    feed dedispersed samples as they arrive and get back candidates as
    soon as they are *final* — i.e. no future sample can change them —
    instead of waiting for the whole observation.  The device work runs
    on the search's device; the batch path stays the reference
    implementation.

    Equivalence contract: fed the same samples (in any chunking) as a
    batch ``search.search(ts, dt, dm)`` sees, the concatenation of
    every ``feed()`` result plus ``flush()`` is the same candidate set,
    PROVIDED ``search.badblocks`` is False (the batch bad-block cut
    ranks every block's std against the *whole observation's*
    distribution, which no online pass can know; construct the search
    with ``badblocks=False``) and no detrend block has near-zero
    variance (the batch zero-variance guard compares against the
    global median std — here the cut uses the *running* median, see
    ``_absorb_detrended``).  The carry reproduces the batch path's
    exact geometry: detrend blocks of ``detrendlen``, matched-filter
    chunks of ``chunklen`` with ``overlap`` margins, per-(chunk,width)
    ``prune_related1``, and ``prune_related2`` over bin-sorted
    candidates — made incremental by the chain-segment argument: the
    greedy cross-width prune only couples candidates through adjacent
    (sorted) pairs within ``maxdf//2`` bins, so a run of candidates
    separated from everything later by a larger gap is final.

    Dedup across block seams: a chunk is only searched once the NEXT
    chunk's samples exist (so its right overlap holds real data exactly
    like the batch padded buffer), and candidates within ``maxdf//2``
    bins of un-searched territory are held pending — no candidate is
    ever emitted twice or differently from the batch path.
    """

    def __init__(self, search: SinglePulseSearch, dt: float,
                 dm: float = 0.0,
                 downfacts: Optional[Sequence[int]] = None):
        if search.badblocks:
            raise ValueError(
                "SinglePulseStream requires badblocks=False: the batch "
                "bad-block cut needs the whole observation's std "
                "distribution (see class docstring)")
        self.search = search
        self.dt = float(dt)
        self.dm = float(dm)
        if downfacts is None:
            downfacts = search.downfacts_for(dt)
        (self.widths, self.chunklen, self.fftlen, self.overlap,
         self._kern_f) = search._chunk_geometry(
            widths=[1] + list(downfacts))
        self.maxdf = max(self.widths)
        self.dlen = search.detrendlen
        self._k = min(search.topk, self.chunklen)
        self._tail = np.zeros(0, np.float32)    # raw, < detrendlen
        self._nfed = 0                          # raw samples fed
        self._nnormed = 0                       # normalized samples
        self._nbuf = np.zeros(0, np.float32)    # normalized suffix
        self._nbuf_start = 0                    # abs index of _nbuf[0]
        self._next_chunk = 0
        self._pending: List[SPCandidate] = []
        self._stds: List[float] = []
        self._bad: set = set()                  # bad detrend blocks
        self._offregions: List[Tuple[int, int]] = []
        self._flushed = False

    # -- carry state views --------------------------------------------
    @property
    def stds(self) -> np.ndarray:
        """Per-detrend-block stds seen so far (the running carry the
        batch path returns all at once)."""
        return np.asarray(self._stds, np.float32)

    @property
    def bad_blocks(self) -> np.ndarray:
        return np.asarray(sorted(self._bad), np.int64)

    @property
    def samples_fed(self) -> int:
        return self._nfed

    @property
    def pending(self) -> int:
        """Candidates held back pending cross-seam dedup."""
        return len(self._pending)

    def emission_floor(self) -> int:
        """Lower bound (bin) on every candidate this stream can still
        emit: future chunks produce bins >= next_chunk*chunklen, the
        chain guard can reach maxdf//2 below that, and held pending
        candidates may sit lower still."""
        floor = self._next_chunk * self.chunklen - self.maxdf // 2
        if self._pending:
            floor = min(floor, min(c.bin for c in self._pending))
        return floor

    def add_offregion(self, lo: int, hi: int) -> None:
        """Register a data/padding boundary region (normalized-series
        bins) for border pruning; must be added before the region's
        candidates finalize."""
        self._offregions.append((int(lo), int(hi)))

    # -- feeding ------------------------------------------------------
    def feed(self, x: np.ndarray) -> List[SPCandidate]:
        """Append raw dedispersed samples; returns newly-final
        candidates (bin-sorted, pruned exactly like the batch path)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        x = np.asarray(x, np.float32).ravel()
        buf = np.concatenate([self._tail, x]) if self._tail.size else x
        nblk = buf.size // self.dlen
        if nblk:
            resid, stds = self.search._detrend(
                buf[:nblk * self.dlen].reshape(nblk, self.dlen))
            self._absorb_detrended(resid.cpu().numpy(), stds.cpu().numpy())
        self._tail = buf[nblk * self.dlen:]
        self._nfed += x.size
        ready = []
        while self._nnormed >= (self._next_chunk + 2) * self.chunklen:
            ready.append(self._next_chunk)
            self._next_chunk += 1
        if ready:
            # mid-stream a chunk is searched only when the next chunk's
            # samples exist, so its window is all real data — exactly
            # what the batch padded buffer holds for a non-final chunk
            self._search_chunks(ready, limit=self._nnormed,
                                ncut=None)
        return self._finalize(final=False)

    def flush(self) -> List[SPCandidate]:
        """End of stream: search the remaining chunks with the batch
        path's zero padding, emit everything still pending.  The raw
        tail below one detrend block is dropped, matching the batch
        truncation to a whole number of detrend blocks."""
        if self._flushed:
            return []
        self._flushed = True
        self._tail = np.zeros(0, np.float32)
        N = self._nnormed
        if N == 0:
            self._pending = []
            return []
        numchunks = max(N // self.chunklen, 1)
        ready = list(range(self._next_chunk, numchunks))
        self._next_chunk = numchunks
        if ready:
            self._search_chunks(
                ready, limit=min(N, numchunks * self.chunklen), ncut=N)
        return self._finalize(final=True)

    # -- internals ----------------------------------------------------
    def _absorb_detrended(self, resid: np.ndarray,
                          stds: np.ndarray) -> None:
        """Normalize freshly-detrended blocks.  Zero-variance guard:
        the batch path cuts stds <= 1e-4 x the observation-wide median
        — online, the median of every block seen so far stands in (the
        only divergence from batch, and only for degenerate blocks)."""
        base = len(self._stds)
        self._stds.extend(float(s) for s in stds)
        medstd = float(np.median(np.asarray(self._stds)))
        bad = np.flatnonzero(stds <= 1e-4 * medstd)
        adj = np.where(stds <= 0.0, 1.0, stds)
        normed = resid / adj[:, None]
        normed[bad] = 0.0
        for r in bad:
            self._bad.add(base + int(r))
        self._nbuf = (np.concatenate([self._nbuf, normed.reshape(-1)])
                      if self._nbuf.size else normed.reshape(-1))
        self._nnormed += normed.size

    def _chunk_row(self, c: int, limit: int) -> np.ndarray:
        """The batch padded-buffer window for chunk `c`: normalized
        samples [c*chunklen - overlap, +fftlen), zeros outside
        [0, limit)."""
        row = np.zeros(self.fftlen, np.float32)
        lo = c * self.chunklen - self.overlap
        a = max(lo, 0)
        b = min(lo + self.fftlen, limit)
        if b > a:
            row[a - lo:b - lo] = \
                self._nbuf[a - self._nbuf_start:b - self._nbuf_start]
        return row

    def _search_chunks(self, chunks: List[int], limit: int,
                       ncut: Optional[int]) -> None:
        vals, idx, counts = self.search._convolve_rows(
            [self._chunk_row(c, limit) for c in chunks], self._kern_f,
            self.fftlen, self.overlap, self._k)
        # ncut None: mid-stream no bin can reach the eventual N (bins
        # are < (c+1)*chunklen <= nnormed at search time, and N only
        # grows) — the batch bb >= N guard cannot fire, skip it
        N = (1 << 62) if ncut is None else ncut
        for ri, c in enumerate(chunks):
            _collect_chunk_hits(vals[ri], idx[ri], counts[ri], c,
                                self.widths, self.chunklen, N,
                                self.dt, self.dm, self._pending)
        # drop normalized samples no chunk will need again
        keep_from = max(self._next_chunk * self.chunklen - self.overlap,
                        0)
        if keep_from > self._nbuf_start:
            self._nbuf = self._nbuf[keep_from - self._nbuf_start:]
            self._nbuf_start = keep_from

    def _finalize(self, final: bool) -> List[SPCandidate]:
        """Emit candidates no future sample can affect.  Future
        candidates all land at bins >= next_chunk*chunklen, and the
        greedy cross-width prune couples candidates only through
        adjacent sorted pairs within maxdf//2 bins — so chain segments
        ending before that frontier minus maxdf//2 prune identically
        to the batch path's single global pass."""
        if not self._pending:
            return []
        self._pending.sort()
        frontier = self._next_chunk * self.chunklen
        guard = self.maxdf // 2
        out: List[SPCandidate] = []
        keep: List[SPCandidate] = []
        seg: List[SPCandidate] = []
        for c in self._pending + [None]:
            if c is not None and (not seg
                                  or c.bin - seg[-1].bin <= guard):
                seg.append(c)
                continue
            if seg:
                if final or seg[-1].bin < frontier - guard:
                    out.extend(prune_related2(seg, self.widths))
                else:
                    keep.extend(seg)
            seg = [c] if c is not None else []
        self._pending = keep
        return self.search._post_filter(out, self.bad_blocks,
                                        tuple(self._offregions))


def write_singlepulse(path: str, cands: Sequence[SPCandidate]) -> None:
    """Write the .singlepulse ASCII artifact (reference column format,
    atomic on disk)."""
    with atomic_open(path, "w") as f:
        if cands:
            f.write("# DM      Sigma      Time (s)     Sample    Downfact\n")
            for c in cands:
                f.write(str(c))


def read_singlepulse(path: str, dm: float = 0.0) -> List[SPCandidate]:
    cands = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cands.append(SPCandidate(
                dm=float(parts[0]), sigma=float(parts[1]),
                time=float(parts[2]), bin=int(parts[3]),
                downfact=int(parts[4])))
    return cands


# ----------------------------------------------------------------------
# Agreement of two event lists of the same series
# ----------------------------------------------------------------------

SIGMA_ATOL = 2e-4    # matched lines' sigmas, before rounding
NEAR_REL = 1e-5      # a one-sided line's margin (threshold, prune partner)
PRINT_HALF = 0.005   # half a unit of the %7.2f sigma column


def agreement(want: Sequence[SPCandidate], got: Sequence[SPCandidate],
              threshold: float, want_printed: bool = False,
              got_printed: bool = False) -> dict:
    """Hold two event lists of one series together (file order, as
    search returns them or read_singlepulse reads them).

    Lines are matched by (DM, bin, downfact), the k-th occurrence of a
    key on one side with the k-th on the other, and the matched lines
    must come in the same order with the same time (within the %13.6f
    rounding of a side read from a file).  A matched pair's
    sigmas agree within SIGMA_ATOL (plus PRINT_HALF for each side read
    from a file, ``*_printed``); where their printed lines differ, a
    ``%7.2f`` boundary lies between them: a "boundary" line.  A line on
    one side only is allowed when its sigma lies within NEAR_REL
    (relative) of the threshold, or when a line on the other side within
    its prune distance (max of the half-widths, at least 1 bin) has a
    sigma within NEAR_REL of its own: a prune near-tie went the other
    way ("one_sided").  Anything else is "bad".  Returns dict(ok,
    matched, equal_lines, boundary, one_sided, bad), each listed line
    with its numbers."""
    q = {"want": PRINT_HALF if want_printed else 0.0,
         "got": PRINT_HALF if got_printed else 0.0}
    # the time column's %13.6f rounding
    tq = 5e-7 * (want_printed + got_printed)
    key = lambda c: (round(c.dm, 6), c.bin, c.downfact)  # noqa: E731
    slots = defaultdict(deque)
    for j, c in enumerate(got):
        slots[key(c)].append(j)
    pairs, used = [], set()
    for i, c in enumerate(want):
        if slots[key(c)]:
            j = slots[key(c)].popleft()
            pairs.append((i, j))
            used.add(j)
    out = dict(matched=len(pairs), equal_lines=0, boundary=[],
               one_sided=[], bad=[])
    if [j for _i, j in pairs] != sorted(j for _i, j in pairs):
        out["bad"].append(dict(why="matched lines in another order"))
    for i, j in pairs:
        a, b = want[i], got[j]
        d = abs(a.sigma - b.sigma)
        rec = dict(dm=a.dm, bin=a.bin, downfact=a.downfact,
                   want_sigma=a.sigma, got_sigma=b.sigma)
        if abs(a.time - b.time) > tq or d > SIGMA_ATOL + q["want"] + q["got"]:
            out["bad"].append(dict(rec, why="sigma or time"))
        elif str(a) != str(b):
            out["boundary"].append(rec)
        else:
            out["equal_lines"] += 1
    matched_want = {i for i, _j in pairs}
    for side, mine, other, taken in (("want", want, got, matched_want),
                                     ("got", got, want, used)):
        oside = "got" if side == "want" else "want"
        for i, c in enumerate(mine):
            if i in taken:
                continue
            rec = dict(side=side, dm=c.dm, bin=c.bin, downfact=c.downfact,
                       sigma=c.sigma)
            if abs(c.sigma - threshold) <= NEAR_REL * threshold + q[side]:
                out["one_sided"].append(dict(rec, why="threshold"))
                continue
            partner = [o for o in other
                       if o.dm == c.dm
                       and abs(o.bin - c.bin) <= max(c.downfact // 2,
                                                     o.downfact // 2, 1)
                       and abs(o.sigma - c.sigma)
                       <= NEAR_REL * max(o.sigma, c.sigma) + q[side]
                       + q[oside]]
            if partner:
                p = partner[0]
                out["one_sided"].append(dict(
                    rec, why="prune near-tie", partner_bin=p.bin,
                    partner_downfact=p.downfact, partner_sigma=p.sigma))
            else:
                out["bad"].append(dict(rec, why="one side only"))
    out["ok"] = not out["bad"]
    return out


def file_agreement(want_path: str, got_path: str, threshold: float) -> dict:
    """agreement() of two .singlepulse files; ``same_bytes`` says whether
    they are byte-equal (then nothing else is compared)."""
    with open(want_path, "rb") as f:
        a = f.read()
    with open(got_path, "rb") as f:
        b = f.read()
    if a == b:
        n = len(read_singlepulse(want_path))
        return dict(ok=True, same_bytes=True, matched=n, equal_lines=n,
                    boundary=[], one_sided=[], bad=[])
    out = agreement(read_singlepulse(want_path), read_singlepulse(got_path),
                    threshold, want_printed=True, got_printed=True)
    out["same_bytes"] = False
    return out
