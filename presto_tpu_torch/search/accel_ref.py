"""NumPy/SciPy reference accelsearch: the float64 referee.

This is the same staged harmonic-summing F-Fdot search AccelSearch runs
on the card (plane build per r-block: spread x2 interbin, forward FFT,
per-z-row multiply by conj(z-response), inverse FFT, |.|^2; then
per-stage subharmonic adds and powcut thresholding), written in plain
NumPy + scipy.fft (pocketfft) at selectable precision.  It is the
**float64 referee** (SURVEY.md s7.3.1 north-star acceptance): the card's
float32 candidate list must match this path after sigma rounding, by
``agreement`` (tests/test_referee.py's rule).

Parity anchors: subharm_ffdot_plane (accel_utils.c:879-1051), inmem
harmonic sums (accel_utils.c:1160-1256), search_ffdotpows
(accel_utils.c:1259-1298), powcut/numindep (accel_utils.c:1629-1641).

Host copy of ``presto_tpu/search/accel_ref.py`` for the PyTorch port,
which imports nothing from the JAX package.  The referee reads the
geometry of the caller's ``AccelSearch`` (its retuned uselen, its
effective halfwidth ``hw_eff`` and its block plan), so its float64
plane has the columns of that searcher's plane on the card; the
referee's arithmetic stays on the host.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import fft as sfft

from presto_tpu_torch.ops import stats as st
from presto_tpu_torch.search.accel import (
    ACCEL_DR,
    ACCEL_DZ,
    ACCEL_NUMBETWEEN,
    ACCEL_RDR,
    AccelCand,
    AccelKernels,
    AccelSearch,
    _harm_fracs_and_zinds,
)


def _fft(x, workers, axis=-1):
    return sfft.fft(x, axis=axis, workers=workers)


def _ifft(x, workers, axis=-1):
    return sfft.ifft(x, axis=axis, workers=workers)


def kernel_bank_ref(kern: AccelKernels, cdtype=np.complex128) -> np.ndarray:
    """FFT'd [numz, fftlen] kernel bank at the requested precision.

    Same NR wrap placement as the device's _fft_kernel_bank
    (place_complex_kernel, corr_prep.c:58-80).  complex128 keeps the
    float64 referee honest; pass complex64 to reproduce the device bank
    at float32.
    """
    kc = (kern.kern_pairs[..., 0].astype(np.float64)
          + 1j * kern.kern_pairs[..., 1].astype(np.float64))
    half = kern.kmax // 2
    placed = np.zeros((kc.shape[0], kern.fftlen), dtype=np.complex128)
    placed[:, :half] = kc[:, half:]
    placed[:, kern.fftlen - half:] = kc[:, :half]
    return np.fft.fft(placed, axis=-1).astype(cdtype)


def build_plane_ref(search: AccelSearch, spectrum: np.ndarray,
                    dtype=np.float64,
                    workers: Optional[int] = None,
                    kern: Optional[AccelKernels] = None
                    ) -> Tuple[np.ndarray, int]:
    """The fundamental F-Fdot power plane, host-side.

    spectrum: [numbins] complex (or [numbins, 2] float pairs).
    Returns (plane[numz, plane_cols], col0) where column c holds the
    power at absolute half-bin col0*0 + c (i.e. r = c * ACCEL_DR), with
    columns below col0 zero — the same layout AccelSearch.build_plane
    produces on the card.

    kern: an alternate kernel bank (a jerk search's w-plane bank from
    AccelKernels.build(cfg, w) — fftlen/uselen geometry is shared by
    every bank of a config); defaults to the search's z-only bank.
    """
    if spectrum.ndim == 2:
        spectrum = spectrum[..., 0] + 1j * spectrum[..., 1]
    cdtype = np.complex128 if dtype == np.float64 else np.complex64
    kern = kern if kern is not None else search.kern
    cfg = search.cfg
    bank = np.conj(kernel_bank_ref(kern, cdtype))
    starts = search._plan_blocks()
    if not starts:
        return np.zeros((kern.numz, 0), dtype=dtype), 0
    numdata = kern.fftlen // 2
    # the search's EFFECTIVE halfwidth: on the aligned geometry the
    # card's plane builder pads the window offset to a 64-bin boundary,
    # shifting every block's read window and normalization window with
    # it; the referee uses the same geometry to produce the same list
    hw_use = search.hw_eff
    offset = hw_use * ACCEL_NUMBETWEEN
    col0 = int(starts[0]) * ACCEL_RDR
    plane_cols = col0 + len(starts) * cfg.uselen
    plane = np.zeros((kern.numz, plane_cols), dtype=dtype)
    spec = np.asarray(spectrum, dtype=cdtype)
    nbins = spec.shape[0]
    for j, s0 in enumerate(starts):
        lobin = int(s0) - hw_use
        win = np.zeros(numdata, dtype=cdtype)
        lo, hi = max(lobin, 0), min(lobin + numdata, nbins)
        win[lo - lobin:hi - lobin] = spec[lo:hi]
        # old-style per-block median normalization (accel_utils.c:952-967)
        if cfg.norm == "median":
            med = max(float(np.median(win.real ** 2 + win.imag ** 2)),
                      1e-30)
            norm = 1.0 / np.sqrt(med / np.log(2.0))
        else:
            norm = 1.0
        spread = np.zeros(kern.fftlen, dtype=cdtype)
        spread[::ACCEL_NUMBETWEEN] = win * dtype(norm)
        fdata = _fft(spread, workers)
        corr = _ifft(fdata[None, :] * bank, workers)
        good = corr[:, offset:offset + cfg.uselen]
        c = col0 + j * cfg.uselen
        plane[:, c:c + cfg.uselen] = (good.real ** 2 + good.imag ** 2)
    return plane, col0


def _accum_stages(search: AccelSearch, plane: np.ndarray):
    """Yield (stage, acc[numz, top-r0]) after each stage's subharmonic
    adds — the ONE accumulation loop both the referee search
    (search_plane_ref) and the cell-power probe (ref_cell_powers)
    consume, so they cannot desynchronize.  acc is accumulated in
    place: consumers must not mutate it."""
    cfg = search.cfg
    numz, plane_cols = plane.shape
    r0 = int(search.rlo) * ACCEL_RDR
    top = min(int(search.rhi) * ACCEL_RDR, plane_cols)
    if top <= r0:
        return
    acc = plane[:, r0:top].copy()
    fz = _harm_fracs_and_zinds(cfg, numz)
    yield 0, acc
    cols = np.arange(r0, top, dtype=np.int64)
    for stage in range(1, cfg.numharmstages):
        for (harm, htot, zinds) in fz[stage - 1]:
            # exact round-half-up of cols*harm/htot (overflow-safe),
            # as ONE int32 map per term
            rind = ((cols // htot) * harm +
                    ((cols % htot) * harm + (htot >> 1)) // htot
                    ).astype(np.int32)
            # zinds is nondecreasing with long runs of repeats (the
            # subharmonic z grid is coarser by 1/frac): gather each
            # DISTINCT source row once, then one broadcast add per run
            # — the numpy formulation closest to C-loop speed.
            zinds = np.asarray(zinds)
            runs = np.flatnonzero(np.diff(zinds)) + 1
            starts = np.concatenate([[0], runs])
            ends = np.concatenate([runs, [len(zinds)]])
            for g0, g1 in zip(starts, ends):
                acc[g0:g1] += np.take(plane[zinds[g0]], rind)[None, :]
        yield stage, acc


def search_plane_ref(search: AccelSearch, plane: np.ndarray,
                     max_cands_per_stage: int = 1 << 16) -> List[AccelCand]:
    """Staged harmonic-summing search of a host plane.

    Candidate semantics match AccelSearch: per stage, each column
    contributes its max-over-z cell when above powcut[stage] (the
    sifter's r-dedup makes same-column lower-z cells duplicates);
    callers apply remove_duplicates for the final list, exactly as the
    reference's insert_new_accelcand (accel_utils.c:294-382) does at
    insert time.
    """
    cfg = search.cfg
    r0 = int(search.rlo) * ACCEL_RDR
    cands: List[AccelCand] = []

    def collect(acc, stage):
        numharm = 1 << stage
        colmax = acc.max(axis=0)
        good = np.flatnonzero(colmax > search.powcut[stage])
        if good.size > max_cands_per_stage:       # keep the strongest
            good = good[np.argsort(colmax[good])[::-1]
                        [:max_cands_per_stage]]
        if good.size == 0:
            return
        # z row only needed for accepted columns (a full-plane argmax
        # would cost more than the harmonic sums themselves)
        colz = acc[:, good].argmax(axis=0)
        sigmas = np.atleast_1d(st.candidate_sigma(
            colmax[good], numharm, search.numindep[stage]))
        for gi, zi, sg in zip(good.tolist(), colz.tolist(),
                              sigmas.tolist()):
            rr = (r0 + gi) * ACCEL_DR / numharm
            zz = (-cfg.zmax + zi * ACCEL_DZ) / numharm
            cands.append(AccelCand(power=float(colmax[gi]), sigma=sg,
                                   numharm=numharm, r=rr, z=zz))

    for stage, acc in _accum_stages(search, plane):
        collect(acc, stage)
    return sorted(cands, key=lambda c: (-c.sigma, c.r))


def ref_cell_powers(search: AccelSearch, spectrum: np.ndarray,
                    cells, dtype=np.float32,
                    workers: Optional[int] = None) -> List[float]:
    """Harmonic-summed power of the reference path at specific cells.

    cells: list of (stage, zrow, col) in FUNDAMENTAL-plane units —
    stage = log2(numharm), col = candidate r * numharm / ACCEL_DR,
    zrow = (candidate z * numharm + zmax) / ACCEL_DZ.  Used by the
    e2e referee to explain chip candidates with no reference
    counterpart: a cell whose ref power sits just below powcut while
    the chip's float32 ordering put it just above is a legitimate
    threshold-straddle, not a missed feature (the reference's own
    -inmem vs standard split has the same texture, SURVEY §4.8).
    """
    plane, _ = build_plane_ref(search, spectrum, dtype=dtype,
                               workers=workers)
    numz = plane.shape[0]
    r0 = int(search.rlo) * ACCEL_RDR
    top = min(int(search.rhi) * ACCEL_RDR, plane.shape[1])
    out = [float("nan")] * len(cells)
    for stage, acc in _accum_stages(search, plane):
        for i, (sg, zr, col) in enumerate(cells):
            if sg == stage and 0 <= zr < numz and r0 <= col < top:
                out[i] = float(acc[int(zr), int(col) - r0])
    return out


def search_ref(fft_pairs: np.ndarray, search: AccelSearch,
               dtype=np.float64,
               workers: Optional[int] = None) -> List[AccelCand]:
    """Full reference search: pairs/complex spectrum -> candidate list,
    over ``search``'s geometry (its cfg, T and numbins).

    dtype=np.float64 is the referee configuration; dtype=np.float32
    reproduces the card's arithmetic on the host.
    """
    if workers is None:
        workers = os.cpu_count() or 1
    plane, _ = build_plane_ref(search, fft_pairs, dtype=dtype,
                               workers=workers)
    return search_plane_ref(search, plane)


def timed_search_ref(fft_pairs: np.ndarray, search: AccelSearch,
                     dtype=np.float32, workers: Optional[int] = None):
    """(candidates, plane_seconds, search_seconds, cells) over
    ``search``'s geometry."""
    if workers is None:
        workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    plane, _ = build_plane_ref(search, fft_pairs, dtype=dtype,
                               workers=workers)
    t1 = time.perf_counter()
    cands = search_plane_ref(search, plane)
    t2 = time.perf_counter()
    numr = int(search.rhi - search.rlo) * ACCEL_RDR
    cells = search.cfg.numz * numr
    return cands, t1 - t0, t2 - t1, cells


def timed_jerk_ref(fft_pairs: np.ndarray, search: AccelSearch,
                   dtype=np.float32, workers: Optional[int] = None):
    """(ncands, seconds, cells) of a jerk search on the host, over
    ``search``'s geometry (its cfg's w planes).

    Per w plane: fundamental plane built with that w's kernel bank,
    then the staged harmonic-summing search.  CONSERVATIVE by
    construction: the true algorithm (the reference's -wmax path and
    the card's _search_jerk) reads each SUBHARMONIC from its own
    w-scaled plane, costing extra plane builds per w — this twin sums
    subharmonics from the same-w plane, so its time UNDERESTIMATES the
    reference's work.  Kernel-bank generation is excluded from the
    timed span (the reference likewise excludes its 'Generating
    correlation kernels' setup, accelsearch.c:134-160).
    """
    if workers is None:
        workers = os.cpu_count() or 1
    cfg = search.cfg
    ws = sorted(float(x) for x in cfg.ws)
    banks = {w: AccelKernels.build(cfg, w) for w in ws}   # untimed
    t0 = time.perf_counter()
    ncands = 0
    for w in ws:
        plane, _ = build_plane_ref(search, fft_pairs, dtype=dtype,
                                   workers=workers, kern=banks[w])
        ncands += len(search_plane_ref(search, plane))
    el = time.perf_counter() - t0
    numr = int(search.rhi - search.rlo) * ACCEL_RDR
    cells = cfg.numz * numr * len(ws)
    return ncands, el, cells


# agreement's constants, tests/test_referee.py's.  remove_duplicates
# collapses everything within ACCEL_CLOSEST_R = 15 bins to the cluster
# peak, so float32-against-float64 rounding may flip which sidelobe cell
# of a strong signal survives as the representative (observed: +-1
# half-bin in r, one z step, ~0.2 sigma): the rule is exact only for
# isolated candidates, and by cluster otherwise.
MARGIN = 0.5        # "strong": sigma above the cutoff by this much
ISOLATION = 30.0    # isolated: no other referee candidate this close (bins)
SIGMA_ATOL = 0.1    # an isolated match's sigma, after sigma rounding
POWER_RTOL = 1e-3   # an isolated match's power
# two dedup radii (2 ACCEL_CLOSEST_R + 1): a representative may move by
# one radius on each side when a borderline peak flips which neighbour
# it merges into (observed: representatives 15.0 bins apart between the
# two precisions)
RADIUS = 31.0
MIN_EXACT = 3       # the rule must exercise (1)


def _key(c: AccelCand):
    return (c.numharm, round(2 * c.r), round(2 * c.z))


def agreement(dev: Sequence[AccelCand], ref: Sequence[AccelCand],
              cutoff: float) -> dict:
    """tests/test_referee.py's rule for a float32 list ``dev`` against
    the float64 referee's ``ref``, both after remove_duplicates.

    Of the candidates above ``cutoff + MARGIN`` ("strong"):
    (1) each strong referee candidate with no other referee candidate
        within ISOLATION bins ("isolated") is in ``dev`` under the same
        key (numharm, round(2r), round(2z)), its sigma within SIGMA_ATOL
        and its power within POWER_RTOL; at least MIN_EXACT are;
    (2) each strong candidate on either side has a candidate on the
        other within RADIUS bins whose sigma is above its own less 1.
    Returns ok, the counts, the number of exact matches, the largest
    sigma and relative power differences among them, and each failure
    as text."""
    dev_strong = [c for c in dev if c.sigma > cutoff + MARGIN]
    ref_strong = [c for c in ref if c.sigma > cutoff + MARGIN]
    dev_all = {_key(c): c for c in dev}
    failures: List[str] = []
    exact, max_dsigma, max_dpower = 0, 0.0, 0.0
    for rc in ref_strong:
        if any(o is not rc and abs(o.r - rc.r) <= ISOLATION
               for o in ref):
            continue
        dc = dev_all.get(_key(rc))
        if dc is None:
            failures.append("isolated referee candidate missing: %s" % (rc,))
            continue
        dsig = abs(dc.sigma - rc.sigma)
        dpow = abs(dc.power - rc.power) / abs(rc.power)
        max_dsigma, max_dpower = max(max_dsigma, dsig), max(max_dpower,
                                                            dpow)
        if (dsig > max(SIGMA_ATOL, 1e-6 * abs(rc.sigma))
                or dpow > POWER_RTOL):
            failures.append("isolated candidate differs: referee %s, "
                            "card %s" % (rc, dc))
            continue
        exact += 1
    if exact < MIN_EXACT:
        failures.append("%d isolated strong candidates matched, fewer "
                        "than %d" % (exact, MIN_EXACT))
    for a, b, what in ((ref_strong, dev, "card"), (dev_strong, ref,
                                                    "referee")):
        for c in a:
            near = [o for o in b if abs(o.r - c.r) < RADIUS]
            if not near:
                failures.append("cluster absent in the %s list: %s"
                                % (what, c))
            elif max(o.sigma for o in near) <= c.sigma - 1.0:
                failures.append("cluster weaker in the %s list: %s"
                                % (what, c))
    return dict(ok=not failures, n_dev=len(dev), n_ref=len(ref),
                n_dev_strong=len(dev_strong), n_ref_strong=len(ref_strong),
                exact=exact, max_sigma_diff=max_dsigma,
                max_power_rdiff=max_dpower, failures=failures)
