"""prepfold: fold-cube construction + (DM x p x pd) search, on PyTorch.

PyTorch counterpart of ``presto_tpu/search/prepfold.py``.  Reference
call stack (SURVEY.md §3.4, src/prepfold.c): fold raw/dat data into a
(npart x nsub x proflen) double cube, then grid-search DM, period and
p-dot by rotating and summing profiles, maximizing the reduced
chi-squared of the summed profile (prepfold.c:1415-1700).

The fold is the drizzle of ops/fold.py on the device (bit-equal to the
JAX package's).  The searches factor as the JAX package's do, (1)
chi2(DM) with the parts summed at the fold period, then (2)
chi2(f, fd[, fdd]) at the best DM, and take the same float32 inputs:
every trial's part shifts are planned on the host in float64 and the
trials run on the device in chunks, each one batched gather, blend, sum
and chi2.  The device sums reduce in their own order, so the chi2
surfaces agree with the JAX package's within float32 rounding (and the
best trial with them, but for a near-tie).  All host bookkeeping (the
occupancy correction, fold statistics, error estimates) is the JAX
package's code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.ops import fold as fo
from presto_tpu_torch.ops.dedispersion import delay_from_dm

#: bytes of gather indices one trial chunk may take on the device
TRIAL_CHUNK_BYTES = 1 << 28


# ----------------------------------------------------------------------
# Batched trial machinery
# ----------------------------------------------------------------------

def _trial_chi2(profs, trial_shifts, prof_avg: float, prof_var: float,
                device) -> np.ndarray:
    """profs [n, L]; trial_shifts [ntrial, n] (host, float32 on the
    device).  For each trial, the reduced chi2 of the sum of the shifted
    profiles -> float32 [ntrial] on the host."""
    p = fo.to_f32(profs, device)
    n, L = p.shape
    shifts = fo.to_f32(trial_shifts, device)
    avg = torch.tensor(prof_avg, dtype=torch.float32, device=device)
    var = torch.tensor(prof_var, dtype=torch.float32, device=device)
    per = max(1, TRIAL_CHUNK_BYTES // (n * L * 8))
    out = []
    for t0 in range(0, shifts.shape[0], per):
        tot = fo.rotate_sum(p, shifts[t0:t0 + per])        # [t, L]
        dev = tot - avg
        out.append((dev * dev).sum(dim=-1) / var / (L - 1))
    return torch.cat(out).cpu().numpy()


def _trial_total(profs, shifts, device) -> np.ndarray:
    """The summed profile of one trial (profs [n, L], shifts [n]), or of
    each stacked fold (profs [J, n, L], shifts [J, n]) -> float32 [L] or
    [J, L] on the host."""
    return fo.rotate_sum(fo.to_f32(profs, device),
                         fo.to_f32(shifts, device)).cpu().numpy()


# ----------------------------------------------------------------------
# Configuration & results
# ----------------------------------------------------------------------

@dataclass
class FoldConfig:
    """prepfold knobs (clig/prepfold_cmd.cli defaults)."""
    proflen: int = 64
    npart: int = 64
    nsub: int = 32
    pstep: int = 1          # period-search step, profile bins
    pdstep: int = 2
    dmstep: int = 1
    npfact: int = 1         # search +/- npfact*proflen/2 steps
    ndmfact: int = 2
    search_p: bool = True
    search_pd: bool = True
    search_dm: bool = True
    search_pdd: bool = False  # add the p-dotdot axis (-searchpdd;
                              # same trial ladder as pd,
                              # prepfold.c:1486-1502)


@dataclass
class FoldResult:
    cube: np.ndarray                 # [npart, nsub, proflen] float64
    stats: np.ndarray                # [npart, nsub, 7] foldstats rows
    fold_f: float
    fold_fd: float
    fold_fdd: float
    fold_dm: float
    dt: float
    T: float
    tepoch: float = 0.0
    subfreqs: Optional[np.ndarray] = None   # [nsub] MHz centers
    lofreq: float = 0.0
    chan_wid: float = 0.0
    numchan: int = 1
    data_avg: float = 0.0
    data_var: float = 1.0
    # search products
    dms: np.ndarray = field(default_factory=lambda: np.zeros(1))
    dm_chi2: np.ndarray = field(default_factory=lambda: np.zeros(1))
    periods: np.ndarray = field(default_factory=lambda: np.zeros(1))
    pdots: np.ndarray = field(default_factory=lambda: np.zeros(1))
    ppd_chi2: np.ndarray = field(default_factory=lambda: np.zeros((1, 1)))
    best_dm: float = 0.0
    best_f: float = 0.0
    best_fd: float = 0.0
    best_fdd: float = 0.0
    fdds: np.ndarray = field(default_factory=lambda: np.zeros(1))
    fdd_chi2: np.ndarray = field(default_factory=lambda: np.zeros(1))
    best_prof: Optional[np.ndarray] = None
    best_redchi: float = 0.0

    @property
    def npart(self) -> int:
        return self.cube.shape[0]

    @property
    def nsub(self) -> int:
        return self.cube.shape[1]

    @property
    def proflen(self) -> int:
        return self.cube.shape[2]

    @property
    def best_p(self) -> float:
        return 1.0 / self.best_f

    @property
    def best_pd(self) -> float:
        return -self.best_fd / (self.best_f * self.best_f)

    def part_mid_times(self) -> np.ndarray:
        numdata = self.stats[:, 0, 0]
        starts = np.concatenate([[0.0], np.cumsum(numdata)[:-1]])
        return (starts + 0.5 * numdata) * self.dt


# ----------------------------------------------------------------------
# Folding drivers
# ----------------------------------------------------------------------

def fold_subband_series(series: np.ndarray, dt: float, f: float,
                        fd: float = 0.0, fdd: float = 0.0,
                        cfg: Optional[FoldConfig] = None,
                        fold_dm: float = 0.0,
                        subfreqs: Optional[np.ndarray] = None,
                        tepoch: float = 0.0, phs0: float = 0.0,
                        delays: Optional[np.ndarray] = None,
                        delaytimes: Optional[np.ndarray] = None,
                        precomputed=None, device="cuda") -> FoldResult:
    """Fold [nsub, N] (or [N] -> nsub=1) subband series into the cube on
    ``device``.

    The phase model is evaluated once (all subbands share it); each
    (part, sub) profile's foldstats mirror the reference's per-fold
    bookkeeping (prepfold.c:1376-1394).  phs0 offsets the profile;
    delays/delaytimes inject extra time delays (seconds, piecewise
    linear).  ``precomputed`` is (plan, cube, occ) from a batched caller
    (fold_series_batch): the drizzles are skipped and the host
    bookkeeping runs unchanged, so results stay bit-identical.
    """
    cfg = cfg or FoldConfig()
    arr = np.atleast_2d(np.asarray(series, dtype=np.float32))
    nsub, N = arr.shape
    if precomputed is not None:
        plan, cube, occ = precomputed
    else:
        plan = fo.plan_fold(N, dt, f, fd, fdd, phs0=phs0,
                            proflen=cfg.proflen, npart=cfg.npart,
                            delays=delays, delaytimes=delaytimes)
        cube = fo.fold_data(arr, plan, device)        # [npart, nsub, L]
    # occupancy correction: when the fold frequency resonates with the
    # sample grid, per-bin sample counts quantize unevenly and the data
    # baseline imprints a step pattern ~avg*(count-N/L); folding a
    # ones-array gives the exact per-bin occupancy, and the baseline is
    # flattened to the uniform expectation (the chi2 model's assumption)
    if precomputed is None:
        occ = fo.fold_data(np.ones(N, np.float32), plan, device)
    stats = np.zeros((cfg.npart, nsub, 7), dtype=np.float64)
    for p in range(cfg.npart):
        nd = plan.parts_numdata[p]
        lo = int(plan.parts_numdata[:p].sum())
        seg = arr[:, lo:lo + int(nd)]
        occ_dev = occ[p] - nd / cfg.proflen
        for s in range(nsub):
            seg_avg = float(seg[s].mean())
            cube[p, s] -= seg_avg * occ_dev
            st = fo.fold_stats(cube[p, s], nd, seg_avg,
                               float(seg[s].var()))
            stats[p, s] = st.to_array()
    return FoldResult(cube=cube, stats=stats, fold_f=f, fold_fd=fd,
                      fold_fdd=fdd, fold_dm=fold_dm, dt=dt, T=N * dt,
                      tepoch=tepoch, subfreqs=subfreqs,
                      data_avg=float(arr.mean()),
                      data_var=float(arr.var()))


def fold_events(events_sec: np.ndarray, f: float, fd: float = 0.0,
                fdd: float = 0.0, cfg: Optional[FoldConfig] = None,
                fold_dm: float = 0.0, tepoch: float = 0.0,
                phs0: float = 0.0, T: Optional[float] = None,
                delays: Optional[np.ndarray] = None,
                delaytimes: Optional[np.ndarray] = None) -> FoldResult:
    """Fold an EVENT list (photon arrival times, seconds from tepoch):
    the reference's -events mode (prepfold.c:1012-1067), a host
    histogram of each event's phase.  Poisson statistics: the per-(part,
    bin) expectation is the part's event rate, variance equal to the
    mean, so the same chi2 search applies."""
    cfg = cfg or FoldConfig()
    ev = np.sort(np.asarray(events_sec, np.float64))
    if T is None:
        T = float(ev[-1]) if ev.size else 1.0
    if delays is not None:
        ev = ev - np.interp(ev, delaytimes, delays)
    phases = fo.fold_phase(ev, f, fd, fdd, phs0)
    L, npart = cfg.proflen, cfg.npart
    bins = (np.floor(phases * L).astype(np.int64)) % L
    parts = np.minimum((ev / (T / npart)).astype(np.int64), npart - 1)
    cube = np.zeros((npart, 1, L))
    np.add.at(cube, (parts, 0, bins), 1.0)
    stats = np.zeros((npart, 1, 7))
    part_T = T / npart
    for p in range(npart):
        n = float(cube[p, 0].sum())
        # pseudo numdata: one "sample" per profile bin per part keeps
        # part_mid_times uniform; avg=var=n/L is the Poisson rate
        stats[p, 0] = (L, n / L, max(n / L, 1e-10), 0, 0, 0, 0)
    return FoldResult(cube=cube, stats=stats, fold_f=f, fold_fd=fd,
                      fold_fdd=fdd, fold_dm=fold_dm, dt=part_T / L,
                      T=T, tepoch=tepoch,
                      data_avg=float(ev.size) / (npart * L),
                      data_var=max(float(ev.size) / (npart * L), 1e-10))


# ----------------------------------------------------------------------
# Stacked folding
# ----------------------------------------------------------------------

def fold_series_batch(items, device="cuda", obs=None) -> List[FoldResult]:
    """Fold J one-dimensional series in stacked drizzles on ``device``.

    ``items``: [(series, dt, f, fd, fdd, cfg, fold_dm, tepoch)]; every
    item shares the series length, cfg.proflen, cfg.npart and the
    drizzle subdivision (the fold stack signature).  One drizzle folds
    all the data rows, one more the occupancy rows, and the per-item
    bookkeeping is fold_subband_series itself (its ``precomputed``
    seam), so each FoldResult is bit-identical to the unbatched call.
    The two drizzles are booked on ``obs`` (obs/devtel) as the JAX
    package books its two dispatches: ``fold`` alone, ``fold_batch``
    stacked."""
    from presto_tpu_torch.obs import devtel
    plans = [fo.plan_fold(np.asarray(s).shape[-1], dt, f, fd, fdd,
                          proflen=cfg.proflen, npart=cfg.npart)
             for (s, dt, f, fd, fdd, cfg, _dm, _ep) in items]
    if len(items) == 1:
        (s, dt, f, fd, fdd, cfg, dm, ep) = items[0]
        devtel.note_dispatch(obs, "fold", 2)
        return [fold_subband_series(s, dt, f, fd, fdd, cfg, fold_dm=dm,
                                    tepoch=ep, device=device)]
    devtel.note_dispatch(obs, "fold_batch", 2)
    cubes = fo.fold_data_batch([s for (s, *_rest) in items], plans, device)
    occs = fo.fold_data_batch(
        [np.ones(np.asarray(s).shape[-1], np.float32)
         for (s, *_rest) in items], plans, device)
    out = []
    for (s, dt, f, fd, fdd, cfg, dm, ep), plan, cube, occ in zip(
            items, plans, cubes, occs):
        out.append(fold_subband_series(
            s, dt, f, fd, fdd, cfg, fold_dm=dm, tepoch=ep,
            precomputed=(plan, cube[:, None, :], occ), device=device))
    return out


def finish_fold_nosearch(results: List[FoldResult],
                         device="cuda", obs=None) -> List[FoldResult]:
    """search_fold's ``-nosearch`` endgame for a whole stack: a
    profile-total a fold fills each result's best summed profile; the
    other search fields take the single-trial values search_fold sets
    when every axis is off (best_* = fold values, one-entry
    period/pdot/dm arrays).  The chi2 surfaces are left at zeros.  Each
    total is the unstacked call's own ([npart, L] through _trial_total):
    on a card the sum over the parts of one [J, npart, L] tensor reduces
    in an order that depends on J (at J = 8 its .pfd bytes differed from
    a lone fold's), so a stacked total would not be bit-identical.  Each
    total is booked on ``obs`` as a ``fold_total``."""
    from presto_tpu_torch.obs import devtel
    if not results:
        return results
    for res in results:
        if res.nsub != 1:
            raise ValueError("finish_fold_nosearch: nsub must be 1")
        res.dms = np.array([res.fold_dm])
        res.dm_chi2 = np.zeros(1)
        res.best_dm = res.fold_dm
        res.best_f = res.fold_f - 0.0
        res.best_fd = res.fold_fd - 0.0
        res.best_fdd = res.fold_fdd - 0.0
        res.fdds = res.fold_fdd - np.zeros(1)
        res.fdd_chi2 = np.zeros(1)
        res.ppd_chi2 = np.zeros((1, 1))
        res.periods = np.array([1.0 / res.fold_f])
        res.pdots = np.array([res.best_pd])
    shifts = np.zeros(results[0].npart, np.float32)
    devtel.note_dispatch(obs, "fold_total", len(results))
    totals = [_trial_total(r.cube[:, 0, :], shifts, device)
              for r in results]
    for res, tot in zip(results, totals):
        res.best_prof = tot.astype(np.float64)
        Ntot = float(res.stats[:, 0, 0].sum())
        prof_avg = res.data_avg * Ntot * res.nsub / res.proflen
        prof_var = res.data_var * Ntot * res.nsub / res.proflen
        res.best_redchi = float(fo.profile_redchi(
            res.best_prof, prof_avg, prof_var))
    return results


# ----------------------------------------------------------------------
# The search
# ----------------------------------------------------------------------

def dm_per_bin(f: float, proflen: int, lofreq: float,
               hifreq: float) -> float:
    """DM change that moves the band-edge differential delay by one
    profile bin."""
    dd = delay_from_dm(1.0, lofreq) - delay_from_dm(1.0, hifreq)
    return 1.0 / (f * proflen * dd)


def search_fold(res: FoldResult, cfg: Optional[FoldConfig] = None,
                device="cuda") -> FoldResult:
    """Grid-search (DM, f, fd) around the fold values on ``device``,
    maximizing the summed-profile reduced chi2.  Fills the search fields
    of `res`."""
    cfg = cfg or FoldConfig(proflen=res.proflen, npart=res.npart,
                            nsub=res.nsub)
    L, npart, nsub = res.proflen, res.npart, res.nsub
    Ntot = float(res.stats[:, 0, 0].sum())
    # pooled expectations for the FULL summed profile (all parts+subs)
    prof_avg = res.data_avg * Ntot * nsub / L
    prof_var = res.data_var * Ntot * nsub / L
    tmid = res.part_mid_times()

    # ---- stage 1: DM --------------------------------------------------
    if cfg.search_dm and nsub > 1 and res.subfreqs is not None:
        numdms = 4 * L * cfg.ndmfact + 1
        ddm = cfg.dmstep * dm_per_bin(res.fold_f, L,
                                      res.subfreqs.min(),
                                      res.subfreqs.max())
        dms = res.fold_dm + (np.arange(numdms) - numdms // 2) * ddm
        dms = dms[dms >= 0.0] if res.fold_dm > 0 else dms
        shifts = np.stack([fo.subband_fold_shifts(
            res.subfreqs, dm, res.fold_dm, res.fold_f, L)
            for dm in dms])                        # [numdms, nsub]
        psum = res.cube.sum(axis=0)                # [nsub, L]
        chi2 = _trial_chi2(psum, shifts, prof_avg, prof_var, device)
        best = int(np.argmax(chi2))
        res.dms, res.dm_chi2 = dms, chi2
        res.best_dm = float(dms[best])
    else:
        res.dms = np.array([res.fold_dm])
        res.dm_chi2 = np.zeros(1)
        res.best_dm = res.fold_dm

    # dedisperse the cube at the best DM -> [npart, L]
    if nsub > 1 and res.subfreqs is not None:
        dshift = fo.subband_fold_shifts(res.subfreqs, res.best_dm,
                                        res.fold_dm, res.fold_f, L)
        ddprofs = fo.combine_subbands(res.cube, dshift, device)
    else:
        ddprofs = res.cube[:, 0, :]

    # ---- stage 2: (f, fd[, fdd]) -------------------------------------
    nf = 2 * L * cfg.npfact + 1 if cfg.search_p else 1
    nfd = 2 * L * cfg.npfact + 1 if cfg.search_pd else 1
    nfdd = 2 * L * cfg.npfact + 1 if cfg.search_pdd else 1
    df = cfg.pstep / (L * res.T)
    dfd = cfg.pdstep * 2.0 / (L * res.T * res.T)
    # pdd trials reuse the pd step ladder (prepfold.c:1486): one bin of
    # end-of-obs phase delay per pdstep, dfdd = 6*dphase/T^3
    dfdd = cfg.pdstep * 6.0 / (L * res.T ** 3)
    fs = (np.arange(nf) - nf // 2) * df            # offsets from fold_f
    fds = (np.arange(nfd) - nfd // 2) * dfd
    fdds = (np.arange(nfdd) - nfdd // 2) * dfdd
    # phase shift of part p for trial (df, dfd, dfdd):
    #   dphi(t_p) = df*t_p + dfd*t_p^2/2 + dfdd*t_p^3/6 (turns) -> bins;
    # the aligning trial is the negative of the signal offset, so the
    # reported best model is fold - trial
    off2 = (fs[:, None, None] * tmid[None, None, :]
            + 0.5 * fds[None, :, None] * tmid[None, None, :] ** 2) * L
    chi2_cube = np.empty((nf, nfd, nfdd), np.float64)
    for k in range(nfdd):
        off = off2 + (fdds[k] * tmid[None, None, :] ** 3 / 6.0) * L
        chi2_cube[:, :, k] = _trial_chi2(
            ddprofs, off.reshape(nf * nfd, npart), prof_avg, prof_var,
            device).reshape(nf, nfd)
    bi, bj, bk = np.unravel_index(np.argmax(chi2_cube), chi2_cube.shape)
    res.best_f = res.fold_f - float(fs[bi])
    res.best_fd = res.fold_fd - float(fds[bj])
    res.best_fdd = res.fold_fdd - float(fdds[bk])
    res.fdds = res.fold_fdd - fdds
    res.fdd_chi2 = chi2_cube[bi, bj, :]
    res.ppd_chi2 = chi2_cube[:, :, bk]
    off = off2 + (fdds[bk] * tmid[None, None, :] ** 3 / 6.0) * L
    # ascending AND index-matched with ppd_chi2 rows: row i's model
    # period is 1/(fold_f - fs[i])
    res.periods = 1.0 / (res.fold_f - fs) if cfg.search_p \
        else np.array([1.0 / res.fold_f])
    with np.errstate(divide="ignore"):
        res.pdots = np.where(
            res.fold_f != 0.0,
            -(res.fold_fd - fds) / (res.fold_f ** 2), 0.0) \
            if cfg.search_pd else np.array([res.best_pd])

    res.best_prof = _trial_total(ddprofs, off[bi, bj],
                                 device).astype(np.float64)
    res.best_redchi = float(fo.profile_redchi(res.best_prof, prof_avg,
                                              prof_var))
    return res


# ----------------------------------------------------------------------
# Fold error estimates (fold_errors, fold.c:182 analog)
# ----------------------------------------------------------------------

def fold_errors(res: FoldResult, device="cuda") -> Tuple[float, float]:
    """(p_err, pd_err) from the per-part phase-drift fit: each part
    profile (dedispersed on ``device``, best-model-aligned) against the
    summed template through the profile FFT's fundamental phase, then a
    weighted quadratic lstsq of phase vs part mid-time (host float64)."""
    if res.best_prof is None:
        raise ValueError("run search_fold first")
    L = res.proflen
    if res.nsub > 1 and res.subfreqs is not None:
        dshift = fo.subband_fold_shifts(res.subfreqs, res.best_dm,
                                        res.fold_dm, res.fold_f, L)
        parts = fo.combine_subbands(res.cube, dshift, device)
    else:
        parts = res.cube[:, 0, :]
    tmid = res.part_mid_times()
    # align parts to the best model (the aligning left-rotation is the
    # NEGATIVE of the model offset, see search_fold)
    df = res.best_f - res.fold_f
    dfd = res.best_fd - res.fold_fd
    off = -(df * tmid + 0.5 * dfd * tmid ** 2) * L
    parts = np.stack([fo.shift_prof(parts[i], off[i])
                      for i in range(len(parts))])
    tpl = np.fft.rfft(res.best_prof)
    phases, weights = [], []
    for prof in parts:
        F = np.fft.rfft(prof)
        # fundamental-harmonic phase offset vs template (radians)
        x = F[1] * np.conj(tpl[1])
        amp = np.abs(F[1])
        phases.append(np.angle(x) / (2 * np.pi))   # turns
        weights.append(max(amp, 1e-12))
    phases = np.unwrap(np.asarray(phases), period=1.0)
    w = np.asarray(weights)
    # weighted quadratic fit: phi(t) = c0 + c1 t + c2 t^2
    A = np.stack([np.ones_like(tmid), tmid, tmid ** 2], axis=1)
    Aw = A * w[:, None]
    coef, *_ = np.linalg.lstsq(Aw, phases * w, rcond=None)
    resid = phases - A @ coef
    dof = max(len(tmid) - 3, 1)
    s2 = float((w * resid ** 2).sum() / w.sum()) * len(tmid) / dof
    cov = np.linalg.inv(Aw.T @ Aw) * s2 * float(w.mean() ** 2)
    ferr = np.sqrt(abs(cov[1, 1]))
    fderr = 2.0 * np.sqrt(abs(cov[2, 2]))
    f = res.best_f
    perr = ferr / (f * f)
    pderr = np.sqrt((fderr / f ** 2) ** 2
                    + (2 * res.best_fd * ferr / f ** 3) ** 2)
    return float(perr), float(pderr)
