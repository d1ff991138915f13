"""prepfold diagnostic plot (src/prepfold_plot.c analog), on PyTorch.

PyTorch counterpart of ``presto_tpu/plotting/pfdplot.py``: the famous
multi-panel .pfd plot, at reference panel parity (prepfold_plot.c:
1-1318): best profile over two periods, time-vs-phase greyscale with the
cumulative reduced-chi2 vs time curve, subband greyscale with the
reduced-chi2 vs DM curve, the chi2(p, pd) plane image with its marginal
chi2(p) / chi2(pd) curves, and the candidate info block.  Input is the
Pfd container (io/pfd.py) as written by apps/prepfold or read back from
disk; every curve is recomputed from the stored cube, so show_pfd
re-renders without the original data.

The module is in two halves.  ``pfd_panels`` computes the panels'
numbers on ``device`` and returns NumPy arrays: the chi2(P, Pdot) plane
by the fold search's own batched rotate-and-sum (search/prepfold
._trial_chi2, float32), the DM curve by one batched rotate-and-sum of the
subband profiles at every trial DM (ops/fold.rotate_sum, float32; the
reduced chi2 of each summed profile on the host in float64, as the JAX
package computes it), and the chi2 growth curve as float64 cumulative
sums.  It needs no matplotlib.  ``plot_pfd`` draws them and needs
matplotlib (``plotting.pyplot`` raises ImportError naming it).

Plot flags mirror the reference's pflags (prepfold.h):
scaleparts, allgrey, justprofs, fixchi, portrait.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.io.pfd import Pfd, pfd_subfreqs
from presto_tpu_torch.ops import fold as fo
from presto_tpu_torch.ops.fold import profile_redchi


@dataclass
class PlotFlags:
    scaleparts: bool = False     # scale part profiles independently
    allgrey: bool = False        # greyscale images (no color)
    justprofs: bool = False      # only the profile portions
    fixchi: bool = False         # scale so off-pulse reduced chi2 = 1
    portrait: bool = False       # portrait orientation


def _two_periods(prof: np.ndarray) -> np.ndarray:
    return np.concatenate([prof, prof])


def _expected_stats(p: Pfd):
    """Expected (avg, var) per profile bin of the fully summed profile,
    from the per-(part,sub) fold stats (fold.c:655-660 convention:
    stats rows are (numdata, data_avg, data_var, ...))."""
    numdata = np.asarray(p.stats[:, :, 0], float)
    data_avg = np.asarray(p.stats[:, :, 1], float)
    data_var = np.asarray(p.stats[:, :, 2], float)
    prof_avg = float((data_avg * numdata).sum() / p.proflen)
    prof_var = float((data_var * numdata).sum() / p.proflen)
    return prof_avg, prof_var


def _dm_chi2_curve(p: Pfd, svph: np.ndarray, device) -> np.ndarray:
    """Reduced chi^2 of the summed profile at each trial DM, rotating
    subbands from the fold DM (prepfold_plot.c DM curve semantics).
    Every DM's rotate-and-sum runs in one batched call on ``device``."""
    from presto_tpu_torch.search.prepfold import TRIAL_CHUNK_BYTES

    subfreqs = pfd_subfreqs(p)
    prof_avg, prof_var = _expected_stats(p)
    dms = np.asarray(p.dms, float)
    shifts = np.stack([fo.subband_fold_shifts(subfreqs, dm, p.bestdm,
                                              p.fold_p1, p.proflen)
                       for dm in dms])                  # [numdms, nsub]
    sv = fo.to_f32(svph, device)
    sh = fo.to_f32(shifts, device)
    per = max(1, TRIAL_CHUNK_BYTES // (sv.numel() * 8))
    profs = torch.cat([fo.rotate_sum(sv, sh[i:i + per])
                       for i in range(0, len(dms), per)])
    profs = profs.cpu().numpy().astype(np.float64)      # [numdms, L]
    chis = np.zeros(len(dms))
    for i, prof in enumerate(profs):
        if prof_var > 0:
            chis[i] = profile_redchi(prof, prof_avg, prof_var)
        elif prof.var() > 0:        # no stats stored: normalize shape
            chis[i] = profile_redchi(prof, prof.mean(), prof.var())
    return chis


def _part_times(p: Pfd) -> np.ndarray:
    numdata = np.asarray(p.stats[:, 0, 0], float)
    starts = np.concatenate([[0.0], np.cumsum(numdata)[:-1]])
    return (starts + 0.5 * numdata) * p.dt


def _ppd_chi2_plane(p: Pfd, tvph: np.ndarray, device) -> np.ndarray:
    """chi2 over the stored (periods, pdots) grids, recomputed from the
    cube by rotate-and-sum exactly like the search (so show_pfd can
    re-render the plane without the original data), through the
    search's batched trial machinery on ``device``."""
    from presto_tpu_torch.search.prepfold import _trial_chi2

    prof_avg, prof_var = _expected_stats(p)
    if prof_var <= 0:
        prof_avg, prof_var = float(tvph.mean()), float(tvph.var())
        prof_var *= tvph.shape[0]
    tmid = _part_times(p)
    L = p.proflen
    fold_f = p.fold_p1
    fs = fold_f - 1.0 / np.asarray(p.periods, float)   # trial offsets
    with np.errstate(divide="ignore", invalid="ignore"):
        fds_model = -(np.asarray(p.pdots, float)) * fold_f ** 2
    fds = p.fold_p2 - fds_model
    off = (fs[:, None, None] * tmid[None, None, :]
           + 0.5 * fds[None, :, None] * tmid[None, None, :] ** 2) * L
    return _trial_chi2(tvph, off.reshape(-1, tmid.size), prof_avg,
                       prof_var, device).reshape(fs.size, fds.size)


def _chi2_vs_time(p: Pfd, tvph: np.ndarray, device) -> np.ndarray:
    """Cumulative reduced chi2 after each sub-integration
    (prepfold_plot.c's chi-squared growth curve): float64 cumulative
    sums of the part profiles and of their expectations on ``device``."""
    numdata = np.asarray(p.stats[:, :, 0], float)
    data_avg = np.asarray(p.stats[:, :, 1], float)
    data_var = np.asarray(p.stats[:, :, 2], float)
    L, L1 = p.proflen, max(p.proflen - 1, 1)
    n = tvph.shape[0]
    davg = [float((data_avg[k] * numdata[k]).sum() / L) for k in range(n)]
    dvar = [float((data_var[k] * numdata[k]).sum() / L) for k in range(n)]
    f64 = dict(dtype=torch.float64, device=device)
    tot = torch.cumsum(torch.as_tensor(tvph, **f64), 0)
    avg = torch.cumsum(torch.tensor(davg, **f64), 0)
    var = torch.cumsum(torch.tensor(dvar, **f64), 0)
    dev = tot - avg[:, None]
    chi = (dev * dev).sum(dim=-1) / var / L1
    return torch.where(var > 0, chi, 0.0).cpu().numpy()


def pfd_panels(p: Pfd, device="cuda") -> dict:
    """The numbers behind plot_pfd's panels, computed on ``device`` (CUDA
    unless the caller asks for the CPU), as NumPy arrays: ``prof_avg``
    and ``prof_var`` (the summed profile's expectations), ``part_times``
    (s), ``growth`` (the reduced chi2 after each part), ``dm_chi2`` (the
    reduced chi2 at each of ``p.dms``; None with one DM or one subband)
    and ``plane`` (chi2 over ``p.periods`` x ``p.pdots``; None unless
    both grids have more than one entry)."""
    from presto_tpu_torch.search.accel import resolve_device

    dev = resolve_device(device)
    profs = np.asarray(p.profs, float)          # [npart, nsub, proflen]
    tvph = profs.sum(axis=1)                    # [npart, proflen]
    svph = profs.sum(axis=0)                    # [nsub, proflen]
    prof_avg, prof_var = _expected_stats(p)
    out = dict(prof_avg=prof_avg, prof_var=prof_var,
               part_times=_part_times(p),
               growth=_chi2_vs_time(p, tvph, dev), dm_chi2=None,
               plane=None)
    if np.asarray(p.dms).size > 1 and profs.shape[1] > 1:
        out["dm_chi2"] = _dm_chi2_curve(p, svph, dev)
    if np.asarray(p.periods).size > 1 and np.asarray(p.pdots).size > 1:
        out["plane"] = _ppd_chi2_plane(p, tvph, dev)
    return out


def plot_pfd(p: Pfd, outfile: str,
             best_prof: Optional[np.ndarray] = None,
             flags: Optional[PlotFlags] = None, device="cuda") -> str:
    """Draw the .pfd plot to ``outfile``; the panels' numbers come from
    pfd_panels on ``device``."""
    from presto_tpu_torch.plotting import pyplot

    plt = pyplot("the .pfd plot")
    flags = flags or PlotFlags()
    profs = np.asarray(p.profs, float)          # [npart, nsub, proflen]
    npart, nsub, proflen = profs.shape
    tvph = profs.sum(axis=1)                    # [npart, proflen]
    svph = profs.sum(axis=0)                    # [nsub, proflen]
    if best_prof is None:
        best_prof = profs.sum(axis=(0, 1))
    cmap = "gray_r" if flags.allgrey else "viridis"

    prof_avg, prof_var = _expected_stats(p)
    if prof_var <= 0:               # no stats stored: normalize shape
        prof_avg, prof_var = best_prof.mean(), best_prof.var()
    chifact = 1.0
    if flags.fixchi and prof_var > 0:
        # scale variances so the off-pulse reduced chi2 becomes 1
        # (reference -fixchi): estimate off-pulse from the lowest
        # half of the best profile's bins
        order = np.argsort(best_prof)
        off = best_prof[order[:proflen // 2]]
        offchi = float(((off - prof_avg) ** 2).mean() / prof_var) \
            * proflen / max(proflen - 1, 1)
        if offchi > 0:
            chifact = 1.0 / offchi

    def redchi(prof, avg, var):
        return (profile_redchi(prof, avg, var) * chifact
                if var > 0 else 0.0)

    tvph_img = tvph
    if flags.scaleparts:
        lo = tvph.min(axis=1, keepdims=True)
        span = np.ptp(tvph, axis=1, keepdims=True)
        span[span == 0] = 1.0
        tvph_img = (tvph - lo) / span

    if flags.justprofs:
        fig = plt.figure(figsize=(7, 9))
        gs = fig.add_gridspec(3, 1, hspace=0.35)
        ax = fig.add_subplot(gs[0, 0])
        x = np.arange(2 * proflen) / proflen
        ax.plot(x, _two_periods(best_prof), "k-", lw=1)
        ax.set_xlim(0, 2)
        ax.set_xlabel("Phase")
        ax.set_title("2 pulses of best profile")
        ax = fig.add_subplot(gs[1:, 0])
        ax.imshow(np.tile(tvph_img, (1, 2)), aspect="auto",
                  origin="lower", cmap=cmap, extent=[0, 2, 0, npart])
        ax.set_xlabel("Phase")
        ax.set_ylabel("Sub-integration")
        fig.suptitle("%s" % (p.candnm or p.filenm), fontsize=11)
        fig.savefig(outfile, dpi=100)
        plt.close(fig)
        return outfile

    panels = pfd_panels(p, device)
    figsize = (8, 10.5) if flags.portrait else (11.5, 8)
    fig = plt.figure(figsize=figsize)
    gs = fig.add_gridspec(6, 4, hspace=1.1, wspace=0.55)

    # -- best profile (2 periods) -------------------------------------
    ax = fig.add_subplot(gs[0:2, 0:2])
    x = np.arange(2 * proflen) / proflen
    ax.plot(x, _two_periods(best_prof), "k-", lw=1)
    ax.set_xlim(0, 2)
    ax.set_xticklabels([])
    ax.set_title("2 pulses of best profile", fontsize=9)

    # -- time vs phase + chi2 growth ----------------------------------
    ax = fig.add_subplot(gs[2:6, 0])
    ax.imshow(np.tile(tvph_img, (1, 2)), aspect="auto", origin="lower",
              cmap=cmap, extent=[0, 2, 0, npart])
    ax.set_xlabel("Phase")
    ax.set_ylabel("Sub-integration (time)")
    ax = fig.add_subplot(gs[2:6, 1])
    growth = panels["growth"] * chifact
    ax.plot(growth, np.arange(npart) + 1, "k-")
    ax.set_xlabel(r"Reduced $\chi^2$")
    ax.set_ylabel("Sub-integration")
    ax.set_ylim(0, npart)
    ax.set_title(r"$\chi^2$ growth", fontsize=9)

    # -- subbands + DM curve ------------------------------------------
    ax = fig.add_subplot(gs[2:6, 2])
    if nsub > 1:
        ax.imshow(np.tile(svph, (1, 2)), aspect="auto", origin="lower",
                  cmap=cmap, extent=[0, 2, 0, nsub])
        ax.set_ylabel("Subband")
    else:
        ax.text(0.5, 0.5, "1 subband", ha="center")
    ax.set_xlabel("Phase")
    ax = fig.add_subplot(gs[0:2, 2])
    dms = np.asarray(p.dms, float)
    if panels["dm_chi2"] is not None:
        ax.plot(dms, panels["dm_chi2"] * chifact, "k-")
    ax.set_xlabel("DM (pc cm$^{-3}$)", fontsize=8)
    ax.set_ylabel(r"Reduced $\chi^2$", fontsize=8)
    ax.tick_params(labelsize=7)

    # -- p-pd plane + marginals ---------------------------------------
    periods = np.asarray(p.periods, float)
    pdots = np.asarray(p.pdots, float)
    have_plane = panels["plane"] is not None
    if have_plane:
        plane = panels["plane"] * chifact
        pms = (periods - np.median(periods)) * 1e3
        pdm = pdots - np.median(pdots)
        ax = fig.add_subplot(gs[3:6, 3])
        ax.imshow(plane.T, aspect="auto", origin="lower", cmap=cmap,
                  extent=[pms[0], pms[-1], pdm[0], pdm[-1]])
        ax.set_xlabel("P - P$_{med}$ (ms)", fontsize=8)
        ax.set_ylabel(r"$\dot P$ - $\dot P_{med}$", fontsize=8)
        ax.tick_params(labelsize=7)
        ax = fig.add_subplot(gs[1:2, 3])
        ax.plot(pms, plane.max(axis=1), "k-")
        ax.set_xlabel("P - P$_{med}$ (ms)", fontsize=7)
        ax.set_ylabel(r"$\chi^2$", fontsize=7)
        ax.tick_params(labelsize=6)
        ax = fig.add_subplot(gs[2:3, 3])
        ax.plot(pdm, plane.max(axis=0), "k-")
        ax.set_xlabel(r"$\dot P$ - $\dot P_{med}$", fontsize=7)
        ax.set_ylabel(r"$\chi^2$", fontsize=7)
        ax.tick_params(labelsize=6)

    # -- info block ----------------------------------------------------
    ax = fig.add_subplot(gs[0:1, 3]) if have_plane \
        else fig.add_subplot(gs[0:3, 3])
    ax.axis("off")
    rc = redchi(best_prof, prof_avg, prof_var)
    from presto_tpu_torch.utils.psr import f_to_p
    bp, bpd, bpdd = f_to_p(p.fold_p1, p.fold_p2, p.fold_p3)
    info = [
        "Cand: %s" % (p.candnm or "?"),
        "Telescope: %s" % p.telescope,
        "Epoch$_{topo}$ = %.9f" % p.tepoch,
        "p = %.9g s   pd = %.4g" % (bp, bpd),
        "f = %.9g Hz  fd = %.4g" % (p.fold_p1, p.fold_p2),
        "pdd = %.4g" % bpdd,
        "DM = %.3f" % p.bestdm,
        r"$\chi^2_{red}$ = %.2f" % float(np.atleast_1d(rc)[0]),
    ]
    ax.text(0.0, 1.0, "\n".join(info), va="top", fontsize=7,
            family="monospace")

    fig.suptitle("%s  (%s)" % (p.candnm or p.filenm, "presto_tpu"),
                 fontsize=11)
    fig.savefig(outfile, dpi=100)
    plt.close(fig)
    return outfile
