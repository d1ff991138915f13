"""Phase-exact folding: host phase planning, device drizzle (PyTorch).

PyTorch counterpart of ``presto_tpu/ops/fold.py``.

Parity targets (behavioral):
  fold            fold.c:490-688  phase-drizzle folding with (f,fd,fdd)
  simplefold      fold.c:445
  shift_prof      fold.c:697
  combine_profs   fold.c:737      fractional-shift profile summation
  combine_subbands dispersion.c:232-287 (profile-domain dedispersion)
  foldstats       include/presto.h:262-270

Phases are planned on the host in float64 (plan_fold, the JAX
package's code): each sample is a boxcar, subdivided so every piece
spans at most one profile bin and split exactly between its two bins.
The drizzle then adds every piece's weighted value into its bins.

Add order.  The JAX package drizzles with two XLA scatter-adds, all
``b0`` updates then all ``b1`` updates, which the CPU applies in update
order.  Here a CPU tensor takes ``index_add_`` over the concatenated
updates (the same order, bit for bit); a CUDA tensor never takes
``index_add_``, ``scatter_add_`` or ``index_put_(accumulate=True)``,
whose atomics add in a different order on every run.  It lays each
output bin's updates out in update order instead (a stable sort of the
bins: the bin's ``b0`` updates, then its ``b1`` updates) and adds the
table's columns in ascending order from 0.0, padding adding +0.0: the
same sums as the scatter, deterministic and bit-equal to it.

Profile rotations and sums (rotate_sum, combine_profs,
combine_subbands) are two-tap linear-interpolation gathers on the
device in float32; their sums over profiles reduce in the device's
order, so they agree with the JAX package's within float32 rounding,
not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.ops.dedispersion import delay_from_dm


# ----------------------------------------------------------------------
# Host-side phase planning (float64)
# ----------------------------------------------------------------------

def fold_phase(t, f: float, fd: float = 0.0, fdd: float = 0.0,
               phs0: float = 0.0) -> np.ndarray:
    """Spin phase (turns) at time(s) t seconds (fold.c:600,637 poly)."""
    t = np.asarray(t, dtype=np.float64)
    return phs0 + t * (f + t * (fd / 2.0 + t * (fdd / 6.0)))


@dataclass
class FoldPlan:
    """Host-planned drizzle indices/weights for one data stream.

    b0/b1: int32 absolute bin indices into the flattened
    [npart * proflen] output (b1 is b0's wrap-around neighbor within
    the same part); w0/w1: float32 weights (w0 + w1 = value fraction of
    one original sample, i.e. 1/subdiv).
    """
    b0: np.ndarray
    b1: np.ndarray
    w0: np.ndarray
    w1: np.ndarray
    subdiv: int
    npart: int
    proflen: int
    parts_numdata: np.ndarray     # samples folded into each part


def plan_fold(N: int, dt: float, f: float, fd: float = 0.0,
              fdd: float = 0.0, phs0: float = 0.0, proflen: int = 64,
              npart: int = 1, tlo: float = 0.0,
              delays: Optional[np.ndarray] = None,
              delaytimes: Optional[np.ndarray] = None) -> FoldPlan:
    """Plan the drizzle for N samples starting at time tlo.

    delays/delaytimes: optional piecewise-linear extra phase DELAY in
    seconds sampled at `delaytimes` (fold.c:523-560): the phase used is
    phi(t - interp(delays)(t)).
    """
    # subdivision so each sub-boxcar spans <= 1 bin (use the max |dphi|
    # over the interval ends; fdot contributions are tiny per sample)
    fmax = max(abs(f), abs(f + fd * (tlo + N * dt)))
    span_bins = fmax * dt * proflen
    subdiv = max(1, int(np.ceil(span_bins)))
    S = subdiv

    edges = tlo + np.arange(N * S + 1, dtype=np.float64) * (dt / S)
    if delays is not None:
        edges = edges - np.interp(edges, delaytimes, delays)
    ph = fold_phase(edges, f, fd, fdd, phs0) * proflen   # bin units
    a = ph[:-1]
    d = ph[1:] - a
    # guard: negative or zero spans (pathological fd) -> point mass
    d = np.maximum(d, 1e-12)
    b0f = np.floor(a)
    # fraction of the boxcar falling into the NEXT bin
    w1 = np.clip((a + d - (b0f + 1.0)) / d, 0.0, 1.0)
    w0 = (1.0 - w1) / S
    w1 = w1 / S

    part_of = np.minimum((np.arange(N * S) // S) * npart // N,
                         npart - 1).astype(np.int64)
    b0 = (b0f.astype(np.int64) % proflen) + part_of * proflen
    b1 = ((b0f.astype(np.int64) + 1) % proflen) + part_of * proflen
    parts_numdata = np.bincount(
        np.minimum(np.arange(N) * npart // N, npart - 1),
        minlength=npart).astype(np.float64)
    return FoldPlan(b0=b0.astype(np.int32), b1=b1.astype(np.int32),
                    w0=w0.astype(np.float32), w1=w1.astype(np.float32),
                    subdiv=S, npart=npart, proflen=proflen,
                    parts_numdata=parts_numdata)


# ----------------------------------------------------------------------
# The drizzle
# ----------------------------------------------------------------------

def drizzle_plain(upd: torch.Tensor, bins: torch.Tensor,
                  nbins: int) -> torch.Tensor:
    """upd [C, M] float32 added into [C, nbins] at bins [M], in update
    order: ``index_add_``, which the CPU applies in that order."""
    if upd.device.type != "cpu":
        raise ValueError("drizzle_plain: index_add_ adds in update order "
                         "only on the CPU")
    out = torch.zeros((upd.shape[0], nbins), dtype=upd.dtype)
    return out.index_add_(1, bins, upd)


def bin_table(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """[K, nbins] int64 gather table: column j lists the updates that
    land in bin j in update order (a stable sort of ``bins``), padded
    with M, the index of a zero slot; K is the largest bin count."""
    M = bins.shape[0]
    order = torch.sort(bins, stable=True).indices
    counts = torch.bincount(bins, minlength=nbins)
    K = int(counts.max()) if M else 0
    starts = torch.cumsum(counts, 0) - counts
    sb = bins[order]
    pos = torch.arange(M, device=bins.device) - starts[sb]
    table = torch.full((K, nbins), M, dtype=torch.int64, device=bins.device)
    table[pos, sb] = order
    return table


def drizzle_ordered(upd: torch.Tensor, bins: torch.Tensor,
                    nbins: int) -> torch.Tensor:
    """The same sums as drizzle_plain on any device, with no atomics:
    each bin adds its updates one table row at a time, in update order,
    starting from 0.0 (padding adds +0.0)."""
    table = bin_table(bins, nbins)
    padded = torch.cat([upd, upd.new_zeros((upd.shape[0], 1))], dim=1)
    acc = upd.new_zeros((upd.shape[0], nbins))
    for row in table:
        acc = acc + torch.index_select(padded, 1, row)
    return acc


def _drizzle(upd: torch.Tensor, bins: torch.Tensor,
             nbins: int) -> torch.Tensor:
    """CPU tensors take drizzle_plain, CUDA tensors drizzle_ordered."""
    if upd.device.type == "cpu":
        return drizzle_plain(upd, bins, nbins)
    return drizzle_ordered(upd, bins, nbins)


def _updates(vals: torch.Tensor, b0, b1, w0, w1, subdiv: int):
    """The scatter's update stream: vals [C, T] repeated subdiv times per
    sample, times w0 then times w1, concatenated with their bins (b0
    then b1; the last axis of the plan arrays is the update axis)."""
    dev = vals.device
    if subdiv > 1:
        vals = torch.repeat_interleave(vals, subdiv, dim=-1)
    w0, w1 = (torch.as_tensor(w, device=dev) for w in (w0, w1))
    upd = torch.cat([vals * w0, vals * w1], dim=-1)
    bins = torch.cat([torch.as_tensor(b, device=dev).long()
                      for b in (b0, b1)], dim=-1)
    return upd, bins


def to_f32(data, device) -> torch.Tensor:
    """numpy or a tensor -> a float32 tensor on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(data, dtype=np.float32), device=device)


def fold_data(data, plan: FoldPlan, device):
    """Fold [C, N] (or [N]) data (numpy or a tensor) with a host plan on
    ``device``.

    Returns profiles [npart, C, proflen] float64 (or [npart, proflen]
    for 1-D input), bit-equal to the JAX package's fold_data.
    """
    arr = to_f32(data, device)
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[None, :]
    C = arr.shape[0]
    nbins = plan.npart * plan.proflen
    upd, bins = _updates(arr, plan.b0, plan.b1, plan.w0, plan.w1,
                         plan.subdiv)
    out = _drizzle(upd, bins, nbins)
    profs = out.cpu().numpy().astype(np.float64).reshape(
        C, plan.npart, plan.proflen).transpose(1, 0, 2)
    return profs[:, 0, :] if squeeze else profs


def fold_data_batch(rows, plans, device) -> np.ndarray:
    """Fold J one-dimensional series, each under its OWN plan, in one
    drizzle on ``device``.  All plans share (npart, proflen, subdiv) and
    every series the common length.  Returns float64 [J, npart,
    proflen] whose row j is bit-identical to fold_data(rows[j],
    plans[j])."""
    p0 = plans[0]
    if any(p.subdiv != p0.subdiv or p.npart != p0.npart
           or p.proflen != p0.proflen for p in plans):
        raise ValueError("fold_data_batch: plans differ in geometry")
    arr = torch.stack([to_f32(r, device) for r in rows])    # [J, T]
    J = arr.shape[0]
    nbins = p0.npart * p0.proflen
    # row j's bins move to [j * nbins, (j + 1) * nbins): one update
    # stream whose per-bin order is each row's own
    off = np.arange(J, dtype=np.int64)[:, None] * nbins
    upd, bins = _updates(arr, np.stack([p.b0 for p in plans]) + off,
                         np.stack([p.b1 for p in plans]) + off,
                         np.stack([p.w0 for p in plans]),
                         np.stack([p.w1 for p in plans]), p0.subdiv)
    out = _drizzle(upd.reshape(1, -1), bins.reshape(-1), J * nbins)
    return out.cpu().numpy().astype(np.float64).reshape(
        J, p0.npart, p0.proflen)


def simplefold(data: np.ndarray, dt: float, f: float, fd: float = 0.0,
               fdd: float = 0.0, phs0: float = 0.0,
               proflen: int = 64, tlo: float = 0.0,
               device="cuda") -> np.ndarray:
    """One-shot 1-D fold (fold.c:445)."""
    plan = plan_fold(len(data), dt, f, fd, fdd, phs0, proflen, 1, tlo)
    return fold_data(data, plan, device)[0]


# ----------------------------------------------------------------------
# Fold statistics (host)
# ----------------------------------------------------------------------

@dataclass
class FoldStats:
    """Parity: foldstats (presto.h:262-270)."""
    numdata: float = 0.0
    data_avg: float = 0.0
    data_var: float = 0.0
    numprof: float = 0.0
    prof_avg: float = 0.0
    prof_var: float = 0.0
    redchi: float = 0.0

    def to_array(self) -> np.ndarray:
        return np.array([self.numdata, self.data_avg, self.data_var,
                         self.numprof, self.prof_avg, self.prof_var,
                         self.redchi], dtype=np.float64)


def profile_redchi(prof: np.ndarray, prof_avg: float,
                   prof_var: float) -> float:
    """Reduced chi-squared of a profile against flat (fold.c:672-682
    semantics: uniform expected occupancy numdata/proflen per bin)."""
    if prof_var <= 0:
        return 0.0
    dev = prof - prof_avg
    return float((dev * dev).sum() / prof_var / (len(prof) - 1))


def fold_stats(prof: np.ndarray, numdata: float, data_avg: float,
               data_var: float) -> FoldStats:
    proflen = len(prof)
    prof_avg = data_avg * numdata / proflen
    prof_var = data_var * numdata / proflen
    return FoldStats(numdata=numdata, data_avg=data_avg,
                     data_var=data_var, numprof=float(proflen),
                     prof_avg=prof_avg, prof_var=prof_var,
                     redchi=profile_redchi(prof, prof_avg, prof_var))


# ----------------------------------------------------------------------
# Profile shifting / combining
# ----------------------------------------------------------------------

def shift_prof(prof: np.ndarray, shift_bins: float) -> np.ndarray:
    """Rotate a profile LEFT by shift_bins (fractional, linear interp):
    out[i] = prof[(i + shift) mod L].  Parity: shift_prof fold.c:697.
    Host float64."""
    L = len(prof)
    idx = np.arange(L) + np.floor(shift_bins)
    fr = shift_bins - np.floor(shift_bins)
    lo = prof[(idx.astype(np.int64)) % L]
    hi = prof[(idx.astype(np.int64) + 1) % L]
    return (1.0 - fr) * lo + fr * hi


def rotated(profs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """profs [..., n, L]; shifts [..., n] (bins, fractional, float32).
    Each profile rotated LEFT by its shift with two-tap linear
    interpolation, in float32 -> [..., n, L] (the JAX package's
    rotate_sum before its sum)."""
    L = profs.shape[-1]
    k = torch.floor(shifts)
    fr = (shifts - k)[..., None]
    idx = torch.remainder(
        torch.arange(L, device=profs.device) + k.long()[..., None], L)
    shape = torch.broadcast_shapes(profs.shape, idx.shape)
    src, idx = profs.expand(shape), idx.expand(shape)
    lo = torch.gather(src, -1, idx)
    hi = torch.gather(src, -1, torch.remainder(idx + 1, L))
    return (1.0 - fr) * lo + fr * hi


def rotate_sum(profs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """profs [n, L]; shifts [n] -> the [L] sum of the left-rotated
    profiles (the single source of the rotation for combine_profs,
    combine_subbands and the prepfold trial search)."""
    return rotated(profs, shifts).sum(dim=-2)


def combine_profs(profs: np.ndarray, shifts: np.ndarray,
                  device="cuda") -> np.ndarray:
    """Sum n profiles with per-profile fractional left rotations
    (fold.c:737), float32 on ``device``; leading axes of ``profs`` are
    batch axes sharing the shifts."""
    return rotate_sum(to_f32(profs, device),
                      to_f32(shifts, device)).cpu().numpy().astype(
                          np.float64)


def combine_subbands(profs: np.ndarray, dm_shifts: np.ndarray,
                     device="cuda") -> np.ndarray:
    """Profile-domain dedispersion: profs [npart, nsub, L] summed over
    subbands with per-subband phase-bin rotations (dispersion.c:232-287),
    float32 on ``device``.  Returns [npart, L]."""
    return combine_profs(profs, dm_shifts, device)


def subband_fold_shifts(subfreqs: np.ndarray, dm: float, fold_dm: float,
                        f: float, proflen: int,
                        ref_freq: Optional[float] = None) -> np.ndarray:
    """Phase-bin LEFT-rotations aligning subband profiles folded at
    fold_dm as if dedispersed at dm (host float64).

    A lower-frequency subband's pulse arrives LATER by
    ddelay = delay(sub, dm) - delay(sub, fold_dm) (relative to the
    highest band, ref_freq): its profile peak sits ddelay*f*proflen
    bins to the RIGHT, so rotate LEFT by that amount to align.
    """
    if ref_freq is None:
        ref_freq = subfreqs.max()
    ddel = ((delay_from_dm(dm, subfreqs) - delay_from_dm(dm, ref_freq))
            - (delay_from_dm(fold_dm, subfreqs)
               - delay_from_dm(fold_dm, ref_freq)))
    return ddel * f * proflen
