"""Batched Fourier-domain candidate refinement (the polish), in PyTorch.

PyTorch counterpart of the (r, z) part of ``presto_tpu/search/polish.py``.
The z-response kernel is the continuous matched filter

    R(d; z) = integral_0^1 exp(2 pi i (-d u + z (u^2 - u)/2)) du,

so the interpolated amplitude a polish maximizes,
A(r, z) = sum_m X[m] conj(R(m - r; z)), is the time-domain dot product

    A(r, z) = integral_0^1 w(u) exp(-2 pi i (fr u + z (u^2-u)/2)) du,
    w(u)    = sum_|d|<W/2 X[rint + d] e^{2 pi i d u},   fr = r - rint.

w(u) is computed once per (candidate, harmonic) pair by one complex
matmul of the gathered W-tap windows (``_windows_to_wmat``); every
evaluation after that is a chirp multiply and a mean over npts
quadrature points, batched over pairs and grid points.  The optimizer is
the JAX package's fixed-shape coarse-to-fine grid descent: a 7x7 (r, z)
grid scaled 1/numharm per candidate, re-centred twice at the coarse step,
then shrunk 3x per stage, on the joint harmonic sum.  The device only
sees offsets from the seed; absolute r and z are rebuilt on the host in
float64.

The arithmetic is the JAX package's, in float32 (the matmul at full
float32 precision: TF32 must be off).  What differs, none of which
changes a result:

  * no power-of-two padding of pairs and candidates (it bounds XLA
    recompiles; pad pairs carry objective weight 0):
    tests/test_torch_polish.py holds padded and unpadded results equal;
  * the harmonic sum of each candidate's objective is laid out as
    [ncand, max numharm] slots (empty slots zero) whose columns are added
    in ascending harmonic order: the order of the JAX package's
    ``jax.ops.segment_sum``, with no atomics, so deterministic on the card;
  * no scipy fallback and no environment switch: a failure raises.

The jerk (r, z, w) polish waits for the jerk search.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from presto_tpu_torch.ops import responses as resp
from presto_tpu_torch.ops import stats as st
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.optimize import (FourierProps, OptimizedCand,
                                              RDerivs, calc_props)

GRID_G = 3              # grid half-extent: (2G+1)^2 = 49 points/stage
N_STAGES = 5            # stage s step = step0 / 3^s
SHRINK = 3.0
# stage-0 steps in FUNDAMENTAL bins (scaled 1/numharm per candidate):
# the search grid quantizes r to 0.5/nh and z to 2/nh, so the true
# peak lies within (0.25, 1.0)/nh of the seed; G*step0 must cover it
STEP0_R = 0.12
STEP0_Z = 0.5
PAIR_CHUNK = 512        # pairs per slice of the [P, grid, npts] evaluation


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _cis(ang: torch.Tensor) -> torch.Tensor:
    """exp(i ang) for float32 ang: what exp of the JAX package's purely
    imaginary complex64 argument computes.  (torch.polar, not
    torch.cos/sin: the CPU build's float32 cos has been seen to return
    errors of 1.5e-4 on the first call of a process.)"""
    return torch.polar(torch.ones((), dtype=ang.dtype,
                                  device=ang.device).expand_as(ang), ang)


def _u_grid(npts: int, device) -> torch.Tensor:
    """The npts-point midpoint grid on [0, 1), float32."""
    return (torch.arange(npts, dtype=torch.float32, device=device)
            + 0.5) / npts


def _check_full_f32_matmul(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("polish: TF32 matmuls are on; the window "
                           "transform needs full float32 (set "
                           "torch.backends.cuda.matmul.allow_tf32 = False)")


# ----------------------------------------------------------------------
# Device stages
# ----------------------------------------------------------------------


def _windows_to_wmat(amp_pairs: torch.Tensor, rints: torch.Tensor, W: int,
                     npts: int, spec_of: torch.Tensor = None
                     ) -> torch.Tensor:
    """Gather each pair's W-tap spectral window and transform it to w(u)
    on the npts-point midpoint grid: one complex matmul for the batch.
    Out-of-spectrum taps read zero.

    amp_pairs [n, 2] float32 for one spectrum, or [ns, n, 2] with
    spec_of [P] selecting each pair's spectrum.  Returns [P, npts]
    complex64."""
    dev = amp_pairs.device
    _check_full_f32_matmul(dev)
    n = amp_pairs.shape[-2]
    dl = torch.arange(W, dtype=torch.int64, device=dev) - W // 2
    idx = rints.to(torch.int64)[:, None] + dl[None]
    ok = (idx >= 0) & (idx < n)
    cidx = idx.clamp(0, n - 1)
    if amp_pairs.ndim == 3:
        seg = amp_pairs[spec_of.to(torch.int64)[:, None], cidx]  # [P, W, 2]
    else:
        seg = amp_pairs[cidx]                                    # [P, W, 2]
    segc = torch.where(ok, torch.complex(seg[..., 0], seg[..., 1]),
                       torch.zeros((), dtype=torch.complex64, device=dev))
    u = _u_grid(npts, dev)
    F = _cis(torch.outer(dl.to(torch.float32), u) * (2 * math.pi))
    return torch.matmul(segc, F)                                 # [P, npts]


def _eval_A(wmat: torch.Tensor, fr: torch.Tensor,
            zh: torch.Tensor) -> torch.Tensor:
    """A at (fr, zh) per pair and grid point: wmat [P, npts] complex,
    fr/zh [P, G] -> [P, G] complex64 (chirp multiply + mean)."""
    npts = wmat.shape[-1]
    u = _u_grid(npts, wmat.device)
    cu = 0.5 * (u * u - u)
    phase = fr[..., None] * u
    phase += zh[..., None] * cu
    ph = _cis(phase.mul_(-2 * math.pi))
    return torch.mean(wmat[:, None, :] * ph, dim=-1)


def _eval_A_chunked(wmat: torch.Tensor, fr: torch.Tensor,
                    zh: torch.Tensor) -> torch.Tensor:
    """_eval_A over slices of PAIR_CHUNK pairs (bounds the [P, G, npts]
    intermediates)."""
    P = wmat.shape[0]
    if P <= PAIR_CHUNK:
        return _eval_A(wmat, fr, zh)
    return torch.cat([_eval_A(wmat[i:i + PAIR_CHUNK], fr[i:i + PAIR_CHUNK],
                              zh[i:i + PAIR_CHUNK])
                      for i in range(0, P, PAIR_CHUNK)])


def _harmonic_slots(cand_of: np.ndarray, ncand: int):
    """Each pair's slot (its index within its candidate's run) and the
    largest run: pairs of a candidate must be contiguous and in
    ascending candidate order, as the pair expansion lays them out."""
    cand_of = np.asarray(cand_of, np.int64)
    if cand_of.size and (np.any(np.diff(cand_of) < 0)
                         or cand_of[0] < 0 or cand_of[-1] >= ncand):
        raise ValueError("polish: pairs must be grouped by candidate in "
                         "ascending order")
    starts = np.searchsorted(cand_of, np.arange(ncand))
    slot = np.arange(cand_of.size) - starts[cand_of]
    width = int(slot.max()) + 1 if slot.size else 1
    return slot, width


def _refine_stages(wmat, cand_of, hh, frac0, zseed, inv_lp, obj_w,
                   step0_r, step0_z, ncand: int):
    """The coarse-to-fine joint-harmonic grid descent, in offset space.

    wmat [P, npts]; cand_of [P] pair -> candidate (host integers, grouped
    by candidate); hh [P] harmonic number; frac0 [P] = seed_r*h - rint
    (float64 residual, cast f32); zseed [ncand]; inv_lp [P] 1/locpow
    objective weights; obj_w [P] 0/1 mask (harmpolish=False keeps only
    the fundamental); step0_* [ncand].  Tensors on wmat's device.

    Returns (dr, dz) [ncand], the fundamental offsets from the seed.
    (The JAX package also flags stage-0 argmaxes on the grid edge, for
    its opt-in scipy fallback, which the port does not carry.)"""
    dev = wmat.device
    G = GRID_G
    ng = 2 * G + 1
    g1 = torch.arange(-G, G + 1, dtype=torch.float32, device=dev)
    gi = torch.repeat_interleave(g1, ng)          # r offsets
    gj = g1.repeat(ng)                            # z offsets
    slot, width = _harmonic_slots(cand_of, ncand)
    cof = torch.as_tensor(np.asarray(cand_of, np.int64), device=dev)
    slot = torch.as_tensor(slot, device=dev)
    weight = (inv_lp * obj_w)[:, None]
    ar = torch.arange(ncand, device=dev)

    def stage_argmax(dr, dz, sr, sz):
        rs = dr[:, None] + sr[:, None] * gi[None]     # [ncand, ngrid2]
        zs = dz[:, None] + sz[:, None] * gj[None]
        frp = frac0[:, None] + rs[cof] * hh[:, None]
        zhp = (zseed[cof][:, None] + zs[cof]) * hh[:, None]
        A = _eval_A_chunked(wmat, frp, zhp)
        P2 = (A.real * A.real + A.imag * A.imag) * weight
        slots = torch.zeros((ncand, width, P2.shape[1]), dtype=P2.dtype,
                            device=dev)
        slots[cof, slot] = P2
        obj = slots[:, 0]
        for j in range(1, width):            # ascending harmonic order
            obj = obj + slots[:, j]
        best = torch.argmax(obj, dim=-1)     # first maximum, as jnp.argmax
        return rs[ar, best], zs[ar, best]

    dr = torch.zeros(ncand, dtype=torch.float32, device=dev)
    dz = torch.zeros(ncand, dtype=torch.float32, device=dev)
    # stage-0 walk: re-centre twice at the coarse step so a seed near
    # the cell edge still captures its peak
    for _ in range(2):
        dr, dz = stage_argmax(dr, dz, step0_r, step0_z)
    for s in range(1, N_STAGES):
        dr, dz = stage_argmax(dr, dz, step0_r / (SHRINK ** s),
                              step0_z / (SHRINK ** s))
    return dr, dz


def _final_measures(wmat, fr, zh):
    """Per-pair measurements at one (fr, zh) each: A at the point and
    at the d/dr stencil (-0.05, +0.05), and the local power from the
    flanking offsets.  Returns (A [P, 3] complex64, locpow [P])."""
    H = resp.NUMLOCPOWAVG // 2
    offs = np.concatenate([[0.0, -0.05, 0.05],
                           -(resp.DELTAAVGBINS + np.arange(H)),
                           (resp.DELTAAVGBINS + np.arange(H))]
                          ).astype(np.float32)
    frg = fr[:, None] + torch.as_tensor(offs, device=fr.device)[None]
    zhg = zh[:, None].expand(frg.shape)
    A = _eval_A_chunked(wmat, frg, zhg)
    pows = A.real * A.real + A.imag * A.imag
    locpow = torch.clamp(torch.mean(pows[:, 3:], dim=-1), min=1e-30)
    return A[:, :3], locpow


# ----------------------------------------------------------------------
# Host driver
# ----------------------------------------------------------------------


def _geometry(zmax_pairs: float):
    """(W, npts) for a batch whose largest per-harmonic |z| (including
    grid drift) is zmax_pairs: the window spans the widest kernel plus
    the locpow offsets, quadrature resolves W/2 + z/2 + 1 cycles."""
    hw = resp.z_resp_halfwidth(float(zmax_pairs), resp.HIGHACC)
    W = _round_up(2 * hw + 2 * (resp.DELTAAVGBINS
                                + resp.NUMLOCPOWAVG // 2) + 16, 128)
    need = W // 2 + zmax_pairs / 2 + 2
    npts = 128
    while npts < 2 * need:
        npts *= 2
    return W, int(npts)


def _as_pairs(amps, device) -> torch.Tensor:
    """A spectrum (or stack) as float32 pairs on its device: a tensor
    stays where it is; numpy (complex, or [..., 2] float) goes to
    ``device``."""
    if isinstance(amps, torch.Tensor):
        return amps.to(torch.float32)
    amps = np.asarray(amps)
    if amps.dtype.kind == "c":
        pairs = np.stack([amps.real, amps.imag], -1).astype(np.float32)
    else:
        pairs = np.asarray(amps, np.float32)
    return torch.as_tensor(pairs, device=resolve_device(device))


def optimize_accelcands(amps, cands, T: float, numindep: Sequence[float],
                        harmpolish: bool = True, with_props: bool = True,
                        spec_of=None, device="cuda") -> List[OptimizedCand]:
    """Batched polish of a candidate list (the JAX package's
    optimize_accelcands, batched path).

    amps: a spectrum as a tensor of [n, 2] float32 pairs (it runs on the
    tensor's device) or as numpy (complex or pairs; it runs on
    ``device``); or a stack [ns, n, 2] with spec_of [len(cands)]
    selecting each candidate's spectrum.  Returns OptimizedCand per
    input candidate, in input order."""
    if not cands:
        return []
    amp_pairs = _as_pairs(amps, device)
    dev = amp_pairs.device
    if (spec_of is None) != (amp_pairs.ndim == 2):
        raise ValueError("polish: spec_of is required iff amps is a "
                         "[ns, n, 2] stack")

    nc = len(cands)
    nh = np.asarray([c.numharm for c in cands], np.int32)
    seed_r = np.asarray([c.r for c in cands], np.float64)
    seed_z = np.asarray([c.z for c in cands], np.float64)

    # pair expansion (candidate, harmonic)
    cand_of = np.repeat(np.arange(nc, dtype=np.int32), nh)
    hh = np.concatenate([np.arange(1, n + 1) for n in nh]
                        ).astype(np.float32)
    rint = np.floor(seed_r[cand_of] * hh).astype(np.int32)
    P = cand_of.shape[0]

    step0_r = (STEP0_R / nh).astype(np.float32)
    step0_z = (STEP0_Z / nh).astype(np.float32)
    zmax_b = float(np.abs(seed_z[cand_of] * hh).max()
                   + STEP0_Z * GRID_G + 1.0)
    W, npts = _geometry(zmax_b)

    def t(a):
        return torch.as_tensor(a, device=dev)

    spec_p = None
    if spec_of is not None:
        spec_p = t(np.asarray(spec_of, np.int32)[cand_of])
    # float64 residual of the absolute frequency: everything the device
    # sees is seed-relative (float32 cannot hold survey-scale absolute
    # r*h to bin precision)
    frac0 = (seed_r[cand_of] * hh.astype(np.float64)
             - rint).astype(np.float32)
    seed_z32 = seed_z.astype(np.float32)
    hh_t = t(hh)

    wmat = _windows_to_wmat(amp_pairs, t(rint), W, npts, spec_of=spec_p)

    # seed local powers -> objective weights (fixed during the descent)
    _, lp0 = _final_measures(wmat, t(frac0), t(seed_z32[cand_of] * hh))
    obj_w = np.ones(P, np.float32) if harmpolish else \
        (hh == 1.0).astype(np.float32)

    drc, dzc = _refine_stages(
        wmat, cand_of, hh_t, t(frac0), t(seed_z32), 1.0 / lp0, t(obj_w),
        t(step0_r), t(step0_z), nc)

    rr = seed_r + drc.cpu().numpy().astype(np.float64)   # float64 rebuild
    zz = seed_z + dzc.cpu().numpy().astype(np.float64)

    # final measurements at the refined peak (the fractional part is
    # computed in float64, then cast)
    frf = t((rr[cand_of] * hh.astype(np.float64) - rint).astype(np.float32))
    zhf = t((zz[cand_of] * hh).astype(np.float32))
    A3, lpf = _final_measures(wmat, frf, zhf)
    A3 = A3.cpu().numpy().astype(np.complex128)
    lpf = lpf.cpu().numpy().astype(np.float64)
    rawp = (A3[:, 0].real ** 2 + A3[:, 0].imag ** 2).astype(np.float64)
    hpow = rawp / lpf

    tot = np.zeros(nc)
    np.add.at(tot, cand_of, hpow)
    stages = np.log2(nh).astype(int)
    sig = np.empty(nc, np.float64)
    for s_ in np.unique(stages):      # one vectorized call per stage
        m = stages == s_
        sig[m] = np.atleast_1d(st.candidate_sigma(
            tot[m], 1 << int(s_), numindep[int(s_)]))

    pair_lo = np.concatenate([[0], np.cumsum(nh)])
    out: List[OptimizedCand] = []
    for i in range(nc):
        props: List[FourierProps] = []
        if with_props:
            for j in range(pair_lo[i], pair_lo[i + 1]):
                h = hh[j]
                pw = lambda a: (a.real ** 2 + a.imag ** 2) / lpf[j]  # noqa
                amid, alo, ahi = A3[j]
                pm, pl, ph_ = pw(amid), pw(alo), pw(ahi)
                phm = float(np.angle(amid))
                phl = phm + float(np.angle(alo * np.conj(amid)))
                phh = phm + float(np.angle(ahi * np.conj(amid)))
                hstep = 0.05
                d = RDerivs(
                    pow=pm, phs=phm,
                    dpow=(ph_ - pl) / (2 * hstep),
                    dphs=(phh - phl) / (2 * hstep),
                    d2pow=(ph_ - 2 * pm + pl) / hstep ** 2,
                    d2phs=(phh - 2 * phm + phl) / hstep ** 2,
                    locpow=lpf[j])
                props.append(calc_props(d, rr[i] * h, zz[i] * h))
        out.append(OptimizedCand(
            r=float(rr[i]), z=float(zz[i]), power=float(tot[i]),
            sigma=float(sig[i]), numharm=int(nh[i]),
            hpows=list(hpow[pair_lo[i]:pair_lo[i + 1]]), props=props))
    return out


def optimize_accelcands_batched(amps_batch, cands_lists, T: float,
                                numindep: Sequence[float],
                                harmpolish: bool = True,
                                with_props: bool = False, device="cuda"
                                ) -> List[List[OptimizedCand]]:
    """Cross-trial batched polish: every trial's candidates refined
    against its own spectrum in one pipeline (the spectrum index rides
    the window gather).  amps_batch: [ns, numbins, 2] float32 (tensor or
    numpy); cands_lists: per-trial candidate lists.  Equal to per-trial
    optimize_accelcands calls whenever the pooled window geometry is the
    one each trial alone would pick (the homogeneous z ranges of a
    survey fan-out)."""
    all_cands = [c for cl in cands_lists for c in cl]
    if not all_cands:
        return [[] for _ in cands_lists]
    spec_of = np.concatenate(
        [np.full(len(cl), i, np.int32) for i, cl in enumerate(cands_lists)])
    ocs = optimize_accelcands(amps_batch, all_cands, T, numindep,
                              harmpolish=harmpolish, with_props=with_props,
                              spec_of=spec_of, device=device)
    out, k = [], 0
    for cl in cands_lists:
        out.append(ocs[k:k + len(cl)])
        k += len(cl)
    return out
