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

The jerk (r, z, w) polish, ``optimize_jerk_cands``, is the same descent
on a (2G+1)^2 (2GW+1) = 245-point (r, z, w) grid, the w term of the chirp
being w (u^3/6 - u^2/4 + u/12) (the time-domain twin of gen_w_response's
cubic phase), its local powers measured at w = 0 (the jerk acceptance
convention of the JAX package).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from presto_tpu_torch.ops import responses as resp
from presto_tpu_torch.ops import stats as st
from presto_tpu_torch.search.accel import (check_full_f32_matmul,
                                           resolve_device)
from presto_tpu_torch.search.optimize import (FourierProps, OptimizedCand,
                                              RDerivs, calc_props)

GRID_G = 3              # grid half-extent: (2G+1)^2 = 49 points/stage
GRID_GW = 2             # jerk descent: (2G+1)^2 (2GW+1) = 245 points/stage
N_STAGES = 5            # stage s step = step0 / 3^s
SHRINK = 3.0
# stage-0 steps in FUNDAMENTAL bins (scaled 1/numharm per candidate):
# the search grid quantizes r to 0.5/nh and z to 2/nh, so the true
# peak lies within (0.25, 1.0)/nh of the seed; G*step0 must cover it
STEP0_R = 0.12
STEP0_Z = 0.5
STEP0_W = 5.0           # w step (fundamental; seed error <= ACCEL_DW/2)
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
    check_full_f32_matmul(dev, "polish: the window transform")
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


def _eval_A(wmat: torch.Tensor, fr: torch.Tensor, zh: torch.Tensor,
            wh: torch.Tensor = None) -> torch.Tensor:
    """A at (fr, zh[, wh]) per pair and grid point: wmat [P, npts]
    complex, fr/zh/wh [P, G] -> [P, G] complex64 (chirp multiply +
    mean); wh adds the jerk phase wh (u^3/6 - u^2/4 + u/12)."""
    npts = wmat.shape[-1]
    u = _u_grid(npts, wmat.device)
    cu = 0.5 * (u * u - u)
    phase = fr[..., None] * u
    phase += zh[..., None] * cu
    if wh is not None:
        p3 = u * u * u / 6.0 - u * u / 4.0 + u / 12.0
        phase += wh[..., None] * p3
    ph = _cis(phase.mul_(-2 * math.pi))
    return torch.mean(wmat[:, None, :] * ph, dim=-1)


def _eval_A_chunked(wmat: torch.Tensor, fr: torch.Tensor,
                    zh: torch.Tensor, wh: torch.Tensor = None
                    ) -> torch.Tensor:
    """_eval_A over slices of PAIR_CHUNK pairs (bounds the [P, G, npts]
    intermediates)."""
    P = wmat.shape[0]
    if P <= PAIR_CHUNK:
        return _eval_A(wmat, fr, zh, wh)
    return torch.cat([_eval_A(wmat[i:i + PAIR_CHUNK], fr[i:i + PAIR_CHUNK],
                              zh[i:i + PAIR_CHUNK],
                              None if wh is None else wh[i:i + PAIR_CHUNK])
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
                   step0_r, step0_z, ncand: int, wseed=None, step0_w=None):
    """The coarse-to-fine joint-harmonic grid descent, in offset space.

    wmat [P, npts]; cand_of [P] pair -> candidate (host integers, grouped
    by candidate); hh [P] harmonic number; frac0 [P] = seed_r*h - rint
    (float64 residual, cast f32); zseed [ncand]; inv_lp [P] 1/locpow
    objective weights; obj_w [P] 0/1 mask (harmpolish=False keeps only
    the fundamental); step0_* [ncand].  Tensors on wmat's device.

    Returns (dr, dz) [ncand], the fundamental offsets from the seed.
    (The JAX package also flags stage-0 argmaxes on the grid edge, for
    its opt-in scipy fallback, which the port does not carry.)  With
    wseed/step0_w [ncand] the descent is the jerk's, on the 3-D grid, and
    returns (dr, dz, dw)."""
    dev = wmat.device
    grid = _StageGrid(wmat, cand_of, hh, frac0, zseed, inv_lp * obj_w,
                      ncand, wseed)
    ar = torch.arange(ncand, device=dev)
    d = [torch.zeros(ncand, dtype=torch.float32, device=dev)
         for _ in range(2 if wseed is None else 3)]
    steps = [step0_r, step0_z] + ([] if wseed is None else [step0_w])
    for div in STAGE_DIVISORS:
        obj, pts = grid.objective(d, [s_ / div for s_ in steps])
        best = torch.argmax(obj, dim=-1)     # first maximum, as jnp.argmax
        d = [p[ar, best] for p in pts]
    return tuple(d)


# each argmax stage's step divisor: the stage-0 walk re-centres twice at
# the coarse step (so a seed near the cell edge still captures its
# peak), then the step shrinks SHRINK-fold a stage
STAGE_DIVISORS = (1.0, 1.0) + tuple(SHRINK ** s for s in range(1, N_STAGES))


class _StageGrid:
    """The descent's objective on a stage's grid around each candidate's
    centre: the joint harmonic sum of |A|^2 * weight, the harmonics added
    in ascending order.  The grid is (2G+1)^2 in (r, z), or with a w seed
    (2G+1)^2 (2GW+1) in (r, z, w), laid out as the JAX package's (w
    slowest, then r, then z)."""

    def __init__(self, wmat, cand_of, hh, frac0, zseed, weight, ncand,
                 wseed=None):
        dev = wmat.device
        G = GRID_G
        ng = 2 * G + 1
        g1 = torch.arange(-G, G + 1, dtype=torch.float32, device=dev)
        self.offs = [torch.repeat_interleave(g1, ng),      # r offsets
                     g1.repeat(ng)]                        # z offsets
        if wseed is not None:
            gw = torch.arange(-GRID_GW, GRID_GW + 1, dtype=torch.float32,
                              device=dev)
            nw = gw.numel()
            self.offs = [o.repeat(nw) for o in self.offs] + [
                torch.repeat_interleave(gw, ng * ng)]      # w offsets
        slot, self.width = _harmonic_slots(cand_of, ncand)
        self.cof = torch.as_tensor(np.asarray(cand_of, np.int64), device=dev)
        self.slot = torch.as_tensor(slot, device=dev)
        self.wmat, self.hh, self.frac0 = wmat, hh, frac0
        self.seeds = [zseed] + ([] if wseed is None else [wseed])
        self.weight = weight[:, None]
        self.ncand = ncand

    def objective(self, centres, steps):
        """(objective [ncand, ngrid], [r, z(, w) offsets [ncand, ngrid]])
        of the grid of ``steps`` around ``centres`` (offsets from the
        seeds, one [ncand] tensor an axis)."""
        cof, hh = self.cof, self.hh
        pts = [c[:, None] + s_[:, None] * o[None]          # [ncand, ngrid]
               for c, s_, o in zip(centres, steps, self.offs)]
        frp = self.frac0[:, None] + pts[0][cof] * hh[:, None]
        zw = [(seed[cof][:, None] + p[cof]) * hh[:, None]
              for seed, p in zip(self.seeds, pts[1:])]
        A = _eval_A_chunked(self.wmat, frp, *zw)
        P2 = (A.real * A.real + A.imag * A.imag) * self.weight
        slots = torch.zeros((self.ncand, self.width, P2.shape[1]),
                            dtype=P2.dtype, device=P2.device)
        slots[cof, self.slot] = P2
        obj = slots[:, 0]
        for j in range(1, self.width):       # ascending harmonic order
            obj = obj + slots[:, j]
        return obj, pts


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


def _geometry(zmax_pairs: float, wmax_pairs: float = None):
    """(W, npts) for a batch whose largest per-harmonic |z| (and, for the
    jerk polish, |w|), grid drift included, is zmax_pairs (wmax_pairs):
    the window spans the widest kernel plus the locpow offsets,
    quadrature resolves W/2 + z/2 (+ w/12) + 2 cycles."""
    if wmax_pairs is None:
        hw = resp.z_resp_halfwidth(float(zmax_pairs), resp.HIGHACC)
    else:
        hw = resp.w_resp_halfwidth(zmax_pairs, wmax_pairs, resp.HIGHACC)
    W = _round_up(2 * hw + 2 * (resp.DELTAAVGBINS
                                + resp.NUMLOCPOWAVG // 2) + 16, 128)
    extra = 0.0 if wmax_pairs is None else wmax_pairs / 12.0
    need = W // 2 + zmax_pairs / 2 + extra + 2
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


def optimize_jerk_cands(amps, cands, T: float, numindep: Sequence[float],
                        harmpolish: bool = True, device="cuda"
                        ) -> List[OptimizedCand]:
    """Batched (r, z, w) polish of jerk-search candidates (the JAX
    package's optimize_jerk_cands): seeds carry the w of their plane
    (fundamental-scaled), the descent runs on the 3-D grid, locpow is
    measured at w = 0.  amps as in optimize_accelcands (one spectrum).
    Returns OptimizedCand per input, in order, with .w set (no props)."""
    if not cands:
        return []
    amp_pairs = _as_pairs(amps, device)
    dev = amp_pairs.device
    nc = len(cands)
    nh = np.asarray([c.numharm for c in cands], np.int32)
    seed_r = np.asarray([c.r for c in cands], np.float64)
    seed_z = np.asarray([c.z for c in cands], np.float64)
    seed_w = np.asarray([c.w for c in cands], np.float64)
    cand_of = np.repeat(np.arange(nc, dtype=np.int32), nh)
    hh = np.concatenate([np.arange(1, n + 1) for n in nh]
                        ).astype(np.float32)
    rint = np.floor(seed_r[cand_of] * hh).astype(np.int32)
    P = cand_of.shape[0]
    step0_r = (STEP0_R / nh).astype(np.float32)
    step0_z = (STEP0_Z / nh).astype(np.float32)
    step0_w = (STEP0_W / nh).astype(np.float32)
    # the window covers the widest (z, w) kernel of the batch
    zmax_b = float(np.abs(seed_z[cand_of] * hh).max()
                   + STEP0_Z * GRID_G + 1.0)
    wmax_b = float(np.abs(seed_w[cand_of] * hh).max()
                   + STEP0_W * GRID_GW + 1.0)
    W, npts = _geometry(zmax_b, wmax_b)

    def t(a):
        return torch.as_tensor(a, device=dev)

    frac0 = (seed_r[cand_of] * hh.astype(np.float64)
             - rint).astype(np.float32)
    seed_z32 = seed_z.astype(np.float32)
    hh_t = t(hh)
    wmat = _windows_to_wmat(amp_pairs, t(rint), W, npts)
    # locpow at the seed, w = 0 (the jerk acceptance convention)
    _, lp0 = _final_measures(wmat, t(frac0), t(seed_z32[cand_of] * hh))
    obj_w = np.ones(P, np.float32) if harmpolish else \
        (hh == 1.0).astype(np.float32)
    drc, dzc, dwc = _refine_stages(
        wmat, cand_of, hh_t, t(frac0), t(seed_z32), 1.0 / lp0, t(obj_w),
        t(step0_r), t(step0_z), nc, wseed=t(seed_w.astype(np.float32)),
        step0_w=t(step0_w))
    rr = seed_r + drc.cpu().numpy().astype(np.float64)   # float64 rebuild
    zz = seed_z + dzc.cpu().numpy().astype(np.float64)
    ww = seed_w + dwc.cpu().numpy().astype(np.float64)

    # raw powers at the refined (r, z, w), locpow at (r, z) and w = 0
    hpow = _jerk_measures(wmat, rr, zz, ww, cand_of, hh, rint)
    tot = np.zeros(nc)
    np.add.at(tot, cand_of, hpow)
    stages = np.log2(nh).astype(int)
    sig = np.empty(nc, np.float64)
    for s_ in np.unique(stages):
        m = stages == s_
        sig[m] = np.atleast_1d(st.candidate_sigma(
            tot[m], 1 << int(s_), numindep[int(s_)]))
    pair_lo = np.concatenate([[0], np.cumsum(nh)])
    return [OptimizedCand(
        r=float(rr[i]), z=float(zz[i]), power=float(tot[i]),
        sigma=float(sig[i]), numharm=int(nh[i]),
        hpows=list(hpow[pair_lo[i]:pair_lo[i + 1]]), w=float(ww[i]))
        for i in range(nc)]


def _jerk_measures(wmat, rr, zz, ww, cand_of, hh, rint) -> np.ndarray:
    """Per pair |A(r h, z h, w h)|^2 / locpow(r h, z h), locpow at w = 0
    (the jerk polish's final measurement); float64 [P]."""
    dev = wmat.device
    hh64 = hh.astype(np.float64)
    frf = torch.as_tensor((rr[cand_of] * hh64 - rint).astype(np.float32),
                          device=dev)
    zhf = torch.as_tensor((zz[cand_of] * hh).astype(np.float32), device=dev)
    whf = torch.as_tensor((ww[cand_of] * hh).astype(np.float32), device=dev)
    A = _eval_A_chunked(wmat, frf[:, None], zhf[:, None], whf[:, None])[:, 0]
    raw = (A.real * A.real + A.imag * A.imag).cpu().numpy()   # float32
    _, lpf = _final_measures(wmat, frf, zhf)
    return raw.astype(np.float64) / lpf.cpu().numpy().astype(np.float64)


def final_steps(numharm) -> tuple:
    """(r, z) grid steps of the descent's last stage, fundamental units,
    for candidates of ``numharm`` harmonics."""
    shrink = SHRINK ** (N_STAGES - 1)
    nh = np.asarray(numharm, np.float64)
    return STEP0_R / nh / shrink, STEP0_Z / nh / shrink


def final_step_w(numharm):
    """The jerk descent's last-stage w step, fundamental units."""
    return STEP0_W / np.asarray(numharm, np.float64) / SHRINK ** (N_STAGES - 1)


def joint_powers(amps, r, z, numharm, zmax_pairs=None,
                 device="cpu") -> np.ndarray:
    """The polish's objective at given points: for each (r, z, numharm),
    the sum over its harmonics h of |A(r h, z h)|^2 / locpow, evaluated
    as optimize_accelcands' final measurement evaluates its peak (each
    pair's window centred on floor(r h); the window geometry of
    _geometry(zmax_pairs), by default that of the points' largest
    |z h|).  float64 [len(r)]."""
    amp_pairs = _as_pairs(amps, device)
    dev = amp_pairs.device
    r = np.asarray(r, np.float64)
    z = np.asarray(z, np.float64)
    nh = np.asarray(numharm, np.int64)
    of = np.repeat(np.arange(r.size), nh)
    hh = np.concatenate([np.arange(1, n + 1) for n in nh]).astype(np.float64)
    rint = np.floor(r[of] * hh)
    if zmax_pairs is None:
        zmax_pairs = float(np.abs(z[of] * hh).max())
    W, npts = _geometry(zmax_pairs + STEP0_Z * GRID_G + 1.0)
    wmat = _windows_to_wmat(amp_pairs, torch.as_tensor(
        rint.astype(np.int32), device=dev), W, npts)
    fr = torch.as_tensor((r[of] * hh - rint).astype(np.float32), device=dev)
    zh = torch.as_tensor((z[of] * hh).astype(np.float32), device=dev)
    A, lp = _final_measures(wmat, fr, zh)
    A0 = A[:, 0].cpu().numpy().astype(np.complex128)
    hp = (A0.real ** 2 + A0.imag ** 2) / lp.cpu().numpy().astype(np.float64)
    tot = np.zeros(r.size)
    np.add.at(tot, of, hp)
    return tot


class SeedWindows:
    """One seed's pairs as the polish sets them up: windows centred on
    floor(r h) of the seed, the batch's window geometry, the seed's local
    powers (w = 0) as objective weights."""

    def __init__(self, amp_pairs, c, W, npts, jerk, harmpolish=True):
        dev = amp_pairs.device
        self.nh = nh = int(c.numharm)
        self.hh = np.arange(1, nh + 1).astype(np.float32)
        self.rint = np.floor(c.r * self.hh.astype(np.float64)).astype(np.int32)
        self.frac0 = (c.r * self.hh.astype(np.float64)
                      - self.rint).astype(np.float32)
        self.seed = [np.float64(c.r), np.float64(c.z)] + (
            [np.float64(c.w)] if jerk else [])
        self.s32 = [np.float32(x) for x in self.seed[1:]]
        self.wmat = _windows_to_wmat(amp_pairs, torch.as_tensor(
            self.rint, device=dev), W, npts)
        _, self.lp0 = _final_measures(
            self.wmat, torch.as_tensor(self.frac0, device=dev),
            torch.as_tensor(self.s32[0] * self.hh, device=dev))
        self.weight = (self.hh == 1.0) if not harmpolish else \
            np.ones(nh, bool)

    def measures(self, pts):
        """For points [k, axes] (absolute r, z(, w)): (the descent's
        objective, offsets from the seed in float32 as the descent forms
        them; the final measurement), float64 [k] each."""
        dev = self.wmat.device
        pts = np.asarray(pts, np.float64).reshape(-1, len(self.seed))
        k = len(pts)
        hh = np.tile(self.hh, k)
        off = [(pts[:, a] - self.seed[a]).astype(np.float32)
               for a in range(len(self.seed))]
        rep = np.repeat(np.arange(k), self.nh)
        fr = torch.as_tensor(np.tile(self.frac0, k) + off[0][rep] * hh,
                             device=dev)
        zw = [torch.as_tensor((s + o[rep]) * hh, device=dev)
              for s, o in zip(self.s32, off[1:])]
        wm = self.wmat.repeat(k, 1)
        A = _eval_A_chunked(wm, fr[:, None], *[x[:, None] for x in zw])[:, 0]
        raw = (A.real * A.real + A.imag * A.imag).cpu().numpy()
        lp0 = np.tile(self.lp0.cpu().numpy(), k)
        wgt = np.tile(self.weight, k)
        obj = np.where(wgt, raw / lp0, 0.0).reshape(k, self.nh).sum(-1)
        rint = np.tile(self.rint, k)
        if len(self.seed) == 3:
            fin = _jerk_measures(wm, pts[:, 0], pts[:, 1], pts[:, 2], rep,
                                 hh, rint)
        else:                 # optimize_accelcands' final measurement
            frf = torch.as_tensor((pts[rep, 0] * hh.astype(np.float64)
                                   - rint).astype(np.float32), device=dev)
            zhf = torch.as_tensor((pts[rep, 1] * hh).astype(np.float32),
                                  device=dev)
            Af, lpf = _final_measures(wm, frf, zhf)
            A0 = Af[:, 0].cpu().numpy().astype(np.complex128)
            fin = (A0.real ** 2 + A0.imag ** 2) \
                / lpf.cpu().numpy().astype(np.float64)
        return obj.astype(np.float64), fin.reshape(k, self.nh).sum(-1)


def batch_geometry(seeds, jerk):
    """(W, npts) of a polish of the batch ``seeds``."""
    zgeo = max(abs(float(c.z)) * c.numharm for c in seeds) \
        + STEP0_Z * GRID_G + 1.0
    if not jerk:
        return _geometry(zgeo)
    return _geometry(zgeo, max(abs(float(c.w)) * c.numharm for c in seeds)
                     + STEP0_W * GRID_GW + 1.0)


def descent_replay(amps, seeds, tie_rtol, points=(), batch=None, jerk=False,
                   harmpolish=True, device="cpu"):
    """Replay the grid descent of optimize_accelcands (with ``jerk`` that
    of optimize_jerk_cands, on the 3-D grid) for each seed candidate,
    letting every stage's argmax be any grid point whose objective lies
    within ``tie_rtol`` of the stage's maximum (relative): the final
    points the descent can reach when its near-ties are broken either
    way (at most 64 a stage, the best).  ``points`` (one list of (r, z)
    or (r, z, w) per seed) are measured as the polish's final
    measurement measures its peak.  The window geometry is that of a
    polish of ``batch`` (by default the seeds).  Returns, per seed,
    (reachable points float64 [k, 2 or 3], the powers of its
    ``points``)."""
    amp_pairs = _as_pairs(amps, device)
    dev = amp_pairs.device
    naxes = 3 if jerk else 2
    W, npts = batch_geometry(batch if batch is not None else seeds, jerk)

    def t(a):
        return torch.as_tensor(a, device=dev)
    out = []
    for k, c in enumerate(seeds):
        sw = SeedWindows(amp_pairs, c, W, npts, jerk, harmpolish)
        nh, hh = sw.nh, sw.hh
        step0 = [np.float32(STEP0_R / nh), np.float32(STEP0_Z / nh)] + (
            [np.float32(STEP0_W / nh)] if jerk else [])
        d = [torch.zeros(1, dtype=torch.float32, device=dev)
             for _ in range(naxes)]
        inv = (1.0 / sw.lp0) * t(sw.weight.astype(np.float32))
        for div in STAGE_DIVISORS:
            ncent = d[0].shape[0]
            grid = _StageGrid(sw.wmat.repeat(ncent, 1),
                              np.repeat(np.arange(ncent), nh),
                              t(np.tile(hh, ncent)),
                              t(np.tile(sw.frac0, ncent)),
                              t(np.full(ncent, sw.s32[0])),
                              inv.repeat(ncent), ncent,
                              t(np.full(ncent, sw.s32[1])) if jerk else None)
            steps = [torch.full((ncent,), float(st0), dtype=torch.float32,
                                device=dev) / div for st0 in step0]
            obj, pts = grid.objective(d, steps)
            top = obj.max(dim=-1, keepdim=True).values
            keep = obj >= top - tie_rtol * top.abs()
            cand = torch.stack([p[keep] for p in pts] + [obj[keep]],
                               -1).cpu().numpy()
            seen = {}
            for row in cand:
                key = np.asarray(row[:naxes], np.float32).tobytes()
                seen[key] = max(seen.get(key, -np.inf), float(row[-1]))
            best = sorted(seen.items(), key=lambda kv: -kv[1])[:64]
            cent = np.stack([np.frombuffer(kk, np.float32)
                             for kk, _ in best])
            d = [t(cent[:, a].copy()) for a in range(naxes)]
        reach = np.stack([sw.seed[a] + d[a].cpu().numpy().astype(np.float64)
                          for a in range(naxes)], -1)
        pts = np.asarray(points[k] if points else [], np.float64).reshape(
            -1, naxes)
        pows = sw.measures(pts)[1] if len(pts) else np.zeros(0)
        out.append((reach, pows))
    return out


# Card against CPU, or port against the JAX package: two polishes of one
# candidate list agree when, per candidate (same numharm), either both
# picked the same grid point (power rtol SAME_POWER_RTOL, sigma within
# SAME_SIGMA) or the argmax of a near-flat surface moved one of them:
#  * by at most AGREE_STEPS final-stage grid steps on each axis (the
#    width of the last stage's 7 x 7 grid: both ends lie on one such
#    grid when the earlier stages agreed);
#  * with one evaluator (joint_powers, plain PyTorch on the CPU) giving
#    powers P(a), P(b) at the two points that differ by no more than
#        L + 2 * EVAL_RTOL * P(a),
#        L = (|H_rr| h_r^2 + 2 |H_rz| h_r h_z + |H_zz| h_z^2) / 8,
#    where h are the final-stage steps and H the Hessian of the power
#    at a from a 3 x 3 stencil of step h: on a locally quadratic surface
#    L bounds how far below the peak a grid maximum of step h can lie
#    (half a step on each axis), so two grid maxima of the same surface
#    differ by at most L, plus the rounding of the two evaluations;
#  * the two sides' reported powers within the same bound (each side
#    evaluated its own point), and sigma within MOVED_SIGMA.
# The jerk polish (jerk=True; the seeds and numindep are required) is
# held by the same rule in (r, z, w) on its 3-D grid, with L summed over
# the three axes' Hessian terms from a 3 x 3 x 3 stencil, and one change:
# P is the descent's own objective (harmonic powers over the SEED's local
# powers), not the final measurement.  The final measurement F divides by
# the local power at the point, taken at w = 0 around r h: along the
# jerk's (r, z, w) valley of near-equal objective that local power moves
# (0.3% for one final step on a strong numharm-4 signal), so F is no
# measure of a near-tie there.  Instead each side's reported power must
# be F at its own point within 2 * EVAL_RTOL (relative), and the two
# reported powers may differ by no more than F itself changes across the
# move d (in final-stage steps per axis), from F's gradient g and Hessian
# H on the same stencil (in step units):
#     |p_a - p_b| <= sum_i |g_i d_i| + 1/2 sum_ij |H_ij d_i d_j|
#                    + EVAL_RTOL |F(a)| (6 + sum_i |d_i|
#                                        + 2 sum_i d_i^2
#                                        + sum_i<j |d_i d_j|),
# the last term the rounding of one evaluator in the stencil's
# differences and in the two reported powers.  Sigma, a function of the
# power, may differ by no more than the sigma of that power gap (at the
# lower power, from numindep) plus SAME_SIGMA.
# The jerk rule takes JERK_EVAL_RTOL and JERK_TIE_RTOL in place of
# EVAL_RTOL and TIE_RTOL: its chirp adds w h (u^3/6 - u^2/4 + u/12), so
# the float32 phases are larger and two evaluators differ more (up to
# 9.5e-6 at one point: the objective and the final measurement at 27
# points around each of ten candidates of the jerk bench shape, card
# against CPU on an NVIDIA H100 80GB HBM3, PERF.md), rounded up.
# EVAL_RTOL is the largest relative difference of two evaluators at one
# point (1.0e-6 to 1.3e-6, card against CPU on an NVIDIA H100 80GB HBM3,
# PERF.md), rounded up.  Every other move is flagged.  With the seeds,
# each flagged move is also replayed (descent_replay, on the CPU) to say
# why it broke the rule: a "tie path" when the descent reaches both
# points once each stage's ties within TIE_RTOL are broken either way
# and each side's reported power is the replay's final measurement at
# its point within 2 * EVAL_RTOL, the move still within AGREE_STEPS and
# sigma within MOVED_SIGMA (a near-tie at an earlier stage sent the two
# descents to different final grids, whose maxima the bound does not
# cover: the open fault of ROADMAP queue 3), and unexplained otherwise.
# The flag stands either way.  TIE_RTOL is about eight times the
# largest two-evaluator difference.
AGREE_STEPS = 2 * GRID_G
SAME_POWER_RTOL = 1e-4
SAME_SIGMA = 1e-3
MOVED_SIGMA = 1e-2
EVAL_RTOL = 2e-6
TIE_RTOL = 1e-5
JERK_EVAL_RTOL = 2e-5
JERK_TIE_RTOL = 1.6e-4


def _point(c, jerk):
    return (c.r, c.z, c.w) if jerk else (c.r, c.z)


def _in_reach(reach, c, jerk=False) -> bool:
    ok = np.ones(len(reach), bool)
    for a, v in enumerate(_point(c, jerk)):
        ok &= np.abs(reach[:, a] - v) <= 1e-9 * max(1.0, abs(v))
    return bool(ok.any())


def _taylor_bound(P0, st_, d, grad):
    """sum_i |g_i| d_i + 1/2 sum_ij |H_ij| d_i d_j, with the gradient g
    (when ``grad``) and the Hessian H by central differences of the
    stencil values st_ (keyed by offset tuples of one step) around P0, in
    step units; d the move's size in steps, one array an axis."""
    naxes = len(d)
    out = np.zeros_like(P0)
    for a in range(naxes):
        e = tuple(int(x == a) for x in range(naxes))
        m = tuple(-x for x in e)
        if grad:
            out = out + np.abs(st_[e] - st_[m]) / 2 * d[a]
        out = out + np.abs(st_[e] + st_[m] - 2 * P0) / 2 * d[a] ** 2
        for b in range(a + 1, naxes):
            def o(sa, sb):
                return tuple(sa if x == a else sb if x == b else 0
                             for x in range(naxes))
            out = out + np.abs(st_[o(1, 1)] - st_[o(1, -1)] - st_[o(-1, 1)]
                               + st_[o(-1, -1)]) / 4 * d[a] * d[b]
    return out


def _curvature_loss(P0, st_):
    """L = sum_ij |H_ij| h_i h_j / 8: how far below the peak a grid
    maximum of the stencil's step can lie (half a step on each axis)."""
    naxes = len(next(iter(st_)))
    return _taylor_bound(P0, st_, [0.5] * naxes, grad=False)


def agreement(amps, want, got, seeds=None, jerk=False, harmpolish=True,
              numindep=None, device="cpu") -> dict:
    """Hold ``got`` against ``want`` (two polished lists of the same
    candidates, in the same order, on spectrum ``amps``; ``seeds`` the
    unpolished candidates of the one batch both polished, when known;
    ``jerk`` for the jerk polish's (r, z, w) candidates, whose seeds and
    ``numindep`` (the polish's, per stage) it needs) by the rule above.
    Returns {"ok", "moved", "moved_ok", "tie_paths", "unexplained",
    "worst", "flags"}: ``moved_ok`` lists the candidates that moved
    within the rule; ``worst`` holds the largest same-point power and
    sigma differences, the largest move in final-stage steps and the
    largest power gap over its bound; each entry of ``flags`` names a candidate
    that broke the rule, with its numbers (and, given the seeds, the
    replay's: ``tie_path`` true or false); ``tie_paths`` counts the
    flags that are tie paths, ``unexplained`` the others."""
    if jerk and (seeds is None or numindep is None):
        raise ValueError("agreement: the jerk rule needs the seeds and "
                         "numindep")
    amps = (amps.detach().cpu() if isinstance(amps, torch.Tensor)
            else amps)
    out = dict(ok=True, moved=0, moved_ok=[], tie_paths=0, unexplained=0,
               flags=[], worst=dict(power_rel=0.0, sigma=0.0, steps=0.0,
                                    gap_over_bound=0.0))
    worst = out["worst"]
    if len(want) != len(got):
        out["flags"].append(dict(i=-1, why="length", want=len(want),
                                 got=len(got)))
    moved = []
    for i, (a, b) in enumerate(zip(want, got)):
        if a.numharm != b.numharm:
            out["flags"].append(dict(i=i, why="numharm", want=a.numharm,
                                     got=b.numharm))
            continue
        if all(abs(x - y) < 1e-9 for x, y in zip(_point(a, jerk),
                                                  _point(b, jerk))):
            dp = abs(a.power - b.power) / abs(a.power)
            ds = abs(a.sigma - b.sigma)
            worst["power_rel"] = max(worst["power_rel"], dp)
            worst["sigma"] = max(worst["sigma"], ds)
            if dp > SAME_POWER_RTOL or ds > SAME_SIGMA:
                out["flags"].append(dict(i=i, why="same point", power_rel=dp,
                                         sigma=ds))
        else:
            moved.append(i)
    out["moved"] = len(moved)
    if not moved:
        out["ok"] = not out["flags"]
        out["unexplained"] = len(out["flags"])
        return out
    nh = np.array([want[i].numharm for i in moved])
    h = list(final_steps(nh)) + ([final_step_w(nh)] if jerk else [])
    naxes = len(h)
    offs = [tuple(x - 1 for x in o) for o in np.ndindex(*(3,) * naxes)
            if any(x != 1 for x in o)]
    A = np.array([_point(want[i], jerk) for i in moved]).T   # [axes, m]
    B = np.array([_point(got[i], jerk) for i in moved]).T
    pts = [A, B] + [A + np.array(o)[:, None] * np.array(h) for o in offs]
    if jerk:
        # the descent's objective with each seed's windows and weights,
        # and the final measurement, at every point
        amp_pairs = _as_pairs(amps, device)
        W, npts = batch_geometry(seeds, True)
        P = np.zeros((len(pts), len(moved)))
        F = np.zeros((len(pts), len(moved)))
        for k, i in enumerate(moved):
            sw = SeedWindows(amp_pairs, seeds[i], W, npts, True, harmpolish)
            P[:, k], F[:, k] = sw.measures(np.stack([p[:, k] for p in pts]))
    else:
        zmax = max(abs(c.z) * c.numharm for c in list(want) + list(got))
        P = joint_powers(amps, np.concatenate([p[0] for p in pts]),
                         np.concatenate([p[1] for p in pts]),
                         np.tile(nh, len(pts)), zmax_pairs=zmax,
                         device=device).reshape(len(pts), len(moved))
    L = _curvature_loss(P[0], {o: P[2 + k] for k, o in enumerate(offs)})
    eval_rtol = JERK_EVAL_RTOL if jerk else EVAL_RTOL
    bound = L + 2 * eval_rtol * np.abs(P[0])
    d = [np.abs(B[x] - A[x]) / h[x] for x in range(naxes)]
    if jerk:
        # the change of the final measurement across each move
        fbound = _taylor_bound(F[0], {o: F[2 + k] for k, o in
                                      enumerate(offs)}, d, grad=True)
        fbound += eval_rtol * np.abs(F[0]) * (
            6 + sum(d) + 2 * sum(x * x for x in d)
            + sum(d[x] * d[y] for x in range(naxes)
                  for y in range(x + 1, naxes)))
    for k, i in enumerate(moved):
        a, b = want[i], got[i]
        steps = max(d[x][k] for x in range(naxes))
        gap = abs(P[0, k] - P[1, k])
        ds = abs(a.sigma - b.sigma)
        if jerk:
            rep = max(abs(c.power - f) / abs(f)
                      for c, f in zip((a, b), F[:2, k]))
            rgap = abs(a.power - b.power)
            lo = min(a.power, b.power)
            stage = int(np.log2(a.numharm))
            sig_bound = SAME_SIGMA + float(np.diff(st.candidate_sigma(
                np.array([lo, lo + fbound[k]]), a.numharm,
                numindep[stage]))[0])
            # the two sides' reported power and sigma across the move
            move_bad = rgap > fbound[k] or ds > sig_bound
            rep_bad = rep > 2 * eval_rtol
            worst["gap_over_bound"] = max(worst["gap_over_bound"],
                                          gap / bound[k], rgap / fbound[k])
        else:
            rep = abs(a.power - b.power)
            rep_bad = rep > bound[k]
            move_bad = ds > MOVED_SIGMA
            worst["gap_over_bound"] = max(worst["gap_over_bound"],
                                          gap / bound[k], rep / bound[k])
        worst["steps"] = max(worst["steps"], steps)
        if not (steps > AGREE_STEPS + 1e-6 or gap > bound[k] or rep_bad
                or move_bad):
            out["moved_ok"].append(i)
            continue
        flag = dict(i=i, why="moved", sigma_a=a.sigma, steps=steps,
                    power_a=P[0, k], power_b=P[1, k], gap=gap,
                    bound=bound[k], curvature_loss=L[k],
                    reported_gap=rep, sigma=ds)
        if jerk:
            flag.update(reported_power_gap=rgap, reported_bound=fbound[k],
                        sigma_bound=sig_bound)
        if seeds is not None:
            (reach, pw), = descent_replay(
                amps, [seeds[i]], JERK_TIE_RTOL if jerk else TIE_RTOL,
                points=[[_point(a, jerk), _point(b, jerk)]], batch=seeds,
                jerk=jerk, harmpolish=harmpolish, device=device)
            rel = [abs(c.power - p) / abs(p) for c, p in zip((a, b), pw)]
            flag.update(reach=len(reach),
                        a_reached=_in_reach(reach, a, jerk),
                        b_reached=_in_reach(reach, b, jerk),
                        replay_power_rel=max(rel))
            flag["tie_path"] = bool(
                flag["a_reached"] and flag["b_reached"]
                and max(rel) <= 2 * eval_rtol
                and steps <= AGREE_STEPS + 1e-6 and not move_bad)
            out["tie_paths"] += flag["tie_path"]
        out["flags"].append(flag)
    out["ok"] = not out["flags"]
    out["unexplained"] = len(out["flags"]) - out["tie_paths"]
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
