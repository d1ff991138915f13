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
from presto_tpu_torch.search.accel import (check_full_f32_matmul,
                                           resolve_device)
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
    grid = _StageGrid(wmat, cand_of, hh, frac0, zseed, inv_lp * obj_w,
                      ncand)
    ar = torch.arange(ncand, device=dev)
    dr = torch.zeros(ncand, dtype=torch.float32, device=dev)
    dz = torch.zeros(ncand, dtype=torch.float32, device=dev)
    for div in STAGE_DIVISORS:
        obj, rs, zs = grid.objective(dr, dz, step0_r / div, step0_z / div)
        best = torch.argmax(obj, dim=-1)     # first maximum, as jnp.argmax
        dr, dz = rs[ar, best], zs[ar, best]
    return dr, dz


# each argmax stage's step divisor: the stage-0 walk re-centres twice at
# the coarse step (so a seed near the cell edge still captures its
# peak), then the step shrinks SHRINK-fold a stage
STAGE_DIVISORS = (1.0, 1.0) + tuple(SHRINK ** s for s in range(1, N_STAGES))


class _StageGrid:
    """The descent's objective on a stage's (2G+1)^2 grid around each
    candidate's centre: the joint harmonic sum of |A|^2 * weight, the
    harmonics added in ascending order."""

    def __init__(self, wmat, cand_of, hh, frac0, zseed, weight, ncand):
        dev = wmat.device
        G = GRID_G
        ng = 2 * G + 1
        g1 = torch.arange(-G, G + 1, dtype=torch.float32, device=dev)
        self.gi = torch.repeat_interleave(g1, ng)          # r offsets
        self.gj = g1.repeat(ng)                            # z offsets
        slot, self.width = _harmonic_slots(cand_of, ncand)
        self.cof = torch.as_tensor(np.asarray(cand_of, np.int64), device=dev)
        self.slot = torch.as_tensor(slot, device=dev)
        self.wmat, self.hh, self.frac0, self.zseed = wmat, hh, frac0, zseed
        self.weight = weight[:, None]
        self.ncand = ncand

    def objective(self, dr, dz, sr, sz):
        """(objective [ncand, ngrid2], r offsets, z offsets) of the grid
        of steps (sr, sz) around the centres (dr, dz)."""
        cof, hh = self.cof, self.hh
        rs = dr[:, None] + sr[:, None] * self.gi[None]     # [ncand, ngrid2]
        zs = dz[:, None] + sz[:, None] * self.gj[None]
        frp = self.frac0[:, None] + rs[cof] * hh[:, None]
        zhp = (self.zseed[cof][:, None] + zs[cof]) * hh[:, None]
        A = _eval_A_chunked(self.wmat, frp, zhp)
        P2 = (A.real * A.real + A.imag * A.imag) * self.weight
        slots = torch.zeros((self.ncand, self.width, P2.shape[1]),
                            dtype=P2.dtype, device=P2.device)
        slots[cof, self.slot] = P2
        obj = slots[:, 0]
        for j in range(1, self.width):       # ascending harmonic order
            obj = obj + slots[:, j]
        return obj, rs, zs


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


def final_steps(numharm) -> tuple:
    """(r, z) grid steps of the descent's last stage, fundamental units,
    for candidates of ``numharm`` harmonics."""
    shrink = SHRINK ** (N_STAGES - 1)
    nh = np.asarray(numharm, np.float64)
    return STEP0_R / nh / shrink, STEP0_Z / nh / shrink


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


def descent_replay(amps, seeds, tie_rtol, points=(), zmax_pairs=None,
                   device="cpu"):
    """Replay the grid descent of optimize_accelcands (harmpolish on)
    for each seed candidate, letting every stage's argmax be any grid
    point whose objective lies within ``tie_rtol`` of the stage's
    maximum (relative): the final points the descent can reach when its
    near-ties are broken either way.  ``points`` (one list of (r, z) per
    seed) are measured as the polish's final measurement measures its
    peak.  The window geometry is that of optimize_accelcands over a
    batch whose largest |z h| is ``zmax_pairs`` (by default the seeds').
    Returns, per seed, (reachable (r, z) float64 [k, 2], the powers of
    its ``points``)."""
    amp_pairs = _as_pairs(amps, device)
    dev = amp_pairs.device

    def t(a):
        return torch.as_tensor(a, device=dev)
    if zmax_pairs is None:
        zmax_pairs = max(abs(float(c.z)) * c.numharm for c in seeds)
    W, npts = _geometry(float(zmax_pairs) + STEP0_Z * GRID_G + 1.0)
    out = []
    for k, c in enumerate(seeds):
        nh = int(c.numharm)
        hh = np.arange(1, nh + 1).astype(np.float32)
        rint = np.floor(c.r * hh.astype(np.float64)).astype(np.int32)
        frac0 = (c.r * hh.astype(np.float64) - rint).astype(np.float32)
        z32 = np.float32(c.z)
        wmat1 = _windows_to_wmat(amp_pairs, t(rint), W, npts)
        _, lp0 = _final_measures(wmat1, t(frac0), t(z32 * hh))
        step0 = (np.float32(STEP0_R / nh), np.float32(STEP0_Z / nh))
        dr = torch.zeros(1, dtype=torch.float32, device=dev)
        dz = torch.zeros(1, dtype=torch.float32, device=dev)
        for div in STAGE_DIVISORS:
            ncent = dr.shape[0]
            grid = _StageGrid(wmat1.repeat(ncent, 1),
                              np.repeat(np.arange(ncent), nh),
                              t(np.tile(hh, ncent)), t(np.tile(frac0, ncent)),
                              t(np.full(ncent, z32)),
                              (1.0 / lp0).repeat(ncent), ncent)
            sr = torch.full((ncent,), float(step0[0]), dtype=torch.float32,
                            device=dev) / div
            sz = torch.full((ncent,), float(step0[1]), dtype=torch.float32,
                            device=dev) / div
            obj, rs, zs = grid.objective(dr, dz, sr, sz)
            top = obj.max(dim=-1, keepdim=True).values
            keep = obj >= top - tie_rtol * top.abs()
            cand = torch.stack([rs[keep], zs[keep], obj[keep]], -1).cpu()
            seen = {}
            for r_, z_, o_ in cand.numpy():
                key = (np.float32(r_).tobytes(), np.float32(z_).tobytes())
                seen[key] = max(seen.get(key, -np.inf), float(o_))
            best = sorted(seen.items(), key=lambda kv: -kv[1])[:64]
            dr = t(np.array([np.frombuffer(kk[0], np.float32)[0]
                             for kk, _ in best], np.float32))
            dz = t(np.array([np.frombuffer(kk[1], np.float32)[0]
                             for kk, _ in best], np.float32))
        reach = np.stack([c.r + dr.cpu().numpy().astype(np.float64),
                          c.z + dz.cpu().numpy().astype(np.float64)], -1)
        pts = np.asarray(points[k] if points else [], np.float64).reshape(
            -1, 2)
        pows = np.zeros(len(pts))
        if len(pts):
            npt = len(pts)
            frf = (pts[:, 0:1] * hh.astype(np.float64) - rint).astype(
                np.float32).ravel()
            zhf = (pts[:, 1:2] * hh).astype(np.float32).ravel()
            A3, lpf = _final_measures(wmat1.repeat(npt, 1), t(frf), t(zhf))
            A0 = A3[:, 0].cpu().numpy().astype(np.complex128)
            hp = (A0.real ** 2 + A0.imag ** 2) \
                / lpf.cpu().numpy().astype(np.float64)
            pows = hp.reshape(npt, nh).sum(-1)
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


def _in_reach(reach, c) -> bool:
    return bool(np.any((np.abs(reach[:, 0] - c.r) <= 1e-9 * max(1.0, abs(c.r)))
                       & (np.abs(reach[:, 1] - c.z) <= 1e-9
                          * max(1.0, abs(c.z)))))


def agreement(amps, want, got, seeds=None, device="cpu") -> dict:
    """Hold ``got`` against ``want`` (two polished lists of the same
    candidates, in the same order, on spectrum ``amps``; ``seeds`` the
    unpolished candidates of the one batch both polished, when known)
    by the rule above.  Returns
    {"ok", "moved", "tie_paths", "unexplained", "worst", "flags"}:
    ``worst`` holds the largest same-point power and sigma differences,
    the largest move in final-stage steps and the largest power gap over
    its bound; each entry of ``flags`` names a candidate that broke the
    rule, with its numbers (and, given the seeds, the replay's:
    ``tie_path`` true or false); ``tie_paths`` counts the flags that are
    tie paths, ``unexplained`` the others."""
    amps = (amps.detach().cpu() if isinstance(amps, torch.Tensor)
            else amps)
    out = dict(ok=True, moved=0, tie_paths=0, unexplained=0, flags=[],
               worst=dict(power_rel=0.0, sigma=0.0, steps=0.0,
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
        if abs(a.r - b.r) < 1e-9 and abs(a.z - b.z) < 1e-9:
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
    if moved:
        hr, hz = final_steps([want[i].numharm for i in moved])
        ar = np.array([want[i].r for i in moved])
        az = np.array([want[i].z for i in moved])
        nh = np.array([want[i].numharm for i in moved])
        # points per candidate: a, b, then a's 3 x 3 stencil less a
        offs = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)
                if (u, v) != (0, 0)]
        pr = [ar, np.array([got[i].r for i in moved])] + \
            [ar + u * hr for u, _v in offs]
        pz = [az, np.array([got[i].z for i in moved])] + \
            [az + v * hz for _u, v in offs]
        zmax = max(abs(c.z) * c.numharm for c in list(want) + list(got))
        P = joint_powers(amps, np.concatenate(pr), np.concatenate(pz),
                         np.tile(nh, len(pr)), zmax_pairs=zmax,
                         device=device).reshape(len(pr), len(moved))
        st_ = {o: P[2 + k] for k, o in enumerate(offs)}
        P0 = P[0]
        Hrr = (st_[(1, 0)] + st_[(-1, 0)] - 2 * P0) / hr ** 2
        Hzz = (st_[(0, 1)] + st_[(0, -1)] - 2 * P0) / hz ** 2
        Hrz = (st_[(1, 1)] - st_[(1, -1)] - st_[(-1, 1)]
               + st_[(-1, -1)]) / (4 * hr * hz)
        L = (np.abs(Hrr) * hr ** 2 + 2 * np.abs(Hrz) * hr * hz
             + np.abs(Hzz) * hz ** 2) / 8
        bound = L + 2 * EVAL_RTOL * np.abs(P0)
        for k, i in enumerate(moved):
            a, b = want[i], got[i]
            steps = max(abs(a.r - b.r) / hr[k], abs(a.z - b.z) / hz[k])
            gap = abs(P[0, k] - P[1, k])
            rep = abs(a.power - b.power)
            ds = abs(a.sigma - b.sigma)
            worst["steps"] = max(worst["steps"], steps)
            worst["gap_over_bound"] = max(worst["gap_over_bound"],
                                          gap / bound[k], rep / bound[k])
            if not (steps > AGREE_STEPS + 1e-6 or gap > bound[k]
                    or rep > bound[k] or ds > MOVED_SIGMA):
                continue
            flag = dict(i=i, why="moved", sigma_a=a.sigma, steps=steps,
                        power_a=P[0, k], power_b=P[1, k], gap=gap,
                        bound=bound[k], curvature_loss=L[k],
                        reported_gap=rep, sigma=ds)
            if seeds is not None:
                (reach, pw), = descent_replay(
                    amps, [seeds[i]], TIE_RTOL,
                    points=[[(a.r, a.z), (b.r, b.z)]],
                    zmax_pairs=max(abs(float(c.z)) * c.numharm
                                   for c in seeds), device=device)
                rel = [abs(c.power - p) / abs(p) for c, p in zip((a, b), pw)]
                flag.update(reach=len(reach), a_reached=_in_reach(reach, a),
                            b_reached=_in_reach(reach, b),
                            replay_power_rel=max(rel))
                flag["tie_path"] = bool(
                    flag["a_reached"] and flag["b_reached"]
                    and max(rel) <= 2 * EVAL_RTOL
                    and steps <= AGREE_STEPS + 1e-6 and ds <= MOVED_SIGMA)
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
