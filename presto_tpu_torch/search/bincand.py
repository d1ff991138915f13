"""Binary-candidate optimization via orbital matched filtering.

PyTorch counterpart of ``presto_tpu/search/bincand.py``.  Reference:
src/bincand.c — given a trial orbit (from a pulsar-catalog entry, a .mak
file, or a rawbincand from search_bin), generate gen_bin_response
templates over a grid of (p_orb, x, t_periastron) around the trial and
correlate each against the big FFT near the pulsar spin bin, keeping the
orbit that recovers the most power.  Grid steps follow bincand.c's
empirical orbit_step power laws (:13-37) and the +/-3-step bracket
(:179-196).

All templates of a refinement round are one batched correlation on the
device (``_corr_max``): the template FFTs times the data segment's FFT,
inverse FFT, |.|^2 and the max over lag, in complex64 as the JAX package
computes it.  Template synthesis (vectorized Kepler solve + rfft per
template, ops/responses.gen_bin_responses) and the grid walk stay on the
host in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from itertools import product
from typing import List

import numpy as np
import torch

from presto_tpu_torch.ops.orbit import OrbitParams, TWOPI
from presto_tpu_torch.ops.responses import (bin_resp_halfwidth,
                                            gen_bin_responses, next_pow2)
from presto_tpu_torch.ops.stats import candidate_sigma
from presto_tpu_torch.search.accel import resolve_device


def orbit_step(orb: OrbitParams, ppsr: float, param: str) -> float:
    """Empirical grid step sizes (bincand.c:13-37)."""
    phiorb = TWOPI * orb.x / ppsr
    if param in "pP":
        return orb.p * np.exp(0.9792168 * np.log(orb.p / phiorb)
                              - 10.9658871)
    if param in "xX":
        return orb.x * np.exp(0.9572412 * np.log(1.0 / phiorb)
                              + 0.7110553)
    if param == "e":
        return 0.016
    if param == "w":
        return 0.8
    if param in "tT":
        return orb.p * np.exp(0.9420009 * np.log(1.0 / phiorb)
                              - 1.1676730)
    raise ValueError(param)


def _corr_max(seg_pairs: torch.Tensor, tmpl_pairs: torch.Tensor,
              fftlen: int):
    """Batched matched filter: max correlation power per template.

    seg_pairs: [nseg, 2] data segment; tmpl_pairs: [T, numkern, 2]
    (already normalized), float32 on one device.  Returns (maxpow[T],
    argmax[T]) over the valid lags, the first lag on a tie (the
    jnp.argmax rule; torch.max's too)."""
    seg = torch.complex(seg_pairs[:, 0], seg_pairs[:, 1])
    tmpl = torch.complex(tmpl_pairs[..., 0], tmpl_pairs[..., 1])
    nseg = seg.shape[0]
    numkern = tmpl.shape[1]
    segf = torch.fft.fft(seg, n=fftlen)
    tmplf = torch.fft.fft(tmpl.flip(-1).conj_physical(), n=fftlen, dim=-1)
    corr = torch.fft.ifft(segf[None, :] * tmplf, dim=-1)
    # lag k of the valid range: template aligned at data offset k
    valid = corr[:, numkern - 1:nseg]
    pows = valid.abs() ** 2
    return pows.max(dim=-1)


@dataclass
class BinCandResult:
    orb: OrbitParams
    ppsr: float
    power: float
    r: float              # big-FFT spin bin of the peak
    sigma: float


def _make_templates(orbs: List[OrbitParams], ppsr: float, T: float,
                    numkern: int) -> np.ndarray:
    tm = gen_bin_responses(orbs, ppsr, T, numkern)
    norm = np.sqrt((np.abs(tm) ** 2).sum(axis=-1, keepdims=True))
    tm = tm / np.where(norm > 0, norm, 1.0)
    return np.stack([tm.real, tm.imag], -1).astype(np.float32)


def optimize_bincand(fft_pairs: np.ndarray, N: float, dt: float,
                     trial_orb: OrbitParams, ppsr: float,
                     nsteps: int = 3, rounds: int = 2,
                     search_t: bool = True,
                     device="cuda") -> BinCandResult:
    """Refine (p_orb, x[, t]) of a binary candidate on the big FFT.

    fft_pairs: [nbins, 2] float32 spectrum (packed-.fft loader output)
    on the host.  Runs `rounds` rounds of a (2*nsteps+1)^d coordinate
    grid shrinking by 3x each round (bincand.c's +/-3-sigma bracket made
    batch-parallel), each round's correlation on ``device``.  Returns the
    best-fit orbit and its matched power.
    """
    dev = resolve_device(device)
    T = N * dt
    r0 = T / ppsr
    halfwidth = bin_resp_halfwidth(ppsr, T, trial_orb)
    numkern = max(int(next_pow2(2 * halfwidth)), 64)
    nseg = numkern * 4
    lo = max(int(r0) - nseg // 2, 0)
    seg = np.asarray(fft_pairs[lo:lo + nseg], np.float32)
    # local-power normalization of the data segment
    segpow = (seg.astype(np.float64) ** 2).sum(-1)
    seg = seg / np.float32(np.sqrt(np.median(segpow)))
    fftlen = next_pow2(nseg + numkern)
    seg_d = torch.from_numpy(np.ascontiguousarray(seg)).to(dev)

    orb = replace(trial_orb)
    dp = orbit_step(orb, ppsr, "p")
    dx = orbit_step(orb, ppsr, "x")
    dtt = orbit_step(orb, ppsr, "t")
    best = None
    steps = np.arange(-nsteps, nsteps + 1, dtype=np.float64)
    for rnd in range(rounds):
        ps = orb.p + steps * dp
        xs = np.maximum(orb.x + steps * dx, 1e-4)
        ts = (orb.t + steps * dtt) if search_t else np.array([orb.t])
        grid = [OrbitParams(p=p, e=orb.e, x=x, w=orb.w, t=t % max(p, 1e-9))
                for p, x, t in product(ps, xs, ts)]
        tmpl = torch.from_numpy(_make_templates(grid, ppsr, T, numkern))
        pows, args = _corr_max(seg_d, tmpl.to(dev), fftlen)
        pows = pows.cpu().numpy()
        bi = int(np.argmax(pows))
        orb = grid[bi]
        peak_r = lo + int(args[bi])
        best = BinCandResult(
            orb=orb, ppsr=ppsr, power=float(pows[bi]),
            r=float(peak_r + numkern / 2),
            sigma=candidate_sigma(float(pows[bi]), 1,
                                  max(len(grid), 1)))
        dp /= 3.0
        dx /= 3.0
        dtt /= 3.0
    return best
