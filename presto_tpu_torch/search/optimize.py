"""Fourier-domain candidate refinement: interpolation, maximization,
and candidate properties.

Host copy of ``presto_tpu/search/optimize.py`` for the PyTorch port,
which imports nothing from the JAX package: the (r, z) parts and the
jerk's (r, z, w) interpolation and simplex (rzw_interp, power_at_rzw,
max_rzw_arr: the reference's per-candidate path, which the port's
accelsearch refine does not fall back to; the library and the tests
use them), and corr_rz_plane.

Parity targets (behavioral, not line-for-line):
  rz_interp            rzinterp.c:144-...   amplitude at fractional (r,z)
  corr_rz_plane        rzinterp.c:3-...     small (r,z) power patch
  max_rz_arr           maximize_rz.c:22-... simplex max of power over (r,z)
  max_rz_arr_harmonics maximize_rz.c:140    joint harmonic refinement
  get_localpower3d     characteristics.c:77
  get_derivs3d         characteristics.c:139  -> rderivs
  calc_props           characteristics.c:193  -> fourierprops

Math (derived, not transliterated): a unit-amplitude signal at
fractional bin r with drift z contributes

    X[k] = A * R(k - r; z),   R(d; z) = integral_0^1 e^{2pi i(-d u + z u^2/2)} du

to the DFT; gen_z_response (ops/responses.py) evaluates exactly R(d_i; z)
on the kernel grid d_i = (i - numkern/2)/numbetween - roffset.  Since
sum_m |R(m - frac; z)|^2 = 1 (Parseval), the matched-filter amplitude
estimate is the plain conjugate dot product

    A_hat(r, z) = sum_m X[floor(r)+m] * conj(R(m - frac(r); z)),

with interpolated power |A_hat|^2 — no extra normalization needed.
Convention check (validated in tests/test_optimize.py): r is the
MID-observation frequency — a chirp starting at bin r0 with drift z
peaks at (r0 + z/2, z), because gen_z_response centers the template at
startr = roffset - z/2 (responses.c:257).
Everything here is host-side float64 numpy: refinement touches tens of
candidates over ~100-bin windows, far below the device-dispatch
threshold (the reference also runs this single-threaded on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
from scipy.optimize import minimize

from presto_tpu_torch.ops import responses as resp
from presto_tpu_torch.ops import stats as st


# ---------------------------------------------------------------------------
# Interpolation


def _z_kernel(frac: float, z: float, accuracy: int = resp.HIGHACC):
    hw = resp.z_resp_halfwidth(z if abs(z) > 1e-4 else 0.0, accuracy)
    numkern = 2 * hw
    return resp.gen_z_response(frac, 1, z, numkern), hw


def rz_interp(amps: np.ndarray, r: float, z: float,
              accuracy: int = resp.HIGHACC) -> complex:
    """Complex amplitude of the spectrum at fractional (r, z).

    amps: complex spectrum (full, bin 0 = DC).  Out-of-range kernel
    taps read as zero (same effect as the reference's padded copies).
    """
    rint = int(np.floor(r))
    frac = r - rint
    kern, hw = _z_kernel(frac, z, accuracy)
    numkern = kern.shape[0]
    lobin = rint - numkern // 2
    lo, hi = max(lobin, 0), min(lobin + numkern, amps.shape[0])
    if hi <= lo:
        return 0.0 + 0.0j
    seg = np.zeros(numkern, dtype=np.complex128)
    seg[lo - lobin:hi - lobin] = amps[lo:hi]
    return complex(np.dot(seg, np.conj(kern)))


def power_at_rz(amps: np.ndarray, r: float, z: float) -> float:
    a = rz_interp(amps, r, z)
    return a.real * a.real + a.imag * a.imag


def rzw_interp(amps: np.ndarray, r: float, z: float,
               w: float) -> complex:
    """Complex amplitude at fractional (r, z, w): the jerk dimension
    through gen_w_response (rzwinterp.c's role; w = fdotdot T^3)."""
    if abs(w) < 1e-6:
        return rz_interp(amps, r, z)
    rint = int(np.floor(r))
    frac = r - rint
    hw = resp.w_resp_halfwidth(z, w, resp.HIGHACC)
    numkern = 2 * hw
    kern = resp.gen_w_response(frac, 1, z, w, numkern)
    lobin = rint - numkern // 2
    lo, hi = max(lobin, 0), min(lobin + numkern, amps.shape[0])
    if hi <= lo:
        return 0.0 + 0.0j
    seg = np.zeros(numkern, dtype=np.complex128)
    seg[lo - lobin:hi - lobin] = amps[lo:hi]
    return complex(np.dot(seg, np.conj(kern)))


def power_at_rzw(amps: np.ndarray, r: float, z: float,
                 w: float) -> float:
    a = rzw_interp(amps, r, z, w)
    return a.real * a.real + a.imag * a.imag


def corr_rz_plane(amps: np.ndarray, rlo: float, rhi: float, dr: float,
                  zlo: float, zhi: float, dz: float) -> np.ndarray:
    """Power patch P[iz, ir] over an (r, z) grid (explorefft-style zoom;
    reference corr_rz_plane rzinterp.c:3)."""
    rs = np.arange(rlo, rhi + dr * 0.5, dr)
    zs = np.arange(zlo, zhi + dz * 0.5, dz)
    out = np.empty((zs.size, rs.size))
    for i, z in enumerate(zs):
        for j, r in enumerate(rs):
            out[i, j] = power_at_rz(amps, r, z)
    return out


# ---------------------------------------------------------------------------
# Maximization


def max_rz_arr(amps: np.ndarray, rin: float, zin: float):
    """Refine (r, z) to the local power maximum (Nelder-Mead on -power,
    the reference's amoeba maximize_rz.c:22).  Returns (rmax, zmax, power).
    """
    def neg(x):
        return -power_at_rz(amps, x[0], x[1])

    res = minimize(neg, np.array([rin, zin]), method="Nelder-Mead",
                   options={"xatol": 1e-5, "fatol": 1e-8,
                            "initial_simplex": np.array(
                                [[rin, zin], [rin + 0.4, zin],
                                 [rin, zin + 0.8]])})
    r, z = res.x
    return float(r), float(z), float(-res.fun)


def max_rzw_arr(amps: np.ndarray, rin: float, zin: float,
                win: float = 0.0):
    """Refine (r, z, w) to the local power maximum (maximize_rzw.c's
    amoeba as a 3-D Nelder-Mead), launched with both w-step signs (the
    surface from a w = 0 seed often has a shoulder); the better solution
    wins.  Returns (r, z, w, power)."""
    def neg(x):
        return -power_at_rzw(amps, x[0], x[1], x[2])

    best = None
    for wstep in (20.0, -20.0):
        res = minimize(
            neg, np.array([rin, zin, win]), method="Nelder-Mead",
            options={"xatol": 1e-5, "fatol": 1e-8,
                     "initial_simplex": np.array(
                         [[rin, zin, win],
                          [rin + 0.4, zin, win],
                          [rin, zin + 0.8, win],
                          [rin, zin, win + wstep]])})
        if best is None or res.fun < best.fun:
            best = res
    r, z, w = best.x
    return float(r), float(z), float(w), float(-best.fun)


def max_rz_arr_harmonics(amps: np.ndarray, rin: float, zin: float,
                         numharm: int, locpows: Optional[Sequence[float]]
                         = None):
    """Jointly refine the fundamental (r, z) maximizing the sum of
    locpow-normalized harmonic powers (maximize_rz.c:140).  Returns
    (rmax, zmax, [per-harmonic power at the solution])."""
    if locpows is None:
        locpows = [1.0] * numharm

    def neg(x):
        tot = 0.0
        for h in range(1, numharm + 1):
            tot += power_at_rz(amps, x[0] * h, x[1] * h) / locpows[h - 1]
        return -tot

    res = minimize(neg, np.array([rin, zin]), method="Nelder-Mead",
                   options={"xatol": 1e-6, "fatol": 1e-8,
                            "initial_simplex": np.array(
                                [[rin, zin], [rin + 0.4 / numharm, zin],
                                 [rin, zin + 0.8 / numharm]])})
    r, z = res.x
    pows = [power_at_rz(amps, r * h, z * h) for h in range(1, numharm + 1)]
    return float(r), float(z), pows


# ---------------------------------------------------------------------------
# Local power & derivatives


def get_localpower(amps: np.ndarray, r: float, z: float = 0.0,
                   numavg: int = resp.NUMLOCPOWAVG,
                   delta: int = resp.DELTAAVGBINS) -> float:
    """Mean interpolated power in numavg bins flanking r at the same z,
    offset by at least delta bins (characteristics.c:77 semantics:
    average away from the peak response)."""
    # all taps share frac(r) and z: build the kernel once, slide the
    # data window by whole bins
    rint = int(np.floor(r))
    frac = r - rint
    kern, _ = _z_kernel(frac, z)
    kconj = np.conj(kern)
    numkern = kern.shape[0]
    n = amps.shape[0]

    def pow_at(off):
        lobin = rint + off - numkern // 2
        lo, hi = max(lobin, 0), min(lobin + numkern, n)
        if hi <= lo:
            return 0.0
        seg = np.zeros(numkern, dtype=np.complex128)
        seg[lo - lobin:hi - lobin] = amps[lo:hi]
        a = np.dot(seg, kconj)
        return a.real * a.real + a.imag * a.imag

    tot = 0.0
    half = numavg // 2
    for i in range(half):
        tot += pow_at(-delta - i)
        tot += pow_at(delta + i)
    return max(tot / (2 * half), 1e-30)


def spectrum_local_powers(amps: np.ndarray,
                          numavg: int = resp.NUMLOCPOWAVG,
                          delta: int = resp.DELTAAVGBINS) -> np.ndarray:
    """Running local power for EVERY bin: mean raw power of the
    numavg/2 bins on each side offset by >= delta — the
    get_localpower window applied spectrum-wide at integer bins
    (the -locpow normalization; reference corr_loc_pow,
    corr_routines.c:309).  Out-of-range taps contribute zero and the
    divisor stays numavg, matching pow_at's edge behavior."""
    p = (amps.real.astype(np.float64) ** 2
         + amps.imag.astype(np.float64) ** 2)
    n = p.size
    c = np.concatenate([[0.0], np.cumsum(p)])
    half = numavg // 2
    i = np.arange(n)

    def winsum(lo, hi):
        """sum p[lo..hi] inclusive with clipping."""
        lo = np.clip(lo, 0, n)
        hi = np.clip(hi + 1, 0, n)
        return c[np.maximum(hi, lo)] - c[lo]

    tot = winsum(i - delta - half + 1, i - delta) \
        + winsum(i + delta, i + delta + half - 1)
    return np.maximum(tot / numavg, 1e-30)


@dataclass
class RDerivs:
    """Local derivatives of power/phase at a peak
    (reference rderivs, include/presto.h)."""
    pow: float = 0.0
    phs: float = 0.0
    dpow: float = 0.0
    dphs: float = 0.0
    d2pow: float = 0.0
    d2phs: float = 0.0
    locpow: float = 1.0


def get_derivs(amps: np.ndarray, r: float, z: float,
               locpow: Optional[float] = None, h: float = 0.05) -> RDerivs:
    """Central finite differences of power and phase along r at (r, z)
    (characteristics.c:139)."""
    if locpow is None:
        locpow = get_localpower(amps, r, z)
    amid = rz_interp(amps, r, z)
    alo = rz_interp(amps, r - h, z)
    ahi = rz_interp(amps, r + h, z)

    def pw(a):
        return (a.real * a.real + a.imag * a.imag) / locpow

    pmid, plo, phi = pw(amid), pw(alo), pw(ahi)
    phmid = np.angle(amid)
    # unwrap the flanking phases around the center
    phlo = phmid + np.angle(alo * np.conj(amid))
    phhi = phmid + np.angle(ahi * np.conj(amid))
    return RDerivs(
        pow=pmid, phs=phmid,
        dpow=(phi - plo) / (2 * h),
        dphs=(phhi - phlo) / (2 * h),
        d2pow=(phi - 2 * pmid + plo) / (h * h),
        d2phs=(phhi - 2 * phmid + phlo) / (h * h),
        locpow=locpow)


# ---------------------------------------------------------------------------
# Candidate properties

# For a pure tone, P(r)/P0 = sinc^2(pi(r-r0)) ~ 1 - (pi^2/3)(r-r0)^2, so
# -d2pow/pow = 2 pi^2 / 3 at the peak; purity is the peak's width
# relative to that (pur = 1 pure tone, < 1 broadened, > 1 over-resolved).
_PURE_TONE_CURV = 2.0 * np.pi * np.pi / 3.0


@dataclass
class FourierProps:
    """Measured properties of a refined candidate (reference
    fourierprops, include/presto.h; calc_props characteristics.c:193).
    Errors are the standard Fourier-peak formulas (Middleditch 1976,
    as used by the reference): sigma_r = 3/(pi sqrt(6 P)) / pur,
    sigma_z = 3 sqrt(10)/(pi sqrt(P)) / pur, sigma_phi = 1/(2 sqrt(P)),
    with P the locpow-normalized peak power."""
    r: float = 0.0
    rerr: float = 0.0
    z: float = 0.0
    zerr: float = 0.0
    w: float = 0.0
    werr: float = 0.0
    pow: float = 0.0       # locpow-normalized peak power
    powerr: float = 0.0
    sig: float = 0.0
    rawpow: float = 0.0
    phs: float = 0.0
    phserr: float = 0.0
    cen: float = 0.0
    cenerr: float = 0.0
    pur: float = 1.0
    purerr: float = 0.0
    locpow: float = 1.0


def calc_props(d: RDerivs, r: float, z: float, w: float = 0.0
               ) -> FourierProps:
    P = max(d.pow, 1e-12)
    curv = -d.d2pow / P
    pur = float(np.sqrt(max(curv, 0.0) / _PURE_TONE_CURV))
    pur = pur if pur > 0.05 else 1.0
    rerr = 3.0 / (np.pi * pur * np.sqrt(6.0 * P))
    zerr = 3.0 * np.sqrt(10.0) / (np.pi * pur * pur * np.sqrt(P))
    # time centroid of the signal within the observation, as a fraction:
    # phase slope dphi/dr = -2 pi cen (a full-length tone has slope -pi,
    # cen = 0.5 = mid-observation)
    cen = float(-d.dphs / (2.0 * np.pi))
    return FourierProps(
        r=r, rerr=rerr, z=z, zerr=zerr, w=w, werr=0.0,
        pow=P, powerr=float(np.sqrt(2.0 * P + 1.0)),
        rawpow=P * d.locpow,
        phs=float(d.phs), phserr=float(0.5 / np.sqrt(P)),
        cen=cen, cenerr=float(1.0 / np.sqrt(24.0 * P)), pur=pur,
        purerr=float(1.0 / (pur * np.sqrt(10.0 * P))),
        locpow=d.locpow)


# ---------------------------------------------------------------------------
# Accelsearch candidate refinement


@dataclass
class OptimizedCand:
    """An accelsearch candidate after Fourier-domain refinement
    (optimize_accelcand accel_utils.c:465-525)."""
    r: float
    z: float
    power: float            # summed normalized power over harmonics
    sigma: float
    numharm: int
    hpows: List[float] = field(default_factory=list)
    props: List[FourierProps] = field(default_factory=list)
    w: float = 0.0          # jerk refinement result (0 = no w search)

    def freq(self, T: float) -> float:
        return self.r / T


def optimize_accelcand(amps: np.ndarray, cand, T: float,
                       numindep: Sequence[float],
                       harmpolish: bool = True) -> OptimizedCand:
    """Refine one raw search candidate: joint harmonic (r, z) max,
    per-harmonic local powers and properties, final summed-power sigma.

    cand: search.accel.AccelCand (fundamental r, z, numharm).
    numindep: per-stage independent-trial counts from the search.
    harmpolish=False optimizes the fundamental's power only (the
    reference's -noharmpolish; the joint harmonic simplex is default).
    """
    nh = cand.numharm
    locpows = [get_localpower(amps, cand.r * h, cand.z * h)
               for h in range(1, nh + 1)]
    if harmpolish:
        r, z, _ = max_rz_arr_harmonics(amps, cand.r, cand.z, nh,
                                       locpows)
    else:
        r, z, _ = max_rz_arr(amps, cand.r, cand.z)
    # re-measure local powers at the refined peak before the final
    # normalization (the pre-refinement windows can sit several bins off)
    locpows = [get_localpower(amps, r * h, z * h)
               for h in range(1, nh + 1)]
    rawpows = [power_at_rz(amps, r * h, z * h) for h in range(1, nh + 1)]
    hpows = [rawpows[h - 1] / locpows[h - 1] for h in range(1, nh + 1)]
    total = float(sum(hpows))
    stage = int(np.log2(nh))
    sigma = float(st.candidate_sigma(total, nh, numindep[stage]))
    props = []
    for h in range(1, nh + 1):
        d = get_derivs(amps, r * h, z * h, locpows[h - 1])
        props.append(calc_props(d, r * h, z * h))
    return OptimizedCand(r=float(r), z=float(z), power=total, sigma=sigma,
                         numharm=nh, hpows=hpows, props=props)
