"""Fourier-domain response templates (host-side, float64 numpy).

Host copy of ``presto_tpu/ops/responses.py`` for the PyTorch port, which imports
nothing from the JAX package.

Parity targets: reference src/responses.c.
  r_resp_halfwidth      responses.c:11-27
  z_resp_halfwidth      responses.c:29-66
  w_resp_halfwidth      responses.c:68-91
  gen_r_response        responses.c:165-232  (sinc interpolation kernel)
  gen_z_response        responses.c:234-322  (constant-fdot template via
                                              Fresnel integrals)
  gen_w_response        responses.c:325-...  (fdotdot template)
  binary_velocity       responses.c:91-139
  bin_resp_halfwidth    responses.c:141-163
  gen_bin_response      responses.c:460-626  (binary-orbit template)
  place_complex_kernel  corr_prep.c:58-80    (NR wrap-around placement)
  spread_no_pad         corr_prep.c:28-40    (interbin zero interleave)

These run once at search setup in float64 (SURVEY.md §7.3 hard part 2:
Fresnel accuracy is a setup-time concern, so it stays on host at full
precision); the resulting kernel banks move to device as float32 pairs.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.special import fresnel as _fresnel

# Reference constants (include/presto.h:100-108)
NUMLOCPOWAVG = 20
DELTAAVGBINS = 5
NUMFINTBINS = 16

LOWACC, HIGHACC = 0, 1


def r_resp_halfwidth(accuracy: int = LOWACC) -> int:
    """Kernel half width (bins) for plain Fourier interpolation."""
    if accuracy == HIGHACC:
        return NUMFINTBINS * 3 + (NUMLOCPOWAVG // 2) + DELTAAVGBINS
    return NUMFINTBINS


def z_resp_halfwidth(z: float, accuracy: int = LOWACC) -> int:
    """Kernel half width (bins) for constant-fdot interpolation.

    Parity: responses.c:29-66 including the large-z clamps.
    """
    z = abs(z)
    if accuracy == HIGHACC:
        m = int(z * (0.002057 * z + 0.0377) + NUMFINTBINS * 3)
        m += (NUMLOCPOWAVG // 2) + DELTAAVGBINS
        if z > 100 and m > 1.2 * z:
            m = int(1.2 * z)
    else:
        m = int(z * (0.00089 * z + 0.3131) + NUMFINTBINS)
        m = max(m, NUMFINTBINS)
        if z > 100 and m > 0.6 * z:
            m = int(0.6 * z)
    return m


def w_resp_halfwidth(z: float, w: float, accuracy: int = LOWACC) -> int:
    """Kernel half width for linearly-varying fdot (constant fdotdot).

    The response spans the instantaneous-frequency excursion of the
    kernel's phase model nu(u) = (-z/2 + w/12) + (z - w/2) u +
    (w/2) u^2 over u in [0, 1] (the continuous model gen_w_response
    integrates), plus the interpolation wings (responses.c:68-141
    bounds the same excursion)."""
    if abs(w) < 1.0e-7:
        return z_resp_halfwidth(z, accuracy)
    nu0 = -z / 2.0 + w / 12.0
    nu1 = z / 2.0 + w / 12.0
    ext = max(abs(nu0), abs(nu1))
    if abs(w) > 1e-12:
        ustar = (w / 2.0 - z) / w
        if 0.0 < ustar < 1.0:
            nus = nu0 + (z - w / 2.0) * ustar + (w / 2.0) * ustar ** 2
            ext = max(ext, abs(nus))
    return int(np.ceil(ext)) + r_resp_halfwidth(accuracy)


def gen_r_response(roffset: float, numbetween: int,
                   numkern: int) -> np.ndarray:
    """Complex response for Fourier interpolation at fractional offset.

    Bin-zero response sits at index numkern//2 (the NR convention that
    place_complex_kernel expects).  Parity: responses.c:165-232.
    """
    assert 0.0 <= roffset < 1.0
    assert numkern >= numbetween and numkern % (2 * numbetween) == 0
    startr = np.pi * (numkern / (2.0 * numbetween) + roffset)
    delta = -np.pi / numbetween
    r = startr + np.arange(numkern, dtype=np.float64) * delta
    s, c = np.sin(r), np.cos(r)
    with np.errstate(divide="ignore", invalid="ignore"):
        sinc = np.where(r == 0.0, 1.0, s / r)
    resp = (c + 1j * s) * sinc
    if roffset < 1e-3:
        # series patch for the removable singularity at r = 0
        tmp = roffset * roffset
        resp[numkern // 2] = ((1.0 - 6.579736267392905746 * tmp)
                              + 1j * roffset *
                              (np.pi - 10.335425560099940058 * tmp))
    return resp


def gen_z_response(roffset: float, numbetween: int, z: float,
                   numkern: int) -> np.ndarray:
    """Complex response for constant-fdot (z bins of drift) interpolation.

    Built from Fresnel integrals; parity: responses.c:234-322 including
    the small-|z| series patch.  z ~ 0 falls back to gen_r_response.
    """
    assert 0.0 <= roffset < 1.0
    assert numkern >= numbetween and numkern % (2 * numbetween) == 0
    absz = abs(z)
    if absz < 1e-4:
        return gen_r_response(roffset, numbetween, numkern)

    startr = roffset - 0.5 * z
    startroffset = startr % 1.0 if startr >= 0 else 1.0 + (startr % -1.0)
    signz = -1 if z < 0.0 else 1
    zd = signz * np.sqrt(2.0) / np.sqrt(absz)
    cons = zd / 2.0
    pibyz = np.pi / z
    startr += numkern / (2.0 * numbetween)
    delta = -1.0 / numbetween

    r = startr + np.arange(numkern, dtype=np.float64) * delta
    yy = r * zd
    zz = yy + z * zd
    xx = pibyz * r * r
    c, s = np.cos(xx), np.sin(xx)
    fressy, frescy = _fresnel(yy)
    fressz, frescz = _fresnel(zz)
    tmprl = signz * (frescz - frescy)
    tmpim = fressy - fressz
    resp = ((tmprl * c - tmpim * s) - 1j * (tmprl * s + tmpim * c)) * cons

    if startroffset < 1e-3 and absz < 1e-3:
        zz2 = z * z
        xx2 = startroffset * startroffset
        m = numkern // 2
        rr = 1.0 - 0.16449340668482264365 * zz2 \
            + startroffset * 1.6449340668482264365 * z \
            + xx2 * (-6.579736267392905746 + 0.9277056288952613070 * zz2)
        ii = -0.5235987755982988731 * z \
            + startroffset * (np.pi - 0.5167712780049970029 * zz2) \
            + xx2 * (3.1006276680299820175 * z)
        resp[m] = rr + 1j * ii
    return resp


def gen_w_response(roffset: float, numbetween: int, z: float, w: float,
                   numkern: int) -> np.ndarray:
    """Response for constant fdotdot (jerk), by direct quadrature:

      resp[i] = integral_0^1 exp(2 pi i (phi(u) - nu_i u)) du,
      phi(u) = (-z/2 + w/12) u + (z/2 - w/4) u^2 + (w/6) u^3,
      nu_i  = i/numbetween - numkern/(2 numbetween) - roffset,

    which is gen_z_response at w = 0.  (The reference, responses.c:325-
    457, samples the same model at 2^17 points, FFTs and sinc-interpolates
    it.)  float64 midpoint rule at a resolution covering the template's
    highest instantaneous frequency."""
    assert 0.0 <= roffset < 1.0
    assert numkern >= numbetween and numkern % (2 * numbetween) == 0
    if abs(w) < 1e-4:
        return gen_z_response(roffset, numbetween, z, numkern)
    return gen_w_response_bank(roffset, numbetween,
                               np.asarray([z]), w, numkern)[0]


_WBANK_EXPMAT: dict = {}         # (numkern, numbetween, roffset, npts)
                                 # -> cached Fourier matrix
_WBANK_BUDGET = 2 * 2 ** 30      # bytes of cached matrices (a wmax-300
                                 # bank's matrix is ~0.5-1 GB)


def gen_w_response_bank(roffset: float, numbetween: int,
                        zs: np.ndarray, w: float,
                        numkern: int) -> np.ndarray:
    """gen_w_response for a whole z bank at once -> [len(zs), numkern].

    The [npts, numkern] Fourier matrix exp(-2 pi i u nu) depends only on
    the kernel grid, so one matrix serves every z of every w plane of a
    jerk search (cached, least recently used first out, under a byte
    budget; only roffset-0 banks, the kernel-bank builds, are cached),
    and the per-z work is one chirp table and one matrix product."""
    zs = np.asarray(zs, np.float64)
    absz = float(np.abs(zs).max()) if zs.size else 0.0
    maxfreq = (numkern / (2.0 * numbetween) + absz + abs(w) / 2.0
               + abs(roffset) + 2.0)
    npts = int(max(1 << 14, next_pow2(int(32 * maxfreq))))
    u = (np.arange(npts, dtype=np.float64) + 0.5) / npts
    ckey = (numkern, numbetween, round(roffset, 12), npts)
    expmat = _WBANK_EXPMAT.get(ckey)
    if expmat is not None:
        _WBANK_EXPMAT[ckey] = _WBANK_EXPMAT.pop(ckey)    # most recent
    else:
        i = np.arange(numkern, dtype=np.float64)
        nu = i / numbetween - numkern / (2.0 * numbetween) - roffset
        expmat = np.exp(-2j * np.pi * np.outer(u, nu))  # [npts, kern]
        if roffset == 0.0 and zs.size > 1:
            _WBANK_EXPMAT[ckey] = expmat
            used = sum(m.nbytes for m in _WBANK_EXPMAT.values())
            while used > _WBANK_BUDGET and len(_WBANK_EXPMAT) > 1:
                used -= _WBANK_EXPMAT.pop(next(iter(_WBANK_EXPMAT))).nbytes
    z_ = zs[:, None]
    phi = ((-0.5 * z_ + w / 12.0) * u[None]
           + (0.5 * z_ - 0.25 * w) * u[None] ** 2
           + (w / 6.0) * u[None] ** 3)
    sig = np.exp(2j * np.pi * phi)                      # [nz, npts]
    return (sig @ expmat) / npts


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# Reference constants (responses.c:3-4)
MIN_NUMDATA = 131072


def binary_velocity(T: float, orbit) -> tuple:
    """(min, max) orbital velocity of the pulsar during an observation,
    as a fraction of c.  Parity: binary_velocity (responses.c:91-139);
    the T < p_orb branch samples the orbit with the vectorized solver
    instead of RK4."""
    from presto_tpu_torch.ops.orbit import keplers_eqn, E_to_v, SOL
    if T >= orbit.p:
        c1 = 2.0 * np.pi * orbit.x / (
            orbit.p * np.sqrt(1.0 - orbit.e ** 2))
        c2 = orbit.e * np.cos(np.deg2rad(orbit.w))
        return c1 * (c2 - 1.0), c1 * (c2 + 1.0)
    t = orbit.t + np.linspace(0.0, T, 1025)
    v = E_to_v(keplers_eqn(t, orbit.p, orbit.e), orbit) * 1000.0 / SOL
    return float(v.min()), float(v.max())


def bin_resp_halfwidth(ppsr: float, T: float, orbit) -> int:
    """Approximate kernel halfwidth (FFT bins) for a binary response.
    Parity: bin_resp_halfwidth (responses.c:141-163)."""
    minv, maxv = binary_velocity(T, orbit)
    mv = minv if abs(minv) > abs(maxv) else maxv
    maxdevbins = abs(T * mv / (ppsr * (1.0 + mv)))
    return max(int(np.floor(1.1 * maxdevbins + 0.5)), NUMFINTBINS)


def gen_bin_response(roffset: float, numbetween: int, ppsr: float,
                     T: float, orbit, numkern: int) -> np.ndarray:
    """Fourier response of a sinusoidal pulsar in a Keplerian orbit.

    Parity target: gen_bin_response (responses.c:460-626).  The
    reference synthesizes a short normalized observation — a cosine at
    datar = numdata/4 cycles, phase-delayed by the (time-scaled) orbit
    — FFTs it, and Fourier-interpolates numbetween points per bin via
    correlation with an r-response kernel.  Here the interpolation is
    done the equivalent, simpler way: zero-pad the synthesized series
    x numbetween before the rfft (spectral interpolation identity), so
    no kernel correlation pass is needed.  The orbit solution uses the
    vectorized Kepler solver (ops/orbit.py) instead of RK4+interp.

    `orbit` is an ops.orbit.OrbitParams with p/x/t in seconds (w deg).
    Returns numkern complex amplitudes spaced 1/numbetween bins,
    centered on the unmodulated pulsar bin.
    """
    from presto_tpu_torch.ops.orbit import (OrbitParams, keplers_eqn,
                                            E_to_phib)

    assert 0.0 <= roffset < 1.0
    assert numkern >= numbetween and numkern % (2 * numbetween) == 0
    numdata = MIN_NUMDATA
    datar = numdata // 4
    if numkern > datar:
        numdata = next_pow2(numkern * 4)
        datar = numdata // 4
    dt = 1.0 / numdata
    # normalized units: observation length 1, pulsar freq datar cycles
    # (responses.c:518-527)
    norb = OrbitParams(p=orbit.p / T, e=orbit.e,
                       x=orbit.x / (ppsr * datar), w=orbit.w,
                       t=orbit.t / T)
    t = np.arange(numdata, dtype=np.float64) * dt
    E = keplers_eqn(t + norb.t, norb.p, norb.e)
    tp = t - E_to_phib(E, norb)
    data = (2.0 * dt) * np.cos(2.0 * np.pi * (datar + roffset) * tp)
    # zero-pad x numbetween == Fourier-interpolate 1/numbetween spacing
    spec = np.fft.rfft(data, n=numdata * numbetween)
    center = datar * numbetween
    begin = center - numkern // 2
    return spec[begin:begin + numkern].astype(np.complex128)


def gen_bin_responses(orbits, ppsr: float, T: float, numkern: int,
                      numbetween: int = 1, roffset: float = 0.0,
                      chunk: int = 32) -> np.ndarray:
    """Batched gen_bin_response over a list of OrbitParams.

    One vectorized Kepler solve + one batched rfft per `chunk` orbits
    (memory-bounded) instead of a per-template Python pass — the grid
    synthesis path for bincand refinement.  The chunks run on a pool of
    host threads (NumPy releases the interpreter lock in its loops); each
    is the JAX package's computation, so the bytes are its.  Returns
    [len(orbits), numkern] complex128.
    """
    norbs = len(orbits)
    numdata = MIN_NUMDATA
    datar = numdata // 4
    if numkern > datar:
        numdata = next_pow2(numkern * 4)
        datar = numdata // 4
    dt = 1.0 / numdata
    t = np.arange(numdata, dtype=np.float64) * dt
    out = np.empty((norbs, numkern), dtype=np.complex128)
    center = datar * numbetween
    begin = center - numkern // 2

    def one_chunk(c0):
        sub = orbits[c0:c0 + chunk]
        p = np.array([o.p / T for o in sub])[:, None]
        e = np.array([o.e for o in sub])[:, None]
        x = np.array([o.x / (ppsr * datar) for o in sub])[:, None]
        w = np.deg2rad(np.array([o.w for o in sub]))[:, None]
        t0 = np.array([o.t / T for o in sub])[:, None]
        M = 2.0 * np.pi * (t[None, :] + t0) / p
        E = M + e * np.sin(M)
        for _ in range(8):
            E = M + e * np.sin(E)
        for _ in range(40):
            dE = (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
            E = E - dE
            if np.max(np.abs(dE)) < 1e-14:
                break
        c1 = x * np.sin(w)
        c2 = x * np.cos(w) * np.sqrt(1.0 - e ** 2)
        phib = c1 * (np.cos(E) - e) + c2 * np.sin(E)
        tp = t[None, :] - phib
        data = (2.0 * dt) * np.cos(2.0 * np.pi * (datar + roffset) * tp)
        spec = np.fft.rfft(data, n=numdata * numbetween, axis=-1)
        out[c0:c0 + len(sub)] = spec[:, begin:begin + numkern]

    starts = range(0, norbs, chunk)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1,
                                            len(starts) or 1)) as pool:
        list(pool.map(one_chunk, starts))
    return out


def place_complex_kernel(kernel: np.ndarray, fftlen: int) -> np.ndarray:
    """Zero-filled length-fftlen array with the kernel's bin-zero point
    (index numkern/2) at index 0 and wrap-around halves (NR layout).
    Parity: corr_prep.c:58-80."""
    numkern = kernel.shape[0]
    half = numkern // 2
    out = np.zeros(fftlen, dtype=np.complex128)
    out[:half] = kernel[half:]
    out[fftlen - half:] = kernel[:half]
    return out


def spread_no_pad(data: np.ndarray, numbetween: int,
                  numresult: int) -> np.ndarray:
    """Interleave numbetween-1 zeros between complex samples.
    Parity: corr_prep.c:28-40."""
    out = np.zeros(numresult, dtype=data.dtype)
    n = min(numresult // numbetween, data.shape[0])
    out[:n * numbetween:numbetween] = data[:n]
    return out
