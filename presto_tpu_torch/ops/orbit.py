"""Keplerian binary-orbit machinery.

Host copy of ``presto_tpu/ops/orbit.py`` for the PyTorch port, which
imports nothing from the JAX package.

Reference: src/orbint.c (keplers_eqn bisection/Newton hybrid :151-216,
dorbint RK4 integration :11-39, E_to_phib/E_to_v/E_to_p/E_to_z
conversions :115-196) and include/orbint.h's orbitparams.

TPU-first redesign: the reference integrates E(t) sequentially with
RK4 because it streams; here E(t) at every sample is computed directly
by a VECTORIZED Newton solve of Kepler's equation M = E - e*sin(E)
(quadratic convergence, fixed iteration count, embarrassingly
parallel) — no sequential dependence, so it maps onto batched device
math or plain numpy.  `dorbint` is kept (numpy RK4) as the parity
reference for tests.

All host-side float64: orbit solves are setup-time, never in hot loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TWOPI = 2.0 * np.pi
SOL = 299792458.0


@dataclass
class OrbitParams:
    """Keplerian parameters (include/orbint.h / presto.h orbitparams).

    p: orbital period (s); x: projected semi-major axis a*sin(i)/c
    (lt-s); e: eccentricity; w: longitude of periastron (DEGREES, like
    the reference's user-facing convention); t: time since periastron
    (s); pd/wd: period/periastron derivatives (rarely used).
    """
    p: float = 0.0
    e: float = 0.0
    x: float = 0.0
    w: float = 0.0
    t: float = 0.0
    pd: float = 0.0
    wd: float = 0.0

    @property
    def w_rad(self) -> float:
        return np.deg2rad(self.w)


def keplers_eqn(t, p_orb: float, e: float, acc: float = 1e-15):
    """Eccentric anomaly at time(s) `t` seconds after periastron.

    Vectorized Newton iteration with a bisection-quality starter
    (E0 = M + e*sin(M)); converges to `acc` for e < 1.  Scalar or
    array `t`.  Parity target: keplers_eqn (orbint.c:151-216).
    """
    t = np.asarray(t, dtype=np.float64)
    M = TWOPI * t / p_orb
    # fixed-point warmup (globally convergent for e<1) then Newton
    E = M + e * np.sin(M)
    for _ in range(8):
        E = M + e * np.sin(E)
    for _ in range(60):
        f = E - e * np.sin(E) - M
        dE = f / (1.0 - e * np.cos(E))
        E = E - dE
        if np.max(np.abs(dE)) < acc:
            break
    return E if E.ndim else float(E)


def dorbint(Eo: float, numpts: int, dt: float,
            orb: OrbitParams) -> np.ndarray:
    """RK4 integration of dE/dt = (2pi/p)/(1 - e*cos(E)) from Eo.
    Direct analog of dorbint (orbint.c:11-39); kept as the parity
    reference for the vectorized solver."""
    E = np.empty(numpts, dtype=np.float64)
    E[0] = Eo
    e = orb.e
    twopif = TWOPI / orb.p
    dt2 = 0.5 * dt

    def edot(z):
        return twopif / (1.0 - e * np.cos(z))

    for i in range(numpts - 1):
        k1 = edot(E[i])
        k2 = edot(E[i] + dt2 * k1)
        k3 = edot(E[i] + dt2 * k2)
        k4 = edot(E[i] + dt * k3)
        E[i + 1] = E[i] + dt * (((k1 + k4) * 0.5 + k2 + k3) / 3.0)
    return E


def E_to_phib(E, orb: OrbitParams):
    """Eccentric anomaly -> Roemer delay (s) (orbint.c:168-178)."""
    E = np.asarray(E, dtype=np.float64)
    w = orb.w_rad
    c1 = orb.x * np.sin(w)
    c2 = orb.x * np.cos(w) * np.sqrt(1.0 - orb.e ** 2)
    return c1 * (np.cos(E) - orb.e) + c2 * np.sin(E)


def E_to_v(E, orb: OrbitParams):
    """Eccentric anomaly -> pulsar radial velocity (km/s)
    (orbint.c:133-147)."""
    E = np.asarray(E, dtype=np.float64)
    w = orb.w_rad
    c1 = TWOPI * orb.x / orb.p
    c2 = np.cos(w) * np.sqrt(1.0 - orb.e ** 2)
    c3 = np.sin(w)
    cE = np.cos(E)
    return (SOL / 1000.0) * c1 * (c2 * cE - c3 * np.sin(E)) \
        / (1.0 - orb.e * cE)


def E_to_p(E, p_psr: float, orb: OrbitParams):
    """Eccentric anomaly -> observed pulsar period (orbint.c:149-165)."""
    E = np.asarray(E, dtype=np.float64)
    w = orb.w_rad
    c1 = TWOPI * orb.x / orb.p
    c2 = np.cos(w) * np.sqrt(1.0 - orb.e ** 2)
    c3 = np.sin(w)
    cE = np.cos(E)
    return p_psr * (1.0 + c1 * (c2 * cE - c3 * np.sin(E))
                    / (1.0 - orb.e * cE))


def E_to_z(E, p_psr: float, T: float, orb: OrbitParams):
    """Eccentric anomaly -> Fourier f-dot z (orbint.c:180-196)."""
    E = np.asarray(E, dtype=np.float64)
    w = orb.w_rad
    c1 = -TWOPI ** 2 * T ** 2 * orb.x / (orb.p ** 2 * p_psr)
    c2 = np.cos(w) * np.sqrt(1.0 - orb.e ** 2)
    c3 = np.sin(w)
    cE = np.cos(E)
    return c1 * (c2 * np.sin(E) + c3 * (cE - orb.e)) \
        / (orb.e * cE - 1.0) ** 3


def ell1_to_keplerian(eps1: float, eps2: float, tasc: float, pb: float):
    """ELL1 Laplace parameters -> (ecc, om_deg in [0,360), t0_mjd).

    Shared by the .par parser and the ATNF catalog reader
    (parfile.py psr_par ELL1 branch): ecc = |(eps1, eps2)|,
    om = atan2(eps1, eps2), T0 = TASC + PB * om / 2pi (pb in days).
    """
    ecc = float(np.hypot(eps1, eps2))
    w = float(np.arctan2(eps1, eps2))
    if w < 0.0:
        w += TWOPI
    t0 = tasc + pb * w / TWOPI
    return ecc, np.degrees(w), t0


def orbit_delays(times, orb: OrbitParams):
    """Roemer delay (s) at observation times `times` (s), measured
    with orb.t = time since periastron at times[...]==0.  The fused
    keplers_eqn + E_to_phib path the new framework uses everywhere the
    reference tabulated-then-interpolated (responses.c:530-547)."""
    E = keplers_eqn(np.asarray(times, dtype=np.float64) + orb.t,
                    orb.p, orb.e)
    return E_to_phib(E, orb)
