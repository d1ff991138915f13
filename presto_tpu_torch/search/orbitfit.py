"""Fit binary orbits to observed spin-period measurements
(bin/fit_circular_orbit.py / fitorb.py analog).

Host copy of ``presto_tpu/search/orbitfit.py`` for the PyTorch port,
which imports nothing from the JAX package.

Input: (time, barycentric period) pairs — e.g. from the .bestprof
files of folds on different days.  The apparent period traces the
line-of-sight orbital velocity:

  p(t) = p_psr * (1 + v_l(t)/c),
  v_l/c = (2 pi x / P_orb) * [cos(w + nu(t)) + e cos w] / sqrt(1-e^2)

with x = a sin(i)/c in lt-s.  Circular fit: 4 parameters
(p_psr, P_orb, x, T0); eccentric (fitorb) adds (e, w).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.optimize import least_squares

from presto_tpu_torch.ops.orbit import keplers_eqn

TWOPI = 2.0 * np.pi


@dataclass
class OrbitFit:
    p_psr: float        # intrinsic spin period, s
    p_orb: float        # orbital period, s
    x: float            # projected semi-major axis, lt-s
    T0: float           # epoch of ascending node (circular) / periastron, s
    e: float = 0.0
    w: float = 0.0      # longitude of periastron, deg
    rms: float = 0.0    # residual rms, s


def _vc_over_c(t, p_orb, x, T0, e=0.0, w_deg=0.0):
    """Line-of-sight velocity / c at times t."""
    wr = np.deg2rad(w_deg)
    if e < 1e-9:
        orbphase = TWOPI * (t - T0) / p_orb
        return (TWOPI * x / p_orb) * np.cos(orbphase)
    E = keplers_eqn(np.mod(t - T0, p_orb), p_orb, e)
    nu = 2.0 * np.arctan2(np.sqrt(1 + e) * np.sin(E / 2),
                          np.sqrt(1 - e) * np.cos(E / 2))
    return (TWOPI * x / (p_orb * np.sqrt(1 - e * e))) \
        * (np.cos(wr + nu) + e * np.cos(wr))


def predicted_period(t, fit: OrbitFit):
    return fit.p_psr * (1.0 + _vc_over_c(
        np.asarray(t, float), fit.p_orb, fit.x, fit.T0, fit.e, fit.w))


def fit_circular_orbit(times: np.ndarray, periods: np.ndarray,
                       p_orb_guess: float, x_guess: float = 1.0
                       ) -> OrbitFit:
    """Least-squares circular-orbit fit (fit_circular_orbit.py flow:
    guess -> scipy leastsq -> report).  times in s, periods in s."""
    t = np.asarray(times, np.float64)
    p = np.asarray(periods, np.float64)
    p0 = float(np.mean(p))

    def resid(theta):
        p_psr, p_orb, x, T0 = theta
        return p_psr * (1.0 + _vc_over_c(t, p_orb, x, T0)) - p

    theta0 = [p0, p_orb_guess, x_guess, t[0]]
    sol = least_squares(resid, theta0, method="lm", max_nfev=20000)
    p_psr, p_orb, x, T0 = sol.x
    if x < 0:                       # sign convention: x >= 0
        x, T0 = -x, T0 + p_orb / 2.0
    T0 = T0 % p_orb
    return OrbitFit(p_psr=float(p_psr), p_orb=float(abs(p_orb)),
                    x=float(x), T0=float(T0),
                    rms=float(np.sqrt(np.mean(sol.fun ** 2))))


def fit_eccentric_orbit(times: np.ndarray, periods: np.ndarray,
                        p_orb_guess: float, x_guess: float = 1.0,
                        e_guess: float = 0.1, w_guess: float = 0.0
                        ) -> OrbitFit:
    """fitorb.py analog: adds (e, w) to the circular fit, seeded from
    the circular solution."""
    t = np.asarray(times, np.float64)
    p = np.asarray(periods, np.float64)
    circ = fit_circular_orbit(t, p, p_orb_guess, x_guess)

    def resid(theta):
        p_psr, p_orb, x, T0, e, w = theta
        return p_psr * (1.0 + _vc_over_c(t, p_orb, x, T0, e, w)) - p

    # bound e in [0, 0.95] via the solver (clipping inside the residual
    # would flatten the Jacobian at the boundary and stall the fit);
    # clamp the seed strictly inside the bounds so least_squares never
    # rejects theta0 as infeasible
    theta0 = [max(circ.p_psr, 1e-9), max(circ.p_orb, 1e-3),
              max(circ.x, 1e-9), circ.T0,
              float(np.clip(e_guess, 1e-3, 0.949)), w_guess]
    inf = np.inf
    sol = least_squares(resid, theta0, max_nfev=40000,
                        bounds=([0.0, 0.0, 0.0, -inf, 0.0, -inf],
                                [inf, inf, inf, inf, 0.95, inf]))
    p_psr, p_orb, x, T0, e, w = sol.x
    return OrbitFit(p_psr=float(p_psr), p_orb=float(abs(p_orb)),
                    x=float(abs(x)), T0=float(T0 % abs(p_orb)),
                    e=float(np.clip(e, 0, 0.95)), w=float(w % 360.0),
                    rms=float(np.sqrt(np.mean(sol.fun ** 2))))
