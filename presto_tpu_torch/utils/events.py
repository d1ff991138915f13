"""Event-based periodicity statistics (lib/python/events.py +
kuiper.py analog): Z^2_m, H-test, Rayleigh, and the Kuiper test, for
photon/event arrival-time folding (X-ray / gamma-ray style searches).

Host copy of ``presto_tpu/utils/events.py`` for the PyTorch port, which
imports nothing from the JAX package.
"""

from __future__ import annotations

import numpy as np


def fold_events(times: np.ndarray, f: float, fd: float = 0.0,
                fdd: float = 0.0, t0: float = 0.0) -> np.ndarray:
    """Event times (s) -> phases in [0, 1)."""
    t = np.asarray(times, np.float64) - t0
    ph = t * (f + t * (fd / 2.0 + t * fdd / 6.0))
    return np.mod(ph, 1.0)


def z2m(phases: np.ndarray, m: int = 2) -> float:
    """Z^2_m statistic (Buccheri et al. 1983): summed Fourier power of
    the first m harmonics of the event phase distribution; chi^2 with
    2m dof under uniformity."""
    ph = 2.0 * np.pi * np.asarray(phases, np.float64)
    n = ph.size
    if n == 0:
        return 0.0
    k = np.arange(1, m + 1)[:, None]
    c = np.cos(k * ph[None, :]).sum(axis=1)
    s = np.sin(k * ph[None, :]).sum(axis=1)
    return float(2.0 / n * np.sum(c ** 2 + s ** 2))


def z2m_prob(z2: float, m: int = 2) -> float:
    """False-alarm probability of a Z^2_m value (chi^2, 2m dof)."""
    from scipy.stats import chi2 as chi2dist
    return float(chi2dist.sf(z2, 2 * m))


def rayleigh(phases: np.ndarray) -> float:
    """Rayleigh statistic = Z^2_1."""
    return z2m(phases, 1)


def htest(phases: np.ndarray, maxharms: int = 20):
    """H-test (de Jager, Raubenheimer & Swanepoel 1989):
    H = max_m (Z^2_m - 4m + 4).  Returns (H, best_m, prob) with the
    de Jager & Buesching (2010) calibration P = exp(-0.4 H)."""
    ph = 2.0 * np.pi * np.asarray(phases, np.float64)
    n = ph.size
    if n == 0:
        return 0.0, 1, 1.0
    k = np.arange(1, maxharms + 1)[:, None]
    c = np.cos(k * ph[None, :]).sum(axis=1)
    s = np.sin(k * ph[None, :]).sum(axis=1)
    z_cum = 2.0 / n * np.cumsum(c ** 2 + s ** 2)
    m = np.arange(1, maxharms + 1)
    hs = z_cum - 4.0 * m + 4.0
    best = int(np.argmax(hs))
    H = float(hs[best])
    prob = float(np.exp(-0.4 * H)) if H > 0 else 1.0
    return H, best + 1, min(prob, 1.0)


def kuiper_statistic(phases: np.ndarray) -> float:
    """Kuiper V: rotation-invariant two-sided KS statistic of phases
    against the uniform distribution (lib/python/kuiper.py)."""
    x = np.sort(np.mod(np.asarray(phases, np.float64), 1.0))
    n = x.size
    if n == 0:
        return 0.0
    i = np.arange(1, n + 1)
    d_plus = np.max(i / n - x)
    d_minus = np.max(x - (i - 1) / n)
    return float(d_plus + d_minus)


def kuiper_prob(V: float, n: int) -> float:
    """Asymptotic false-alarm probability of Kuiper V for n events
    (Stephens 1970 series, as used by the reference's kuiper.py)."""
    if n <= 0 or V <= 0:
        return 1.0
    lam = (np.sqrt(n) + 0.155 + 0.24 / np.sqrt(n)) * V
    if lam < 0.4:
        return 1.0
    j = np.arange(1, 101)
    t = 4.0 * j ** 2 * lam ** 2
    p = np.sum((t - 1.0) * np.exp(-t / 2.0)) * 2.0
    return float(min(max(p, 0.0), 1.0))


def kuiper_uniform_test(phases: np.ndarray):
    """(V, prob) of the phases being uniform."""
    V = kuiper_statistic(phases)
    return V, kuiper_prob(V, len(np.atleast_1d(phases)))
