"""Candidate significance statistics (host-side, float64, vectorized).

Host copy of ``presto_tpu/ops/stats.py`` for the PyTorch port, which imports
nothing from the JAX package.

Parity targets: reference src/characteristics.c.
  chi2_logp                        characteristics.c:494-528
  equivalent_gaussian_sigma        characteristics.c:456-492 + :396-415
  candidate_sigma                  characteristics.c:548-570
  power_for_sigma                  characteristics.c:571-606
The reference routes through dcdflib (cdfchi/cdfnor) with hand-rolled
A&S asymptotic expansions where dcdflib underflows; here scipy supplies
the exact CDFs and the same asymptotic branches are kept so results
track the reference through the underflow regime (validated to ~1e-12
in tests).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2, norm as _norm


def extended_equiv_gaussian_sigma(logp):
    """A&S 26.2.23 rational approximation using log-probability.
    Parity: characteristics.c:396-415."""
    logp = np.asarray(logp, dtype=np.float64)
    t = np.sqrt(-2.0 * logp)
    # logp = -inf (p underflowed to 0) gives t = inf and an inf/inf
    # division below; the sigma is then simply t (the correction term
    # tends to a constant) — guard instead of warning
    with np.errstate(invalid="ignore"):
        num = 2.515517 + t * (0.802853 + t * 0.010328)
        denom = 1.0 + t * (1.432788 + t * (0.189269 + t * 0.001308))
        out = t - num / denom
    return np.where(np.isinf(t), t, out)


def log_asymtotic_incomplete_gamma(a, z):
    """A&S 6.5.32 asymptotic of log Γ(a, z) as z→∞.
    Parity: characteristics.c:417-434 (incl. the reference's spelling)."""
    a = np.float64(a)
    z = np.float64(z)
    x = 1.0
    newxpart = 1.0
    term = 1.0
    ii = 1
    while abs(newxpart) > 1e-15:
        term *= (a - ii)
        newxpart = term / z ** ii
        x += newxpart
        ii += 1
    return (a - 1.0) * np.log(z) - z + np.log(x)


def log_asymtotic_gamma(z):
    """A&S 6.1.41 asymptotic of log Γ(z) as z→∞.
    Parity: characteristics.c:437-451."""
    z = np.float64(z)
    x = (z - 0.5) * np.log(z) - z + 0.91893853320467267
    y = 1.0 / (z * z)
    x += (((-5.9523809523809529e-4 * y
            + 7.9365079365079365079365e-4) * y
           - 2.7777777777777777777778e-3) * y
          + 8.3333333333333333333333e-2) / z
    return x


def chi2_logp(chi2, dof):
    """ln P(X > chi2) for X ~ χ²_dof, with the reference's asymptotic
    branch selection.  Parity: characteristics.c:494-528."""
    scalar = np.isscalar(chi2) or np.ndim(chi2) == 0
    c = np.atleast_1d(np.asarray(chi2, dtype=np.float64))
    d = np.broadcast_to(np.asarray(dof, dtype=np.float64), c.shape).copy()
    ratio = np.divide(c, d, out=np.zeros_like(c), where=d > 0)
    use_asym = (ratio > 15.0) | ((d > 150) & (ratio > 6.0))
    out = np.where(c <= 0.0, -np.inf,
                   _chi2.logsf(c, d))  # exact branch (== log(q) of cdfchi)
    for i in np.flatnonzero(use_asym & (c > 0.0)):
        out[i] = (log_asymtotic_incomplete_gamma(0.5 * d[i], 0.5 * c[i])
                  - log_asymtotic_gamma(0.5 * d[i]))
    return float(out[0]) if scalar else out


def equivalent_gaussian_sigma(logp):
    """Gaussian sigma whose tail probability is exp(logp).
    Parity: characteristics.c:456-492 (isf branch == cdfnor which=2)."""
    logp = np.asarray(logp, dtype=np.float64)
    small = logp < -600.0
    sig_small = extended_equiv_gaussian_sigma(np.where(small, logp, -700.0))
    with np.errstate(over="ignore"):
        sig_exact = _norm.isf(np.exp(np.where(small, -1.0, logp)))
    out = np.where(small, sig_small, sig_exact)
    out = np.where(np.isfinite(out), out, 0.0)
    return out if out.shape else float(out)


def candidate_sigma(power, numsum, numtrials):
    """Equivalent Gaussian sigma of `numsum` summed normalized powers,
    corrected for `numtrials` independent trials.
    Parity: characteristics.c:548-570."""
    power = np.asarray(power, dtype=np.float64)
    logp = chi2_logp(2.0 * power, 2.0 * np.asarray(numsum))
    logp = np.asarray(logp) + np.log(numtrials)
    out = np.where(power <= 0.0, 0.0, equivalent_gaussian_sigma(logp))
    return out if out.shape else float(out)


def power_for_sigma(sigma, numsum, numtrials):
    """Summed power needed for a given sigma after trials correction.
    Parity: characteristics.c:571-606."""
    q = _norm.sf(np.asarray(sigma, dtype=np.float64)) / numtrials
    x = _chi2.isf(q, 2.0 * np.asarray(numsum))
    return 0.5 * x
