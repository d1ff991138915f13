"""FFTFIT — Fourier-domain template matching (Taylor 1992).

Host copy of ``presto_tpu/timing/fftfit.py`` for the PyTorch port, which
imports nothing from the JAX package.

The reference wraps the original Fortran (python/fftfit_src/fftfit.f,
built via f2py per python/setup.py) and calls it from bin/get_TOAs.py to
measure the phase shift between a folded profile and a template.  This
is a from-scratch NumPy implementation of the same estimator:

model  p(j) = a + b * s(j - n*tau),  i.e. in the Fourier domain
       P_k  = b * S_k * exp(-2*pi*i*k*tau)   for harmonics k >= 1.

chi^2(b,tau) = sum_k |P_k - b S_k e^{-2 pi i k tau}|^2 / sigma^2 is
minimized exactly: the cross-spectrum IFFT gives the global coarse
peak, Brent polish gives sub-bin tau, and b follows in closed form.
Error estimates come from the curvature of chi^2 at the minimum with
the noise level sigma^2 estimated from the residual itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.optimize import minimize_scalar


@dataclass
class FFTFitResult:
    shift: float    # phase shift in rotations, in [-0.5, 0.5)
    eshift: float   # 1-sigma uncertainty of shift (rotations)
    b: float        # template scale factor
    errb: float     # 1-sigma uncertainty of b
    offset: float   # DC offset a
    snr: float      # matched-filter S/N of the detection


def gaussian_template(n: int, fwhm: float, phase: float = 0.5
                      ) -> np.ndarray:
    """A wrapped Gaussian pulse template with the given FWHM (in
    rotations) centered at `phase` — the default template get_TOAs.py
    builds with -g (via psr_utils.gaussian_profile)."""
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    x = (np.arange(n) + 0.5) / n
    d = x - phase
    d = d - np.round(d)            # wrap to [-0.5, 0.5)
    return np.exp(-0.5 * (d / sigma) ** 2)


def fftfit(profile: np.ndarray, template: np.ndarray) -> FFTFitResult:
    """Fit `profile` = a + b * template shifted by `shift` rotations.

    A positive shift means the profile's features arrive LATER (at
    higher phase) than the template's.
    """
    p = np.asarray(profile, np.float64)
    s = np.asarray(template, np.float64)
    n = p.size
    if s.size != n:
        raise ValueError("profile and template lengths differ")
    P = np.fft.rfft(p)
    S = np.fft.rfft(s)
    nh = n // 2
    k = np.arange(1, nh)           # harmonics 1..n/2-1 (skip DC+Nyquist)
    aP = np.abs(P[k])
    aS = np.abs(S[k])
    dphi = np.angle(P[k]) - np.angle(S[k])

    # coarse tau: peak of the cross-correlation, 16x zero-padded
    pad = 16
    X = np.zeros(n * pad // 2 + 1, np.complex128)
    X[1:nh] = P[k] * np.conj(S[k])
    cc = np.fft.irfft(X, n * pad)
    tau0 = np.argmax(cc) / (n * pad)

    two_pi_k = 2.0 * np.pi * k

    def merit(tau):
        return float(np.sum(aP * aS * np.cos(dphi + two_pi_k * tau)))

    half_bin = 1.0 / n
    res = minimize_scalar(lambda t: -merit(t),
                          bounds=(tau0 - half_bin, tau0 + half_bin),
                          method="bounded",
                          options={"xatol": 1e-12})
    tau = float(res.x)

    cosd = np.cos(dphi + two_pi_k * tau)
    sum_PS = float(np.sum(aP * aS * cosd))
    sum_SS = float(np.sum(aS ** 2))
    sum_PP = float(np.sum(aP ** 2))
    b = sum_PS / sum_SS

    # noise per harmonic from the chi^2 floor (Taylor 1992 eq. A10-ish)
    dof = max(len(k) - 2, 1)
    sigma2 = max(sum_PP - b * sum_PS, 0.0) / dof
    curv_tau = b * b * float(np.sum((two_pi_k ** 2) * aS ** 2))
    eshift = np.sqrt(sigma2 / curv_tau) if curv_tau > 0 else np.inf
    errb = np.sqrt(sigma2 / sum_SS) if sum_SS > 0 else np.inf
    snr = b * np.sqrt(sum_SS / sigma2) if sigma2 > 0 else np.inf

    shift = tau - np.round(tau)    # wrap to [-0.5, 0.5)
    offset = float((P[0].real - b * S[0].real) / n)
    return FFTFitResult(shift=float(shift), eshift=float(eshift),
                        b=float(b), errb=float(errb), offset=offset,
                        snr=float(snr))
