"""Gaussian decomposition of pulse profiles (bin/pygaussfit.py's
fitting core, non-interactive): fit N wrapped Gaussians + a DC level
to a folded profile, report components in the .gaussians format that
get_TOAs-style template generation consumes.

Host copy of ``presto_tpu/utils/gaussfit.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
from scipy.optimize import least_squares


@dataclass
class GaussComponent:
    phase: float     # center, rotations
    fwhm: float      # rotations
    ampl: float      # peak amplitude


def gauss_profile(n: int, components: List[GaussComponent],
                  dc: float = 0.0) -> np.ndarray:
    x = (np.arange(n) + 0.5) / n
    out = np.full(n, dc, float)
    for c in components:
        sigma = c.fwhm / 2.35482
        d = x - c.phase
        d = d - np.round(d)
        out += c.ampl * np.exp(-0.5 * (d / sigma) ** 2)
    return out


def _theta_to_comps(theta):
    dc = theta[0]
    comps = [GaussComponent(phase=theta[i] % 1.0,
                            fwhm=abs(theta[i + 1]),
                            ampl=theta[i + 2])
             for i in range(1, len(theta), 3)]
    return dc, comps


def fit_gaussians(profile: np.ndarray, ngauss: int = 1,
                  init: Optional[List[GaussComponent]] = None):
    """Fit `ngauss` wrapped Gaussians + DC.  Components are seeded at
    the residual maxima (the interactive seeding of pygaussfit.py,
    automated).  Returns (components, dc, residual_rms)."""
    prof = np.asarray(profile, np.float64)
    n = prof.size
    theta = [float(np.median(prof))]
    if init:
        for c in init:
            theta += [c.phase, c.fwhm, c.ampl]
    else:
        resid = prof - np.median(prof)
        for _ in range(ngauss):
            k = int(np.argmax(resid))
            amp = float(resid[k])
            # crude width: half-max crossing distance
            half = amp / 2.0
            w = 1
            while w < n // 2 and resid[(k + w) % n] > half:
                w += 1
            fwhm = max(2.0 * w / n, 1.5 / n)
            theta += [(k + 0.5) / n, fwhm, amp]
            resid = resid - gauss_profile(
                n, [GaussComponent((k + 0.5) / n, fwhm, amp)])

    def residfn(th):
        dc, comps = _theta_to_comps(th)
        return gauss_profile(n, comps, dc) - prof

    sol = least_squares(residfn, theta, max_nfev=20000)
    dc, comps = _theta_to_comps(sol.x)
    comps.sort(key=lambda c: -abs(c.ampl))
    rms = float(np.sqrt(np.mean(sol.fun ** 2)))
    return comps, float(dc), rms


def write_gaussians(path: str, comps: List[GaussComponent],
                    dc: float, ref: str = "") -> None:
    """The .gaussians text format pygaussfit.py saves."""
    with open(path, "w") as f:
        f.write("# gauss components for %s\n" % (ref or "profile"))
        f.write("const = %.6g\n" % dc)
        for i, c in enumerate(comps, 1):
            f.write("phas%d = %.6f\n" % (i, c.phase))
            f.write("fwhm%d = %.6f\n" % (i, c.fwhm))
            f.write("ampl%d = %.6g\n" % (i, c.ampl))


def read_gaussians(path: str):
    dc = 0.0
    comps = {}
    with open(path) as f:
        for line in f:
            if "=" not in line or line.startswith("#"):
                continue
            key, val = [s.strip() for s in line.split("=", 1)]
            if key == "const":
                dc = float(val)
            elif key[:4] in ("phas", "fwhm", "ampl"):
                i = int(key[4:])
                comps.setdefault(i, {})[key[:4]] = float(val)
    out = [GaussComponent(phase=v["phas"], fwhm=v["fwhm"],
                          ampl=v["ampl"])
           for _, v in sorted(comps.items())]
    return out, dc
