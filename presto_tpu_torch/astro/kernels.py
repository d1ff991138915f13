"""Zero-setup ephemeris kernel provisioning.

Host copy of ``presto_tpu/astro/kernels.py`` for the PyTorch port,
which imports nothing from the JAX package.

The reference's default barycentering is TEMPO + an installed DE405
file — µs-grade with no user action (src/barycenter.c:87-156).  This
framework's sub-µs seam is a real JPL .bsp (astro/spk.py).  The
provisioning ladder:

  1. a REAL JPL kernel (de*.bsp) placed in the kernel cache by the
     user: sub-µs absolute, exactly the reference's grade;
  2. the BUILTIN kernel: the shipped EPV2000 series (4.6 km RMS vs
     DE405, sub-50-µs absolute Roemer — astro/ephem.py) fitted to a
     compact type-2 Chebyshev .bsp covering 1980-2040, generated
     once at first use into the cache (~5 MB, a few seconds).  Every
     kernel-route feature then works with ZERO setup; fit error is
     sub-millimeter, so the kernel IS the builtin ephemeris through
     the real SPK read path.

The cache is the port's own directory (``~/.cache/presto_tpu_torch``),
or the directory a caller passes as ``root``; no environment variable
selects it.  The JAX package's gated download (``fetch_kernel``) is not
carried: the port fetches nothing, and a kernel placed in the cache is
still used (pin-verified when a ``.sha256`` sits beside it).
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Optional

import numpy as np

# builtin kernel coverage and fit geometry.  Earth granules must
# resolve the 27.3-day EMB wobble the EPV Earth series carries: 2-day
# windows at 16 coefficients fit it to sub-millimeter.  The Sun's
# SSB orbit is smooth (Jupiter-period): 16-day windows suffice.
BUILTIN_MJD_LO = 44239.0        # 1980 Jan 1
BUILTIN_MJD_HI = 66155.0        # 2040 Feb 28
_EARTH_INTLEN_D = 2.0
_EARTH_NCOEF = 16
_SUN_INTLEN_D = 16.0
_SUN_NCOEF = 14
_VERSION = 1


def default_cache_dir() -> str:
    """The port's kernel cache (a caller's ``root`` overrides it)."""
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "presto_tpu_torch")


def cache_dir(root: Optional[str] = None) -> str:
    """``root`` (default: default_cache_dir()), created if missing."""
    d = root or default_cache_dir()
    os.makedirs(d, exist_ok=True)
    return d


def builtin_kernel(mjd_lo: float = None, mjd_hi: float = None,
                   root: Optional[str] = None) -> str:
    """Path of the builtin EPV2000-fitted .bsp, generating it into
    the cache on first use.  Deterministic (pure function of the
    shipped series + fit geometry), so the cache never goes stale
    except across _VERSION bumps, which change the filename.  The file
    is byte-equal to the JAX package's for the same range.

    The default range reads BUILTIN_MJD_LO/HI at CALL time (def-time
    defaults would freeze them)."""
    if mjd_lo is None:
        mjd_lo = BUILTIN_MJD_LO
    if mjd_hi is None:
        mjd_hi = BUILTIN_MJD_HI
    path = os.path.join(cache_dir(root), "epv_builtin_v%d_%d_%d.bsp"
                        % (_VERSION, int(mjd_lo), int(mjd_hi)))
    if os.path.exists(path):
        return path
    from presto_tpu_torch.astro.ephem import get_ephemeris
    from presto_tpu_torch.astro.spk import (AU_KM, DAY_S, EARTH,
                                            J2000_JD, SSB, SUN)
    from presto_tpu_torch.astro.spkwrite import (type2_records_batched,
                                                 write_spk)
    eph = get_ephemeris("EPV2000")
    et0 = (mjd_lo + 2400000.5 - J2000_JD) * DAY_S

    def earth_km(et):
        jd = J2000_JD + np.asarray(et) / DAY_S
        p, _v = eph.earth_posvel(jd)
        return p * AU_KM

    def sun_km(et):
        jd = J2000_JD + np.asarray(et) / DAY_S
        return eph.sun_pos(jd) * AU_KM

    ndays = mjd_hi - mjd_lo
    n_e = int(np.ceil(ndays / _EARTH_INTLEN_D))
    n_s = int(np.ceil(ndays / _SUN_INTLEN_D))
    tmp = path + ".tmp.%d" % os.getpid()
    write_spk(tmp, [
        (EARTH, SSB, 2, et0, _EARTH_INTLEN_D * DAY_S,
         type2_records_batched(earth_km, et0, _EARTH_INTLEN_D * DAY_S,
                               n_e, _EARTH_NCOEF)),
        (SUN, SSB, 2, et0, _SUN_INTLEN_D * DAY_S,
         type2_records_batched(sun_km, et0, _SUN_INTLEN_D * DAY_S,
                               n_s, _SUN_NCOEF)),
    ])
    os.replace(tmp, path)       # atomic: concurrent first-users race
    return path                 # benignly


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def find_de_kernel(root: Optional[str] = None) -> Optional[str]:
    """A real JPL kernel already in the cache (de*.bsp, pin-verified
    when a .sha256 sits beside it), or None."""
    d = cache_dir(root)
    for fn in sorted(os.listdir(d)):
        if fn.lower().startswith("de") and fn.lower().endswith(".bsp"):
            path = os.path.join(d, fn)
            pin = path + ".sha256"
            if os.path.exists(pin):
                with open(pin) as f:
                    want = f.read().strip()
                if _sha256(path) != want:
                    raise RuntimeError(
                        "kernel %s fails its SHA256 pin: delete or "
                        "replace both" % path)
            return path
    return None


_warned = False


def resolve_kernel(root: Optional[str] = None):
    """(path, grade) of the best kernel in the cache: a real DE file
    ('de') if one was placed there, else the builtin EPV2000 kernel
    ('epv', sub-50-µs absolute — warned once)."""
    global _warned
    de = find_de_kernel(root)
    if de is not None:
        return de, "de"
    if not _warned:
        _warned = True
        warnings.warn(
            "no JPL DE kernel in %s: using the builtin EPV2000 kernel "
            "(4.6 km RMS vs DE405, sub-50-us absolute Roemer). For "
            "sub-us absolute timing, place a real kernel there."
            % cache_dir(root))
    return builtin_kernel(root=root), "epv"
