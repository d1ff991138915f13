"""Barycentering: topocentric UTC MJDs -> barycentric TDB MJDs + v/c.

Host copy of ``presto_tpu/astro/bary.py`` for the PyTorch port, which
imports nothing from the JAX package.

API parity with the reference's barycenter() (src/barycenter.c:87-252),
which writes fake TOAs, shells out to TEMPO twice, and parses
resid2.tmp.  Here the whole chain is computed in-process:

  t_bary = TDB(t_topo) + Roemer/c + Shapiro(sun)        [infinite freq]
  voverc = -(v_obs . n_hat)/c

The v/c sign convention matches the reference: TEMPO reports the
barycentric frequency f_bary of a topocentric channel and PRESTO sets
voverc = f_bary/f_topo - 1 (barycenter.c:232-234), i.e. positive when
the observatory recedes from the pulsar, so that
doppler(f_topo, voverc) = f_topo*(1+voverc) = f_bary (doppler() in
barycenter.c:3-11).
"""

from __future__ import annotations

import re

import numpy as np

from presto_tpu_torch.astro import time as ptime
from presto_tpu_torch.astro import observatory as obsmod
from presto_tpu_torch.astro.ephem import (AU_M, C_M_S, get_ephemeris)

SECPERDAY = 86400.0
# 2 GM_sun / c^3 in seconds (Shapiro-delay scale)
TWO_GMSUN_C3 = 9.8509819e-6


def parse_ra(ra):
    """'hh:mm:ss.ssss' (or hours as float) -> radians."""
    if isinstance(ra, (int, float)):
        return float(ra)
    parts = [p for p in re.split(r"[:\s]+", str(ra).strip()) if p]
    h = float(parts[0])
    m = float(parts[1]) if len(parts) > 1 else 0.0
    s = float(parts[2]) if len(parts) > 2 else 0.0
    return (abs(h) + m / 60.0 + s / 3600.0) * np.pi / 12.0


def parse_dec(dec):
    """'[+-]dd:mm:ss.ssss' (or degrees as float) -> radians."""
    if isinstance(dec, (int, float)):
        return float(dec)
    s_dec = str(dec).strip()
    sign = -1.0 if s_dec.lstrip().startswith("-") else 1.0
    parts = [p for p in re.split(r"[:\s]+", s_dec) if p]
    d = abs(float(parts[0]))
    m = float(parts[1]) if len(parts) > 1 else 0.0
    s = float(parts[2]) if len(parts) > 2 else 0.0
    return sign * (d + m / 60.0 + s / 3600.0) * np.pi / 180.0


def source_unit_vector(ra, dec):
    """J2000 unit vector toward (ra, dec) given as strings or radians."""
    a, d = parse_ra(ra), parse_dec(dec)
    return np.array([np.cos(d) * np.cos(a),
                     np.cos(d) * np.sin(a),
                     np.sin(d)])


def barycenter(topotimes, ra, dec, obs="GB", ephem="DE405"):
    """Correct topocentric UTC MJDs to barycentric TDB MJDs at infinite
    observing frequency, and return the site radial velocity in units
    of c at each epoch.

    Parameters mirror barycenter.c:87: ra 'hh:mm:ss.ss', dec
    '[+-]dd:mm:ss.ss', obs a 2-letter TEMPO code (observatory.py), and
    ephem a DE name (both DE200/DE405 resolve to the built-in analytic
    model; an .npz path loads a tabulated precision ephemeris).

    Returns (barytimes, voverc) as float64 arrays of the input shape.
    """
    topo = np.atleast_1d(np.asarray(topotimes, np.float64))
    nhat = source_unit_vector(ra, dec)
    eph = get_ephemeris(ephem)

    tdb = ptime.utc_to_tdb(topo)
    jd_tdb = tdb + 2400000.5

    epos, evel = eph.earth_posvel(jd_tdb)          # AU, AU/day
    opos, ovel = obsmod.obs_posvel_gcrs(topo, obs)  # m, m/s

    r_m = epos * AU_M + opos                        # site w.r.t. SSB, m
    v_m_s = evel * (AU_M / SECPERDAY) + ovel

    roemer_s = r_m @ nhat / C_M_S

    # Solar Shapiro delay: -2GM/c^3 ln(1 - cos(theta)), theta the
    # pulsar-Sun angular separation seen from the site.
    sun_m = eph.sun_pos(jd_tdb) * AU_M
    r_os = sun_m - r_m                              # site -> Sun
    rmag = np.linalg.norm(r_os, axis=-1)
    cos_theta = -(r_os @ nhat) / rmag               # cos(angle Sun vs psr)
    shapiro_s = -TWO_GMSUN_C3 * np.log(np.maximum(1.0 - cos_theta, 1e-12))

    bary = tdb + (roemer_s - shapiro_s) / SECPERDAY
    voverc = -(v_m_s @ nhat) / C_M_S

    if np.isscalar(topotimes) or np.ndim(topotimes) == 0:
        return float(bary[0]), float(voverc[0])
    return bary, voverc


def average_voverc(start_mjd, duration_s, ra, dec, obs="GB",
                   ephem="DE405", npts=100):
    """Mean/max/min v/c over an observation — the avgvoverc statistic
    prepdata/prepsubband print and use for Doppler-corrected DM delays
    (prepsubband.c:444-465)."""
    ts = start_mjd + np.linspace(0.0, duration_s / SECPERDAY, npts)
    _, voverc = barycenter(ts, ra, dec, obs, ephem)
    return float(np.mean(voverc)), float(np.max(voverc)), float(np.min(voverc))
