"""Observatory geometry: ITRF coordinates, geodetic conversion, and
GCRS (J2000 equatorial) position/velocity of a site.

Host copy of ``presto_tpu/astro/observatory.py`` for the PyTorch
port, which imports nothing from the JAX package.

Replaces TEMPO's obsys.dat lookup (the reference passes 2-letter ITOA
codes through barycenter.c:106 and maps telescope names to codes in
misc_utils.c:185-252).  Site coordinates are public geodetic/ITRF
values; a few meters of error contribute < 10 ns of Roemer delay.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.astro import time as ptime

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
EARTH_OMEGA = 7.2921150e-5  # rad/s


def geodetic_to_itrf(lat_deg, lon_deg, height_m):
    """Geodetic (WGS84) -> geocentric ITRF xyz in meters."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    e2 = WGS84_F * (2.0 - WGS84_F)
    N = WGS84_A / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    x = (N + height_m) * np.cos(lat) * np.cos(lon)
    y = (N + height_m) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - e2) + height_m) * np.sin(lat)
    return np.array([x, y, z])


# code -> (nice name, ITRF xyz meters)
OBSERVATORIES = {
    "GB": ("GBT", np.array([882589.65, -4924872.32, 3943729.35])),
    "AO": ("Arecibo", np.array([2390490.0, -5564764.0, 1994727.0])),
    "VL": ("VLA", np.array([-1601192.0, -5041981.4, 3554871.4])),
    "PK": ("Parkes", np.array([-4554231.5, 2816759.1, -3454036.3])),
    "JB": ("Jodrell Bank", np.array([3822626.04, -154105.65, 5086486.04])),
    "G1": ("GB43m", geodetic_to_itrf(38.4248, -79.8359, 807.0)),
    "NC": ("Nancay", np.array([4324165.81, 165927.11, 4670132.83])),
    "EF": ("Effelsberg", np.array([4033949.5, 486989.4, 4900430.8])),
    "SR": ("Sardinia Radio Telescope",
           np.array([4865182.766, 791922.689, 4035137.174])),
    "WT": ("WSRT", np.array([3828445.659, 445223.600, 5064921.568])),
    "GM": ("GMRT", np.array([1656342.30, 5797947.77, 2073243.16])),
    "LF": ("LOFAR", np.array([3826577.462, 461022.624, 5064892.526])),
    "LW": ("LWA1", geodetic_to_itrf(34.0689, -107.6284, 2133.6)),
    "MW": ("MWA128T", geodetic_to_itrf(-26.70331, 116.67081, 377.8)),
    "MK": ("MeerKAT", np.array([5109360.133, 2006852.586, -3238948.127])),
    "K7": ("KAT-7", geodetic_to_itrf(-30.7214, 21.4108, 1038.0)),
    "CH": ("CHIME", geodetic_to_itrf(49.3208, -119.6236, 545.0)),
    "FA": ("FAST", geodetic_to_itrf(25.6529, 106.8566, 1110.0)),
    "EC": ("Geocenter", np.array([0.0, 0.0, 0.0])),
}

# Telescope-name -> code map, parity with misc_utils.c:185-252.
_NAME_TO_CODE = {
    "gbt": "GB", "arecibo": "AO", "vla": "VL", "parkes": "PK",
    "jodrell": "JB", "gb43m": "G1", "gb 140ft": "G1", "nrao20": "G1",
    "nancay": "NC", "effelsberg": "EF", "srt": "SR", "wsrt": "WT",
    "gmrt": "GM", "lofar": "LF", "lwa": "LW", "mwa": "MW",
    "meerkat": "MK", "k7": "K7", "kat-7": "K7", "chime": "CH",
    "fast": "FA", "jodrell bank": "JB", "sardinia radio telescope": "SR",
    "lwa1": "LW", "mwa128t": "MW", "geocenter": "EC",
}


# TEMPO one-character TOA site codes (tempo obsys.dat column; the
# reference's get_TOAs.py carries the same name->digit map)
_TEMPO1_SITE = {
    "GB": "1", "AO": "3", "VL": "6", "PK": "7", "JB": "8",
    "G1": "a", "NC": "f", "EF": "g", "WT": "i", "FA": "k",
    "MK": "m", "GM": "r", "LF": "t", "CH": "y", "EC": "@",
}


def tempo1_site_code(name) -> str:
    """Telescope name -> 1-char TEMPO TOA site code ('@' = barycenter
    for unknown/geocenter, matching the reference's fallback)."""
    code = _NAME_TO_CODE.get(str(name).strip().lower())
    return _TEMPO1_SITE.get(code, "@") if code else "@"


def telescope_to_tempocode(name):
    """Telescope name -> (2-letter code, nice name); unknown -> EC
    (same fallback as misc_utils.c:246-250)."""
    code = _NAME_TO_CODE.get(str(name).strip().lower())
    if code is None:
        return "EC", "Unknown"
    return code, OBSERVATORIES[code][0]


def _precession_matrix(mjd_tt):
    """IAU1976 precession: rotates J2000 vectors to mean-of-date."""
    T = (np.asarray(mjd_tt, np.float64) - ptime.MJD_J2000) / 36525.0
    as2rad = np.pi / (180.0 * 3600.0)
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * as2rad
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * as2rad
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * as2rad
    cz, sz = np.cos(-z), np.sin(-z)
    ct, st = np.cos(theta), np.sin(theta)
    cze, sze = np.cos(-zeta), np.sin(-zeta)
    # P = Rz(-z) Ry(theta) Rz(-zeta)
    Rz1 = np.array([[cze, sze, 0], [-sze, cze, 0], [0, 0, 1]])
    Ry = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
    Rz2 = np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]])
    return Rz2 @ Ry @ Rz1


def _nutation_matrix(mjd_tt):
    """Truncated IAU1980 nutation: mean-of-date -> true-of-date."""
    dpsi, deps = ptime.nutation_angles(mjd_tt)
    eps = ptime.mean_obliquity(mjd_tt)
    ce, se = np.cos(eps), np.sin(eps)
    cet, set_ = np.cos(eps + deps), np.sin(eps + deps)
    cp, sp = np.cos(dpsi), np.sin(dpsi)
    Rx1 = np.array([[1, 0, 0], [0, ce, se], [0, -se, ce]])
    Rz = np.array([[cp, sp, 0], [-sp, cp, 0], [0, 0, 1]])
    Rx2 = np.array([[1, 0, 0], [0, cet, -set_], [0, set_, cet]])
    return Rx2 @ Rz @ Rx1


def obs_posvel_gcrs(mjd_utc, code):
    """Observatory position (m) and velocity (m/s) in the J2000
    equatorial frame for an array of UTC MJDs.

    Chain: ITRF --Rz(GAST)--> true-of-date --N^T P^T--> J2000.
    Polar motion (< 0.3" -> < 10 m) is neglected.
    """
    mjd = np.atleast_1d(np.asarray(mjd_utc, np.float64))
    xyz = OBSERVATORIES[code][1]
    tt = ptime.utc_to_tt(mjd)
    theta = ptime.gast(mjd, tt)

    ct, st = np.cos(theta), np.sin(theta)
    # r_TOD = Rz(+GAST) r_ITRF  (site celestial longitude = lon + GAST)
    r_tod = np.stack([ct * xyz[0] - st * xyz[1],
                      st * xyz[0] + ct * xyz[1],
                      np.full_like(ct, xyz[2])], axis=-1)
    # v_TOD = omega x r
    v_tod = np.stack([-EARTH_OMEGA * r_tod[..., 1],
                      EARTH_OMEGA * r_tod[..., 0],
                      np.zeros_like(ct)], axis=-1)

    # Precession/nutation vary slowly; evaluate at the midpoint of the
    # request and apply one rotation (error < 0.05" over a day).
    mid_tt = float(np.mean(tt))
    M = (_nutation_matrix(mid_tt) @ _precession_matrix(mid_tt)).T
    return r_tod @ M.T, v_tod @ M.T
