"""Time scales: UTC -> TAI -> TT -> TDB, and sidereal time.

Host copy of ``presto_tpu/astro/time.py`` for the PyTorch
port, which imports nothing from the JAX package.

Replaces the reference's reliance on TEMPO's clock chain
(src/barycenter.c:124 "CLK UTC(NIST)") with an explicit leap-second
table and the standard analytic TDB-TT series.  All functions are
vectorized over numpy arrays of MJDs (float64).
"""

from __future__ import annotations

import numpy as np

SECPERDAY = 86400.0
MJD_J2000 = 51544.5  # 2000 Jan 1.5 TT (JD 2451545.0)

# (mjd_utc_of_change, TAI-UTC seconds from that date on).  Complete
# through 2026: no leap second has been added after 2017-01-01.
_LEAP_TABLE = np.array([
    (41317.0, 10.0),  # 1972-01-01
    (41499.0, 11.0),  # 1972-07-01
    (41683.0, 12.0),  # 1973-01-01
    (42048.0, 13.0),  # 1974-01-01
    (42413.0, 14.0),  # 1975-01-01
    (42778.0, 15.0),  # 1976-01-01
    (43144.0, 16.0),  # 1977-01-01
    (43509.0, 17.0),  # 1978-01-01
    (43874.0, 18.0),  # 1979-01-01
    (44239.0, 19.0),  # 1980-01-01
    (44786.0, 20.0),  # 1981-07-01
    (45151.0, 21.0),  # 1982-07-01
    (45516.0, 22.0),  # 1983-07-01
    (46247.0, 23.0),  # 1985-07-01
    (47161.0, 24.0),  # 1988-01-01
    (47892.0, 25.0),  # 1990-01-01
    (48257.0, 26.0),  # 1991-01-01
    (48804.0, 27.0),  # 1992-07-01
    (49169.0, 28.0),  # 1993-07-01
    (49534.0, 29.0),  # 1994-07-01
    (50083.0, 30.0),  # 1996-01-01
    (50630.0, 31.0),  # 1997-07-01
    (51179.0, 32.0),  # 1999-01-01
    (53736.0, 33.0),  # 2006-01-01
    (54832.0, 34.0),  # 2009-01-01
    (56109.0, 35.0),  # 2012-07-01
    (57204.0, 36.0),  # 2015-07-01
    (57754.0, 37.0),  # 2017-01-01
])

TT_MINUS_TAI = 32.184


def tai_minus_utc(mjd_utc):
    """TAI-UTC in seconds for the given UTC MJD(s)."""
    mjd = np.asarray(mjd_utc, dtype=np.float64)
    idx = np.searchsorted(_LEAP_TABLE[:, 0], mjd, side="right") - 1
    idx = np.clip(idx, 0, len(_LEAP_TABLE) - 1)
    return _LEAP_TABLE[idx, 1]


def utc_to_tt(mjd_utc):
    """UTC MJD -> TT MJD."""
    return np.asarray(mjd_utc, np.float64) + \
        (tai_minus_utc(mjd_utc) + TT_MINUS_TAI) / SECPERDAY


def tdb_minus_tt(mjd_tt):
    """TDB-TT in seconds (truncated Fairhead & Bretagnon series).

    Dominant annual + planetary terms; good to ~30 us, which is well
    inside this module's documented envelope (TEMPO links the full
    series; the residual here is constant-ish over an observation).
    """
    T = (np.asarray(mjd_tt, np.float64) - MJD_J2000) / 36525.0
    # Mean anomaly of the Earth and the dominant Jupiter/Saturn terms.
    g = np.deg2rad(357.53 + 35999.050 * T)
    l_lj = np.deg2rad(246.11 + 32964.467 * T)   # L_earth - L_jupiter
    return (0.001657 * np.sin(g + 0.01671 * np.sin(g))
            + 0.000022 * np.sin(l_lj))


def utc_to_tdb(mjd_utc):
    """UTC MJD -> TDB MJD."""
    tt = utc_to_tt(mjd_utc)
    return tt + tdb_minus_tt(tt) / SECPERDAY


def gmst(mjd_ut1):
    """Greenwich mean sidereal time, radians in [0, 2pi).

    IAU 1982 polynomial expressed in the compact degree form.  UT1 is
    approximated by UTC (|dUT1| < 0.9 s -> < 2 us of Roemer error).
    """
    d = np.asarray(mjd_ut1, np.float64) - MJD_J2000
    T = d / 36525.0
    deg = (280.46061837 + 360.98564736629 * d
           + 0.000387933 * T * T - T * T * T / 38710000.0)
    return np.deg2rad(np.mod(deg, 360.0))


def nutation_angles(mjd_tt):
    """Truncated IAU1980 nutation: (dpsi, deps) in radians.

    Four largest terms (>0.2"), plenty for the equation of the
    equinoxes and the ~arcsecond-level frame rotation this package
    needs.
    """
    T = (np.asarray(mjd_tt, np.float64) - MJD_J2000) / 36525.0
    Om = np.deg2rad(125.04452 - 1934.136261 * T)
    Ls = np.deg2rad(280.4665 + 36000.7698 * T)
    Lm = np.deg2rad(218.3165 + 481267.8813 * T)
    dpsi = (-17.20 * np.sin(Om) - 1.32 * np.sin(2 * Ls)
            - 0.23 * np.sin(2 * Lm) + 0.21 * np.sin(2 * Om))
    deps = (9.20 * np.cos(Om) + 0.57 * np.cos(2 * Ls)
            + 0.10 * np.cos(2 * Lm) - 0.09 * np.cos(2 * Om))
    as2rad = np.pi / (180.0 * 3600.0)
    return dpsi * as2rad, deps * as2rad


def mean_obliquity(mjd_tt):
    """Mean obliquity of the ecliptic, radians (IAU 1980)."""
    T = (np.asarray(mjd_tt, np.float64) - MJD_J2000) / 36525.0
    eps = 23.439291111 - (46.8150 * T + 0.00059 * T * T
                          - 0.001813 * T * T * T) / 3600.0
    return np.deg2rad(eps)


def gast(mjd_ut1, mjd_tt=None):
    """Greenwich apparent sidereal time, radians."""
    if mjd_tt is None:
        mjd_tt = mjd_ut1
    dpsi, _ = nutation_angles(mjd_tt)
    return np.mod(gmst(mjd_ut1) + dpsi * np.cos(mean_obliquity(mjd_tt)),
                  2 * np.pi)


def mjd_to_calendar(mjd):
    """MJD -> (year, month, day, fractional day). Fliegel-Van Flandern."""
    jd = int(np.floor(mjd)) + 2400001  # JD at following midnight rounding
    frac = float(mjd) - np.floor(mjd)
    l = jd + 68569
    n = 4 * l // 146097
    l = l - (146097 * n + 3) // 4
    i = 4000 * (l + 1) // 1461001
    l = l - 1461 * i // 4 + 31
    j = 80 * l // 2447
    day = l - 2447 * j // 80
    l = j // 11
    month = j + 2 - 12 * l
    year = 100 * (n - 49) + i + l
    return int(year), int(month), int(day), frac


def calendar_to_mjd(year, month, day, frac=0.0):
    """(y, m, d[, frac]) -> MJD. Fliegel-Van Flandern (C-style
    truncating division, not Python floor division)."""
    # (month-14)/12 truncated toward zero: -1 for Jan/Feb, 0 otherwise.
    t = -1 if month <= 2 else 0
    jdn = (1461 * (year + 4800 + t)) // 4 \
        + (367 * (month - 2 - 12 * t)) // 12 \
        - (3 * ((year + 4900 + t) // 100)) // 4 \
        + day - 32075
    return jdn - 2400001 + frac
