"""Solar-system ephemerides: Earth w.r.t. the solar-system
barycenter, vectorized numpy.

Host copy of ``presto_tpu/astro/ephem.py`` for the PyTorch port, which
imports nothing from the JAX package.  One difference, by the port's
no-fallback rule: when ``data/epv.npz`` cannot be loaded the default
ephemeris raises; it never drops to the Keplerian model.  ``KEPLER``
stays an explicit choice.

Replaces the JPL DE200/DE405 ephemerides that the reference reaches
through TEMPO (src/barycenter.c:134 "EPHEM DE405").  The DEFAULT is
EpvEphemeris (bottom of file): the simplified VSOP2000 Earth solution
evaluated from ~2000 published Poisson-series coefficients shipped in
data/epv.npz — 4.6 km RMS vs JPL DE405 (sub-50-us Roemer), i.e. the
built-in path is km-grade with no external files.  A real JPL .bsp
kernel (astro/spk.py) remains the sub-us timing seam, and the
Keplerian AnalyticEphemeris below is the data-free model, chosen
by name (ephem="KEPLER").  AnalyticEphemeris construction:

  * Heliocentric positions of the eight planets (Earth-Moon barycenter
    for Earth) from Keplerian mean elements with secular rates
    (Standish's approximate elements, valid 1800-2050).
  * The Sun's offset from the solar-system barycenter from the mass-
    weighted planetary positions (dominated by Jupiter/Saturn; these
    orbits are nearly Keplerian so the offset is accurate to ~1e-5 AU).
  * The Earth's offset from the Earth-Moon barycenter from a truncated
    lunar theory (Meeus ch. 47 leading terms), weighted by
    1/(1+EMRAT); the truncation error enters Earth's position at the
    ~10 km * 0.012 level, i.e. negligible.
  * Velocities by central differencing (the series are smooth;
    dt=0.05 d gives ~1e-9 AU/day accuracy).

All vectors are equatorial J2000 (ICRS to within the frame tie),
units AU and AU/day, indexed by TDB Julian centuries from J2000.
"""

from __future__ import annotations

import os

import numpy as np

#: the shipped EPV2000 series (a copy of the JAX package's data/epv.npz)
EPV_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "epv.npz")

AU_M = 1.495978707e11          # AU in meters
C_M_S = 299792458.0            # speed of light m/s
AU_LIGHT_S = AU_M / C_M_S      # 499.004783836... s
EMRAT = 81.30056               # Earth/Moon mass ratio
OBLIQUITY_J2000 = np.deg2rad(23.439291111)
GMSUN_C3 = 4.925490947e-6      # 2*GM_sun/c^3 / 2 -> GM_sun/c^3 seconds

# Keplerian elements at J2000 and per-Julian-century rates, mean
# ecliptic/equinox of J2000 (Standish, "Approximate positions of the
# major planets", 1800AD-2050AD table):
#   a [AU], e, I [deg], L [deg], varpi [deg], Omega [deg]
_ELEMENTS = {
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350,
                 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175,
                 0.16047689, -0.12534081)),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950,
               131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729,
               0.00268329, -0.27769418)),
    "emb": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
             102.93768193, 0.0),
            (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
             0.32327364, 0.0)),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205,
              -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499,
              0.44441088, -0.29257343)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.00508664)),
}

# Sun/planet mass ratios (IAU/JPL values).
_MASS_RATIO = {
    "mercury": 6023682.0,
    "venus": 408523.72,
    "emb": 328900.56,
    "mars": 3098703.6,
    "jupiter": 1047.3486,
    "saturn": 3497.898,
    "uranus": 22902.98,
    "neptune": 19412.24,
}


def _kepler(M, e, tol=1e-12, maxiter=25):
    """Solve E - e sin E = M (radians), vectorized Newton iteration."""
    M = np.mod(M + np.pi, 2 * np.pi) - np.pi
    E = M + e * np.sin(M)
    for _ in range(maxiter):
        dE = (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
        E = E - dE
        if np.max(np.abs(dE)) < tol:
            break
    return E


def planet_helio_ecl(T, name):
    """Heliocentric J2000-ecliptic position of a planet, AU.

    T: TDB Julian centuries from J2000 (array).  Returns (..., 3).
    """
    el, rate = _ELEMENTS[name]
    T = np.asarray(T, np.float64)
    a = el[0] + rate[0] * T
    e = el[1] + rate[1] * T
    I = np.deg2rad(el[2] + rate[2] * T)
    L = np.deg2rad(el[3] + rate[3] * T)
    varpi = np.deg2rad(el[4] + rate[4] * T)
    Om = np.deg2rad(el[5] + rate[5] * T)

    M = L - varpi
    w = varpi - Om
    E = _kepler(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)

    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    cI, sI = np.cos(I), np.sin(I)
    x = (cw * cO - sw * sO * cI) * xp + (-sw * cO - cw * sO * cI) * yp
    y = (cw * sO + sw * cO * cI) * xp + (-sw * sO + cw * cO * cI) * yp
    z = (sw * sI) * xp + (cw * sI) * yp
    return np.stack([x, y, z], axis=-1)


def ssb_offset_ecl(T):
    """Position of the solar-system barycenter w.r.t. the Sun's center
    in the J2000 ecliptic frame, AU:  R = sum(m_p r_p) / M_total."""
    T = np.asarray(T, np.float64)
    num = np.zeros(T.shape + (3,))
    denom = 1.0
    for name, ratio in _MASS_RATIO.items():
        num = num + planet_helio_ecl(T, name) / ratio
        denom += 1.0 / ratio
    return num / denom


# --- Truncated lunar theory (Meeus ch. 47 leading terms) -------------
# Columns: (d, m, mp, f, coeff).  Longitude/latitude coeffs in 1e-6 deg,
# distance coeffs in 1e-3 km.  Terms with |coeff_lon| > 4000 or
# |coeff_r| > 8000 are kept; truncation error ~20 km in distance and
# ~10 arcsec in longitude, scaled into Earth's position by 1/82.3.
_LUN_LR = [
    # d  m  mp  f    lon(1e-6 deg)   r(1e-3 km)
    (0, 0, 1, 0, 6288774, -20905355),
    (2, 0, -1, 0, 1274027, -3699111),
    (2, 0, 0, 0, 658314, -2955968),
    (0, 0, 2, 0, 213618, -569925),
    (0, 1, 0, 0, -185116, 48888),
    (0, 0, 0, 2, -114332, -3149),
    (2, 0, -2, 0, 58793, 246158),
    (2, -1, -1, 0, 57066, -152138),
    (2, 0, 1, 0, 53322, -170733),
    (2, -1, 0, 0, 45758, -204586),
    (0, 1, -1, 0, -40923, -129620),
    (1, 0, 0, 0, -34720, 108743),
    (0, 1, 1, 0, -30383, 104755),
    (2, 0, 0, -2, 15327, 10321),
    (0, 0, 1, 2, -12528, 0),
    (0, 0, 1, -2, 10980, 79661),
    (4, 0, -1, 0, 10675, -34782),
    (0, 0, 3, 0, 10034, -23210),
    (4, 0, -2, 0, 8548, -21636),
    (2, 1, -1, 0, -7888, 24208),
    (2, 1, 0, 0, -6766, 30824),
    (1, 0, -1, 0, -5163, -8379),
    (1, 1, 0, 0, 4987, -16675),
    (2, -1, 1, 0, 4036, -12831),
]
_LUN_B = [
    # d  m  mp  f    lat(1e-6 deg)
    (0, 0, 0, 1, 5128122),
    (0, 0, 1, 1, 280602),
    (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237),
    (2, 0, -1, 1, 55413),
    (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573),
    (0, 0, 2, 1, 17198),
    (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822),
]


def moon_geo_ecl_date(T):
    """Geocentric Moon in the ecliptic *of date*: returns
    (lambda_deg, beta_deg, dist_km), vectorized."""
    T = np.asarray(T, np.float64)
    Lp = 218.3164477 + 481267.88123421 * T - 0.0015786 * T**2
    D = np.deg2rad(297.8501921 + 445267.1114034 * T - 0.0018819 * T**2)
    M = np.deg2rad(357.5291092 + 35999.0502909 * T - 0.0001536 * T**2)
    Mp = np.deg2rad(134.9633964 + 477198.8675055 * T + 0.0087414 * T**2)
    F = np.deg2rad(93.2720950 + 483202.0175233 * T - 0.0036539 * T**2)
    E = 1.0 - 0.002516 * T - 0.0000074 * T**2

    sl = np.zeros_like(T)
    sr = np.zeros_like(T)
    for d, m, mp, f, cl, cr in _LUN_LR:
        arg = d * D + m * M + mp * Mp + f * F
        ef = np.ones_like(T) if m == 0 else (E if abs(m) == 1 else E * E)
        sl = sl + cl * ef * np.sin(arg)
        sr = sr + cr * ef * np.cos(arg)
    sb = np.zeros_like(T)
    for d, m, mp, f, cb in _LUN_B:
        arg = d * D + m * M + mp * Mp + f * F
        ef = np.ones_like(T) if m == 0 else (E if abs(m) == 1 else E * E)
        sb = sb + cb * ef * np.sin(arg)

    lam = Lp + sl * 1e-6
    beta = sb * 1e-6
    dist = 385000.56 + sr * 1e-3
    return lam, beta, dist


def moon_geo_ecl_j2000(T):
    """Geocentric Moon in the J2000 ecliptic frame, AU."""
    lam, beta, dist = moon_geo_ecl_date(T)
    # Precess longitude from the ecliptic of date back to J2000 (the
    # dominant general-precession-in-longitude term; residual rotation
    # terms are < 1" / century and enter Earth's position at < 30 m).
    lam = np.deg2rad(lam - 1.3969713 * T)
    beta = np.deg2rad(beta)
    r = dist * 1000.0 / AU_M
    cb = np.cos(beta)
    return np.stack([r * cb * np.cos(lam),
                     r * cb * np.sin(lam),
                     r * np.sin(beta)], axis=-1)


def _ecl_to_equ(v):
    """Rotate J2000-ecliptic vectors to J2000-equatorial."""
    ce, se = np.cos(OBLIQUITY_J2000), np.sin(OBLIQUITY_J2000)
    x = v[..., 0]
    y = ce * v[..., 1] - se * v[..., 2]
    z = se * v[..., 1] + ce * v[..., 2]
    return np.stack([x, y, z], axis=-1)


def _earth_pos_ecl(T):
    """Earth (not EMB) w.r.t. SSB in the J2000 ecliptic frame, AU."""
    emb = planet_helio_ecl(T, "emb")
    moon = moon_geo_ecl_j2000(T)
    earth_helio = emb - moon / (1.0 + EMRAT)
    return earth_helio - ssb_offset_ecl(T)


class AnalyticEphemeris:
    """The built-in ephemeris; accepts TDB JD, returns J2000 equatorial
    AU / AU/day.  Stateless and vectorized."""

    name = "DEANALYTIC"

    def earth_posvel(self, jd_tdb):
        jd = np.asarray(jd_tdb, np.float64)
        T = (jd - 2451545.0) / 36525.0
        dt_days = 0.05
        dT = dt_days / 36525.0
        pos = _ecl_to_equ(_earth_pos_ecl(T))
        p_plus = _ecl_to_equ(_earth_pos_ecl(T + dT))
        p_minus = _ecl_to_equ(_earth_pos_ecl(T - dT))
        vel = (p_plus - p_minus) / (2.0 * dt_days)
        return pos, vel

    def sun_pos(self, jd_tdb):
        """Sun w.r.t. SSB, J2000 equatorial AU (for the Shapiro delay)."""
        jd = np.asarray(jd_tdb, np.float64)
        T = (jd - 2451545.0) / 36525.0
        return _ecl_to_equ(-ssb_offset_ecl(T))


class TabulatedEphemeris:
    """Precision seam: an ephemeris loaded from an .npz table with
    fields jd_tdb (N,), earth_pos (N,3) [AU], earth_vel (N,3) [AU/day],
    sun_pos (N,3) [AU] — e.g. exported from a JPL DE kernel elsewhere.
    Cubic Hermite interpolation on position using the tabulated
    velocities."""

    def __init__(self, path):
        dat = np.load(path)
        self.jd = dat["jd_tdb"]
        self.pos = dat["earth_pos"]
        self.vel = dat["earth_vel"]
        self.sunp = dat["sun_pos"]
        self.name = str(dat.get("name", "DETABLE"))

    def _hermite(self, jd, ya, yb, da, db, t, h):
        t2, t3 = t * t, t * t * t
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        return (h00[..., None] * ya + (h * h10)[..., None] * da
                + h01[..., None] * yb + (h * h11)[..., None] * db)

    def earth_posvel(self, jd_tdb):
        jd = np.atleast_1d(np.asarray(jd_tdb, np.float64))
        i = np.clip(np.searchsorted(self.jd, jd) - 1, 0, len(self.jd) - 2)
        h = self.jd[i + 1] - self.jd[i]
        t = (jd - self.jd[i]) / h
        pos = self._hermite(jd, self.pos[i], self.pos[i + 1],
                            self.vel[i], self.vel[i + 1], t, h)
        # derivative of the Hermite polynomial for velocity
        t2 = t * t
        d00 = (6 * t2 - 6 * t) / h
        d10 = 3 * t2 - 4 * t + 1
        d01 = (-6 * t2 + 6 * t) / h
        d11 = 3 * t2 - 2 * t
        vel = (d00[..., None] * self.pos[i] + d10[..., None] * self.vel[i]
               + d01[..., None] * self.pos[i + 1]
               + d11[..., None] * self.vel[i + 1])
        return pos, vel

    def sun_pos(self, jd_tdb):
        jd = np.atleast_1d(np.asarray(jd_tdb, np.float64))
        i = np.clip(np.searchsorted(self.jd, jd) - 1, 0, len(self.jd) - 2)
        h = (self.jd[i + 1] - self.jd[i])
        t = ((jd - self.jd[i]) / h)[..., None]
        return (1 - t) * self.sunp[i] + t * self.sunp[i + 1]


class EpvEphemeris:
    """The built-in KM-GRADE ephemeris: the simplified VSOP2000 Earth
    solution of X. Moisson & P. Bretagnon (2001, Celest. Mech. Dyn.
    Astron. 80, 205) — ~2000 published (amplitude, phase, frequency)
    Poisson-series coefficients, shipped in data/epv.npz
    (tools/make_epv_tables.py extracts them AS DATA from the tables
    the reference vendors in src/slalib/epv.f; no reference code is
    executed or translated).

    Model: each ecliptic component is
        P(t)  = Σ_{n=0..2} t^n Σ_j A cos(B + C t),   t = TDB Julian
    years from J2000, with the analytic frame tied to DE405/ICRS by a
    fixed published rotation.  Barycentric Earth = (Sun→Earth series)
    + (SSB→Sun series).  Stated accuracy vs JPL DE405 over 1900-2100:
    4.6 km RMS / 13.4 km max barycentric position, 1.4 mm/s RMS
    velocity — i.e. sub-50-µs absolute Roemer, timing-grade for
    everything short of µs pulsar timing (which uses a real JPL .bsp
    via astro/spk.py).
    """

    name = "EPV2000"

    # frame tie to DE405/ICRS (published empirical rotation)
    _AM = np.array([
        [1.0, +0.000000211284, -0.000000091603],
        [-0.000000230286, +0.917482137087, -0.397776982902],
        [0.0, +0.397776982902, +0.917482137087]])

    def __init__(self):
        dat = np.load(EPV_PATH)
        # per body ('e' Sun->Earth, 's' SSB->Sun), per power, per
        # component: [n, 3] (A, B, C)
        self._ser = {b: [[dat["%s%d%s" % (b.upper(), p, c)]
                          for c in "xyz"] for p in range(3)]
                     for b in ("e", "s")}

    def _eval(self, t, bodies):
        """Σ of the named series at t [Julian years from J2000]:
        (pos_ecl [.., 3] AU, vel_ecl [.., 3] AU/day).  t is flattened
        (callers reshape) so N-D epoch arrays work like the Keplerian
        model's."""
        t = np.atleast_1d(np.asarray(t, np.float64)).ravel()
        pos = np.zeros(t.shape + (3,))
        vel = np.zeros(t.shape + (3,))
        for b in bodies:
            for p in range(3):
                tp = t ** p
                for c in range(3):
                    A, B, C = self._ser[b][p][c].T
                    ph = B[:, None] + C[:, None] * t[None]
                    cp = np.cos(ph)
                    pos[..., c] += tp * (A[:, None] * cp).sum(0)
                    # d/dt of t^p A cos(B + C t)
                    dv = (A[:, None]
                          * (-C[:, None] * np.sin(ph))).sum(0) * tp
                    if p:
                        dv += (p * t ** (p - 1)
                               * (A[:, None] * cp).sum(0))
                    vel[..., c] += dv
        return pos, vel / 365.25

    def earth_posvel(self, jd_tdb):
        """Barycentric Earth (pos AU, vel AU/day), ICRS."""
        jd = np.asarray(jd_tdb, np.float64)
        t = (jd - 2451545.0) / 365.25
        pos, vel = self._eval(t, ("e", "s"))
        shape = np.shape(jd) + (3,)
        return (pos @ self._AM.T).reshape(shape), \
            (vel @ self._AM.T).reshape(shape)

    def sun_pos(self, jd_tdb):
        """Sun w.r.t. SSB, ICRS AU (for the Shapiro delay)."""
        jd = np.asarray(jd_tdb, np.float64)
        t = (jd - 2451545.0) / 365.25
        pos, _ = self._eval(t, ("s",))
        return (pos @ self._AM.T).reshape(np.shape(jd) + (3,))


_DEFAULT = None


def _default_ephemeris():
    """The shipped default: EPV2000 (km-grade).  A missing or unreadable
    data/epv.npz raises: the Keplerian model is ~3 orders of magnitude
    less accurate, and substituting it would corrupt TOA provenance."""
    global _DEFAULT
    if _DEFAULT is None:
        try:
            _DEFAULT = EpvEphemeris()
        except (OSError, KeyError) as e:
            raise RuntimeError(
                "EPV2000 ephemeris tables (data/epv.npz) unavailable "
                "(%s); pass ephem='KEPLER' for the Keplerian analytic "
                "model (~12,000 km Earth position error vs EPV's ~5 km)"
                % (e,)) from e
    return _DEFAULT


def get_ephemeris(name="DEANALYTIC"):
    """Resolve an ephemeris spec.  Bare names ('DE200'/'DE405'/
    'DEANALYTIC'/'EPV2000') map to the built-in EPV2000 series (API
    parity with barycenter.c:134 — callers pass DE405 and get the
    km-grade built-in); a path ending in .npz loads a table, .bsp a
    JPL SPK kernel; 'KEPLER' forces the data-free analytic model;
    'AUTO' takes a DE kernel from the port's kernel cache, else the
    builtin EPV2000 kernel (astro/kernels)."""
    if name is None:
        return _default_ephemeris()
    s = str(name)
    if s.upper() == "KEPLER":
        return AnalyticEphemeris()
    if s.upper() == "AUTO":
        # kernel-provisioning ladder (astro/kernels.py): a real JPL
        # DE file placed in the cache, else the builtin EPV2000 kernel
        # generated at first use — the .bsp route with zero user setup
        # (the reference's TEMPO+DE405 out-of-box parity)
        from presto_tpu_torch.astro.kernels import resolve_kernel
        from presto_tpu_torch.astro.spk import SPKEphemeris
        return SPKEphemeris(resolve_kernel()[0])
    if s.lower().endswith(".npz"):
        return TabulatedEphemeris(s)
    if s.lower().endswith(".bsp"):
        from presto_tpu_torch.astro.spk import SPKEphemeris
        return SPKEphemeris(s)
    # Path-like names that are not a recognized ephemeris file must NOT
    # silently fall back to the analytic model — the user believes
    # their kernel is in use while barycentering runs at search grade.
    # (Bare names like 'DE405' always select the analytic model, even
    # if a same-named file happens to exist in the cwd.)
    if os.path.sep in s:
        raise ValueError(
            f"unrecognized ephemeris file {s!r}: expected a .bsp (JPL "
            f"SPK kernel) or .npz table; bare names like 'DE405' select "
            f"the built-in ephemeris")
    return _default_ephemeris()


def earth_posvel_ssb(jd_tdb, ephem="DEANALYTIC"):
    """Earth center w.r.t. SSB: (pos AU, vel AU/day), J2000 equatorial."""
    return get_ephemeris(ephem).earth_posvel(jd_tdb)
