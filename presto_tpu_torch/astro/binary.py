"""Binary-pulsar orbital calculations driven by a .par file.

Host copy of ``presto_tpu/astro/binary.py`` for the PyTorch port, which
imports nothing from the JAX package.

Parity target: lib/python/binary_psr.py (class binary_psr) — anomalies,
orbital position, radial velocity, Doppler period, TOA demodulation,
and Shapiro-delay predictions.  Built on the vectorized Kepler solver
in ops.orbit rather than the reference's fixed-point iteration.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.io.parfile import Parfile
from presto_tpu_torch.ops.orbit import SOL, keplers_eqn

TWOPI = 2.0 * np.pi
SECPERDAY = 86400.0
SECPERJULYR = 86400.0 * 365.25
DEGTORAD = np.pi / 180.0
Tsun = 4.925490947e-6      # GM_sun/c^3 (s)


def shapiro_R(m2: float) -> float:
    """Shapiro 'R' (range) parameter in seconds, companion mass in
    solar units (binary_psr.py:12-17)."""
    return Tsun * m2


def shapiro_S(m1: float, m2: float, x: float, pb: float) -> float:
    """Shapiro 'S' (shape = sin i) from masses (solar), x (lt-s), and
    pb (days) (binary_psr.py:20-28)."""
    return (x * (pb * SECPERDAY / TWOPI) ** (-2.0 / 3.0)
            * Tsun ** (-1.0 / 3.0) * (m1 + m2) ** (2.0 / 3.0) / m2)


def true_anomaly(E, ecc: float):
    """Eccentric -> true anomaly (psr_utils.true_anomaly)."""
    return 2.0 * np.arctan(np.sqrt((1.0 + ecc) / (1.0 - ecc))
                           * np.tan(E / 2.0))


class BinaryPsr:
    """Orbital calculations for a binary pulsar from its .par file."""

    def __init__(self, parfilenm: str):
        self.par = Parfile(parfilenm) if isinstance(parfilenm, str) \
            else parfilenm
        if not self.par.is_binary:
            raise ValueError("%s has no binary parameters"
                             % getattr(self.par, "FILE", "parfile"))
        self.PBsec = self.par.PB * SECPERDAY
        self.T0 = self.par.T0

    # -- anomalies --------------------------------------------------- #

    def calc_anoms(self, MJD):
        """(mean, eccentric, true) anomalies (radians) at barycentric
        MJD(s) (binary_psr.py:51-64)."""
        MJD = np.atleast_1d(np.asarray(MJD, dtype=np.float64))
        difft = (MJD - self.T0) * SECPERDAY
        since_peri = np.fmod(difft, self.PBsec)
        since_peri[since_peri < 0] += self.PBsec
        mean_anom = since_peri / self.PBsec * TWOPI
        ecc_anom = self.eccentric_anomaly(mean_anom)
        return mean_anom, ecc_anom, true_anomaly(ecc_anom, self.par.E)

    def eccentric_anomaly(self, mean_anomaly):
        """Solve Kepler's equation (binary_psr.py:78-93) via the shared
        vectorized solver in ops.orbit (fixed-point warmup + Newton)."""
        ma = np.fmod(np.asarray(mean_anomaly, dtype=np.float64), TWOPI)
        ma = np.where(ma < 0.0, ma + TWOPI, ma)
        return np.atleast_1d(keplers_eqn(ma / TWOPI * self.PBsec,
                                         self.PBsec, self.par.E,
                                         acc=5e-15))

    def most_recent_peri(self, MJD):
        """MJD(s) of the last periastron before MJD
        (binary_psr.py:66-76)."""
        MJD = np.atleast_1d(np.asarray(MJD, dtype=np.float64))
        days = np.fmod(MJD - self.T0, self.par.PB)
        days[days < 0] += self.par.PB
        return MJD - days

    def calc_omega(self, MJD):
        """Argument of periastron (radians) incl. OMDOT advance
        (binary_psr.py:95-107)."""
        MJD = np.atleast_1d(np.asarray(MJD, dtype=np.float64))
        om = getattr(self.par, "OM", 0.0)
        omdot = getattr(self.par, "OMDOT", 0.0)
        if omdot:
            difft = (MJD - self.T0) * SECPERDAY
            return (om + difft / SECPERJULYR * omdot) * DEGTORAD
        return np.full_like(MJD, om * DEGTORAD)

    # -- observables ------------------------------------------------- #

    def radial_velocity(self, MJD):
        """Pulsar radial velocity (km/s) at MJD(s)
        (binary_psr.py:109-120)."""
        _, ea, _ = self.calc_anoms(MJD)
        ws = self.calc_omega(MJD)
        e = self.par.E
        c1 = TWOPI * self.par.A1 / self.PBsec
        c2 = np.cos(ws) * np.sqrt(1 - e * e)
        cea = np.cos(ea)
        return (SOL / 1000.0) * c1 * (c2 * cea - np.sin(ws) * np.sin(ea)) \
            / (1.0 - e * cea)

    def doppler_period(self, MJD):
        """Observed spin period (s) at MJD(s) (binary_psr.py:122-128)."""
        vs = self.radial_velocity(MJD) * 1000.0
        return self.par.P0 * (1.0 + vs / SOL)

    def position(self, MJD, inc: float = 60.0, returnz: bool = False):
        """Orbital position in lt-s: x along the line of sight (+
        towards us), y in the sky plane (binary_psr.py:130-154)."""
        _, _, ta = self.calc_anoms(MJD)
        ws = self.calc_omega(MJD)
        orb_phs = ta + ws
        sini = np.sin(inc * DEGTORAD)
        e = self.par.E
        x = self.par.A1 / sini
        r = x * (1.0 - e * e) / (1.0 + e * np.cos(ta))
        xs = -r * np.sin(orb_phs) * sini
        ys = -r * np.cos(orb_phs)
        if returnz:
            return xs, ys, -r * np.sin(orb_phs) * np.cos(inc * DEGTORAD)
        return xs, ys

    def demodulate_TOAs(self, MJD):
        """Remove orbital modulation from arrival times via the
        Deeter, Boynton & Pravdo (1981) Newton iteration
        (binary_psr.py:176-197)."""
        MJD = np.atleast_1d(np.asarray(MJD, dtype=np.float64))
        ts = MJD.copy()
        for _ in range(100):
            xs = -self.position(ts, inc=90.0)[0] / SECPERDAY  # lt-days
            dxs = self.radial_velocity(ts) * 1000.0 / SOL
            dts = (ts + xs - MJD) / (1.0 + dxs)
            ts = ts - dts
            if np.max(np.abs(dts)) < 1e-10:
                break
        return ts

    def shapiro_delays(self, R: float, S: float, ecc_anoms):
        """Predicted Shapiro delay (us) at eccentric anomalies
        (binary_psr.py:199-215)."""
        canoms = np.cos(ecc_anoms)
        sanoms = np.sin(ecc_anoms)
        ecc = self.par.E
        omega = self.par.OM * DEGTORAD
        return -2.0e6 * R * np.log(
            1.0 - ecc * canoms
            - S * (np.sin(omega) * (canoms - ecc)
                   + np.sqrt(1.0 - ecc * ecc) * np.cos(omega) * sanoms))

    def shapiro_measurable(self, R: float, S: float, mean_anoms):
        """Measurable part of the Shapiro delay (us), Freire & Wex
        2010 eqn 28, low-eccentricity limit (binary_psr.py:218-235)."""
        Phi = mean_anoms + self.par.OM * DEGTORAD
        cbar = np.sqrt(1.0 - S * S)
        zeta = S / (1.0 + cbar)
        h3 = R * zeta ** 3
        sPhi = np.sin(Phi)
        return -2.0e6 * h3 * (
            np.log(1.0 + zeta * zeta - 2.0 * zeta * sPhi) / zeta ** 3
            + 2.0 * sPhi / zeta ** 2 - np.cos(2.0 * Phi) / zeta)


binary_psr = BinaryPsr   # reference-compatible alias
