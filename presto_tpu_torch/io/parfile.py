"""TEMPO/TEMPO2 .par pulsar-ephemeris parser.

Host copy of ``presto_tpu/io/parfile.py`` for the PyTorch port, which
imports nothing from the JAX package.

Parity targets: lib/python/parfile.py (psr_par class) and
src/readpar.c (get_psr_from_parfile).  Key-value lines with optional
fit-flag and error columns, Fortran 'D' exponents, P<->F derivation,
ELL1 (EPS1/EPS2/TASC) -> (E/OM/T0) conversion, and OrbitParams export
for the folding/search tools.
"""

from __future__ import annotations

import math
import re
from typing import Optional

from presto_tpu_torch.astro.bary import parse_ra, parse_dec
from presto_tpu_torch.ops.orbit import OrbitParams

SECPERDAY = 86400.0
TWOPI = 2.0 * math.pi

# parameter classes (parfile.py:48-57)
FLOAT_KEYS = {
    "PEPOCH", "POSEPOCH", "DM", "START", "FINISH", "NTOA", "TRES",
    "TZRMJD", "TZRFRQ", "NITS", "A1", "XDOT", "E", "ECC", "EDOT",
    "T0", "PB", "PBDOT", "OM", "OMDOT", "EPS1", "EPS2", "EPS1DOT",
    "EPS2DOT", "TASC", "LAMBDA", "BETA", "RA_RAD", "DEC_RAD", "GAMMA",
    "SINI", "M2", "MTOT", "XPBDOT", "ELAT", "ELONG", "PMLAMBDA",
    "PMBETA", "PX", "PMRA", "PMDEC", "PB_2", "A1_2", "E_2", "T0_2",
    "OM_2", "DMEPOCH",
}
FLOATN_PREFIXES = ("F", "P", "FB", "FD", "DMX_", "DMXEP_", "DMXR1_",
                   "DMXR2_", "DMXF1_", "DMXF2_")
# legacy bare spin keys ('P  0.714519' old-style pars) -> numbered form
LEGACY_ALIASES = {"P": "P0", "PD": "P1", "F": "F0", "FD": "F1"}
STR_KEYS = {"FILE", "PSR", "PSRJ", "PSRB", "EPHEM", "CLK", "BINARY",
            "RAJ", "DECJ", "UNITS", "TZRSITE"}


class Parfile:
    """Parsed .par file: parameters become attributes (self.F0,
    self.RAJ, ...), errors get an _ERR suffix.  Mirrors psr_par."""

    def __init__(self, parfilenm: str):
        self.FILE = parfilenm
        with open(parfilenm) as pf:
            for line in pf:
                self._parse_line(line)
        self._derive()

    # -- parsing ---------------------------------------------------- #

    def _parse_line(self, line: str) -> None:
        if line.startswith("#"):
            return
        line = line.replace("D-", "E-").replace("D+", "E+")
        parts = line.split()
        if not parts:
            return
        key = LEGACY_ALIASES.get(parts[0], parts[0])
        if key in STR_KEYS:
            setattr(self, key, parts[1])
        elif key in FLOAT_KEYS or self._is_floatn(key):
            try:
                setattr(self, key, float(parts[1]))
            except (ValueError, IndexError):
                return
        else:
            return
        # trailing columns: [fitflag] error  (parfile.py:104-109)
        if len(parts) == 3 and parts[2] not in ("0", "1"):
            try:
                setattr(self, key + "_ERR", float(parts[2]))
            except ValueError:
                pass
        elif len(parts) == 4:
            try:
                setattr(self, key + "_ERR", float(parts[3]))
            except ValueError:
                pass

    @staticmethod
    def _is_floatn(key: str) -> bool:
        """Numbered-family params: F0/F1/..., P0, FB0, FD1, DMX_0021
        (parfile.py:55-56 floatn_keys + regex at :75-77)."""
        m = re.match(r"^([A-Z]+_?)\d+$", key)
        return bool(m) and m.group(1) in FLOATN_PREFIXES

    # -- derived quantities (parfile.py:110-181) --------------------- #

    def _derive(self) -> None:
        if hasattr(self, "P0") and not hasattr(self, "F0"):
            self.F0 = 1.0 / self.P0
        if hasattr(self, "F0") and not hasattr(self, "P0"):
            self.P0 = 1.0 / self.F0
        if hasattr(self, "FB0") and not hasattr(self, "PB"):
            self.PB = (1.0 / self.FB0) / SECPERDAY
        if hasattr(self, "P1") and not hasattr(self, "F1"):
            self.F1 = -self.P1 / (self.P0 * self.P0)
        if hasattr(self, "F1") and not hasattr(self, "P1"):
            self.P1 = -self.F1 / (self.F0 * self.F0)
        if hasattr(self, "F2") and not hasattr(self, "P2") \
                and hasattr(self, "F0"):
            f0, f1, f2 = self.F0, getattr(self, "F1", 0.0), self.F2
            self.P2 = (2.0 * f1 * f1 / f0 - f2) / (f0 * f0)
        if hasattr(self, "RAJ"):
            self.RA_RAD = parse_ra(self.RAJ)
        if hasattr(self, "DECJ"):
            self.DEC_RAD = parse_dec(self.DECJ)
        if hasattr(self, "EPS1") and hasattr(self, "EPS2"):
            from presto_tpu_torch.ops.orbit import ell1_to_keplerian
            tasc = getattr(self, "TASC", 0.0)
            pb = getattr(self, "PB", 0.0)
            self.E, self.OM, t0 = ell1_to_keplerian(
                self.EPS1, self.EPS2, tasc, pb)
            if hasattr(self, "TASC") and hasattr(self, "PB"):
                self.T0 = t0
        if hasattr(self, "ECC") and not hasattr(self, "E"):
            self.E = self.ECC
        if hasattr(self, "PB") and hasattr(self, "A1") \
                and not hasattr(self, "E"):
            self.E = 0.0
        if hasattr(self, "T0") and not hasattr(self, "TASC") \
                and hasattr(self, "PB") and hasattr(self, "OM"):
            self.TASC = self.T0 - self.PB * self.OM / 360.0
        if hasattr(self, "T0") and not hasattr(self, "OM"):
            self.OM = 0.0

    # -- exports ---------------------------------------------------- #

    @property
    def name(self) -> str:
        return getattr(self, "PSRJ",
                       getattr(self, "PSR", getattr(self, "PSRB", "")))

    @property
    def is_binary(self) -> bool:
        return hasattr(self, "PB") and hasattr(self, "A1")

    def orbit(self, epoch: Optional[float] = None) -> Optional[OrbitParams]:
        """OrbitParams with p in seconds and (when epoch given) t set
        to seconds since the last periastron before `epoch` (MJD) —
        the convention psrepoch/fold expect (database.c:203-213)."""
        if not self.is_binary:
            return None
        p_sec = self.PB * SECPERDAY
        # PBDOT convention: literal values (e.g. '-2.423E-12') pass
        # through; bare TEMPO-style values ('-2.423') are in 1e-12
        # units (psr_par's |PBDOT|>1e-7 heuristic)
        pbdot = getattr(self, "PBDOT", 0.0)
        if abs(pbdot) > 1e-7:
            pbdot *= 1e-12
        orb = OrbitParams(p=p_sec, x=self.A1, e=getattr(self, "E", 0.0),
                          w=getattr(self, "OM", 0.0), pd=pbdot,
                          wd=getattr(self, "OMDOT", 0.0))
        if epoch is not None and hasattr(self, "T0"):
            t = SECPERDAY * (epoch - self.T0)
            orb.t = t % p_sec
        else:
            orb.t = getattr(self, "T0", 0.0)   # MJD until epoch applied
        return orb

    def spin_at(self, epoch: float):
        """(f, fd, fdd) advanced from PEPOCH to `epoch` (MJD)."""
        f0 = getattr(self, "F0", 0.0)
        f1 = getattr(self, "F1", 0.0)
        f2 = getattr(self, "F2", 0.0)
        dt = (epoch - getattr(self, "PEPOCH", epoch)) * SECPERDAY
        return (f0 + f1 * dt + 0.5 * f2 * dt * dt, f1 + f2 * dt, f2)

    def __str__(self) -> str:
        out = []
        for k, v in sorted(self.__dict__.items()):
            if isinstance(v, str):
                out.append("%10s = '%s'" % (k, v))
            else:
                out.append("%10s = %-20.15g" % (k, v))
        return "\n".join(out) + "\n"


def read_parfile(path: str) -> Parfile:
    return Parfile(path)
