"""Pulsar catalog: lookup of known-pulsar parameters at an epoch.

Host copy of ``presto_tpu/utils/catalog.py`` for the PyTorch port,
which imports nothing from the JAX package.  The port reads no
environment variable: an ATNF text export is read with
``load_catalog(path)`` (the JAX package also reads
``$PRESTO_TPU_CATALOG`` into its default catalog).

Parity targets:
  src/database.c — get_psr_at_epoch (:167-230, spin/orbit advance to
    the observation epoch), psr_number_from_name lookup;
  lib/python/pypsrcat.py — parser for the ATNF psrcat "Short with
    errors" text export (lib/psr_catalog.txt format);
  python/presto_src/__init__.py:62 psrepoch();
  src/responses.c:92-140 binary_velocity().

The reference ships a snapshot of the ATNF catalog (lib/psr_catalog.txt,
3033 pulsars).  Here a small built-in catalog of bright/famous pulsars
covers tests and offline use, beside the shipped ~1000-pulsar
data/pulsars.psrcat; a full ATNF text export is read by
load_catalog(path) — the parser reads the same column layout the
reference's pypsrcat.py consumes.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from presto_tpu_torch.ops.orbit import (OrbitParams, keplers_eqn, E_to_v,
                                        SOL)

SECPERDAY = 86400.0
TWOPI = 2.0 * math.pi


@dataclass
class PsrParams:
    """Spin/astrometric/orbit parameters of a catalog pulsar
    (include/database.h:42-66 psrparams)."""
    jname: str = ""
    bname: str = ""
    ra2000: float = 0.0          # radians
    dec2000: float = 0.0         # radians
    ra_str: str = ""
    dec_str: str = ""
    p: float = 0.0               # s
    pd: float = 0.0
    pdd: float = 0.0
    f: float = 0.0               # Hz
    fd: float = 0.0
    fdd: float = 0.0
    dm: float = 0.0
    timepoch: float = 0.0        # MJD of p/f values
    orb: Optional[OrbitParams] = None   # orb.p in SECONDS once at-epoch

    @property
    def name(self) -> str:
        return self.jname or self.bname


from presto_tpu_torch.astro.bary import parse_ra as _hms_to_rad
from presto_tpu_torch.astro.bary import parse_dec as _dms_to_rad


# Built-in mini-catalog.  Public astronomical facts (ATNF psrcat
# values); enough pulsars for zap lists, tests, and demos.  Fields:
# PB days, A1 lt-s, OM deg, T0 MJD.
_BUILTIN: List[dict] = [
    dict(bname="B0329+54", jname="J0332+5434", raj="03:32:59.4",
         decj="+54:34:43.6", p0=0.714519699726, p1=2.04961e-15,
         pepoch=46473.0, dm=26.7641),
    dict(bname="B0531+21", jname="J0534+2200", raj="05:34:31.97",
         decj="+22:00:52.06", p0=0.0333924123, p1=4.20972e-13,
         pepoch=40000.0, dm=56.771),
    dict(bname="B0833-45", jname="J0835-4510", raj="08:35:20.61",
         decj="-45:10:34.88", p0=0.089328385024, p1=1.25008e-13,
         pepoch=51559.319, dm=67.99),
    dict(bname="B1937+21", jname="J1939+2134", raj="19:39:38.56",
         decj="+21:34:59.14", p0=0.00155780644887275,
         p1=1.051193e-19, pepoch=52601.0, dm=71.0151),
    dict(bname="B0950+08", jname="J0953+0755", raj="09:53:09.31",
         decj="+07:55:35.75", p0=0.2530651649482, p1=2.29758e-16,
         pepoch=46375.0, dm=2.97),
    dict(bname="B1919+21", jname="J1921+2153", raj="19:21:44.815",
         decj="+21:53:02.25", p0=1.3373021601895, p1=1.34809e-15,
         pepoch=48999.0, dm=12.4309),
    dict(jname="J0437-4715", raj="04:37:15.88", decj="-47:15:09.11",
         p0=0.005757451936712637, p1=5.729e-20, pepoch=54500.0,
         dm=2.64476, pb=5.7410459, a1=3.36669157, ecc=1.918e-5,
         om=1.22, t0=54501.4671),
    dict(bname="B1913+16", jname="J1915+1606", raj="19:15:27.99",
         decj="+16:06:27.38", p0=0.059030003217813, p1=8.6183e-18,
         pepoch=52984.0, dm=168.77, pb=0.322997448918,
         a1=2.341782, ecc=0.6171338, om=292.54450, t0=52144.90097844),
    dict(bname="B1957+20", jname="J1959+2048", raj="19:59:36.77",
         decj="+20:48:15.12", p0=0.00160740168480632, p1=1.685e-20,
         pepoch=48196.0, dm=29.1168, pb=0.38196748742,
         a1=0.0892253, ecc=0.0, om=0.0, t0=48196.0635242),
    dict(jname="J0737-3039A", raj="07:37:51.25", decj="-30:39:40.71",
         p0=0.0226993785996239, p1=1.75993e-18, pepoch=53156.0,
         dm=48.920, pb=0.10225156248, a1=1.415032, ecc=0.0877775,
         om=87.0331, t0=53155.9074280),
    dict(bname="B1821-24", jname="J1824-2452A", raj="18:24:32.008",
         decj="-24:52:10.8", p0=0.0030542120468132, p1=1.61857e-18,
         pepoch=54500.0, dm=120.502),
    dict(bname="B0656+14", jname="J0659+1414", raj="06:59:48.13",
         decj="+14:14:21.5", p0=0.384891195054, p1=5.50130e-14,
         pepoch=49721.0, dm=13.977),
]


class Catalog:
    """Name -> PsrParams lookup over a list of catalog records."""

    def __init__(self, records: List[dict]):
        self.records = records
        self._index: Dict[str, int] = {}
        for i, r in enumerate(records):
            for key in (r.get("jname"), r.get("bname")):
                if key:
                    self._index.setdefault(key.lstrip("JB").upper(), i)
                    self._index.setdefault(key.upper(), i)

    def __len__(self):
        return len(self.records)

    def lookup(self, name: str) -> Optional[dict]:
        """Find a record by J/B name, with or without the prefix
        (psr_number_from_name database.c:118-150 strips J/B/PSR)."""
        name = name.upper()
        for cand in (name, name.lstrip("JB"),
                     "J" + name, "B" + name):
            if cand in self._index:
                return self.records[self._index[cand]]
        return None

    def params(self, name: str) -> Optional[PsrParams]:
        r = self.lookup(name)
        if r is None:
            return None
        p0 = r.get("p0", 0.0)
        p1 = r.get("p1", 0.0)
        f = 1.0 / p0 if p0 else 0.0
        fd = -p1 * f * f if p0 else 0.0
        orb = None
        if r.get("pb"):
            orb = OrbitParams(p=r["pb"],        # days until psrepoch()
                              x=r.get("a1", 0.0), e=r.get("ecc", 0.0),
                              w=r.get("om", 0.0), t=r.get("t0", 0.0))
        return PsrParams(
            jname=r.get("jname", ""), bname=r.get("bname", ""),
            ra_str=r.get("raj", ""), dec_str=r.get("decj", ""),
            ra2000=_hms_to_rad(r["raj"]) if r.get("raj") else 0.0,
            dec2000=_dms_to_rad(r["decj"]) if r.get("decj") else 0.0,
            p=p0, pd=p1, f=f, fd=fd, fdd=r.get("f2", 0.0),
            dm=r.get("dm", 0.0), timepoch=r.get("pepoch", 51000.0),
            orb=orb)


# ATNF "Short with errors" column order (pypsrcat.py:14-18); columns in
# ERR_PARAMS are followed by an error token.
_PARAMS = ["NAME", "PSRJ", "RAJ", "DECJ", "PMRA", "PMDEC", "PX",
           "POSEPOCH", "GL", "GB", "P0", "P1", "F2", "F3", "PEPOCH",
           "DM", "DM1", "S400", "S1400", "BINARY", "T0", "PB", "A1",
           "OM", "ECC", "TASC", "EPS1", "EPS2", "DIST", "ASSOC",
           "SURVEY", "PSR"]
_ERR_PARAMS = {"RAJ", "DECJ", "PMRA", "PMDEC", "PX", "P0", "P1", "F2",
               "F3", "DM", "DM1", "S400", "S1400", "T0", "PB", "A1",
               "OM", "ECC", "TASC", "EPS1", "EPS2"}


def parse_atnf_catalog(path: str) -> List[dict]:
    """Parse an ATNF psrcat text export in the reference's
    lib/psr_catalog.txt layout (leading index column, '*' for missing,
    value+error token pairs for measured quantities)."""
    records = []
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith(("#", "-")):
                continue
            parts = line.split()[1:]       # drop the index column
            vals = {}
            pi = 0
            for param in _PARAMS:
                if pi >= len(parts):
                    break
                tok = parts[pi]
                if tok != "*":
                    vals[param] = tok
                pi += 1
                if param in _ERR_PARAMS:
                    pi += 1    # value+error token pairs ('* 0' when
                               # missing) — pypsrcat.py part_index += 1
            rec = {}
            if "NAME" in vals and vals["NAME"].startswith("B"):
                rec["bname"] = vals["NAME"]
            if "PSRJ" in vals:
                rec["jname"] = vals["PSRJ"]
            if "RAJ" in vals:
                rec["raj"] = vals["RAJ"]
            if "DECJ" in vals:
                rec["decj"] = vals["DECJ"]
            for src, dst in (("P0", "p0"), ("P1", "p1"), ("F2", "f2"),
                             ("PEPOCH", "pepoch"), ("DM", "dm"),
                             ("PB", "pb"), ("A1", "a1"), ("OM", "om"),
                             ("ECC", "ecc"), ("T0", "t0"),
                             ("TASC", "tasc"), ("EPS1", "eps1"),
                             ("EPS2", "eps2")):
                if src in vals:
                    try:
                        rec[dst] = float(vals[src])
                    except ValueError:
                        pass
            # ELL1 binaries: (TASC, EPS1, EPS2) -> (T0, ECC, OM)
            if "tasc" in rec and "t0" not in rec:
                from presto_tpu_torch.ops.orbit import ell1_to_keplerian
                ecc, om, t0 = ell1_to_keplerian(
                    rec.get("eps1", 0.0), rec.get("eps2", 0.0),
                    rec["tasc"], rec.get("pb", 0.0))
                rec["ecc"], rec["om"] = ecc, om
                if rec.get("pb"):
                    rec["t0"] = t0
            if rec.get("jname") or rec.get("bname"):
                records.append(rec)
    return records


def parse_compact_catalog(path: str) -> List[dict]:
    """Parse the shipped compact TSV catalog
    (presto_tpu_torch/data/pulsars.psrcat, a copy of the JAX package's,
    written by tools/make_catalog.py:
    header line naming the fields, '*' for missing)."""
    records = []
    fields = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                if "\t" in line:       # the field-name header
                    fields = line[1:].split()
                continue
            if not line.strip() or fields is None:
                continue
            rec = {}
            for k, tok in zip(fields, line.rstrip("\n").split("\t")):
                if tok == "*" or not tok:
                    continue
                if k in ("bname", "jname", "raj", "decj"):
                    rec[k] = tok
                else:
                    try:
                        rec[k] = float(tok)
                    except ValueError:
                        pass
            if rec.get("jname") or rec.get("bname"):
                records.append(rec)
    return records


def shipped_catalog_path() -> Optional[str]:
    """The catalog file shipped with the package (the lib/pulsars.cat
    analog, src/database.c:676), or None if absent."""
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "pulsars.psrcat")
    return p if os.path.exists(p) else None


def default_birds_path() -> Optional[str]:
    """The shipped default birdie list (the lib/parkes_birds.txt
    analog): power-mains harmonics."""
    p = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "default_birds.txt")
    return p if os.path.exists(p) else None


_default: Optional[Catalog] = None


def default_catalog() -> Catalog:
    """The shipped ~1000-pulsar catalog (+ builtin mini list)."""
    global _default
    if _default is None:
        records = list(_BUILTIN)
        shipped = shipped_catalog_path()
        if shipped:
            records = records + parse_compact_catalog(shipped)
        _default = Catalog(records)
    return _default


def load_catalog(path: str) -> Catalog:
    return Catalog(parse_atnf_catalog(path))


def psrepoch(psrname: str, epoch: float,
             catalog: Optional[Catalog] = None) -> PsrParams:
    """Catalog parameters advanced to `epoch` (MJD): spin frequency by
    its derivatives, orbital period to seconds, orb.t to seconds since
    the last periastron (get_psr_at_epoch database.c:167-230)."""
    cat = catalog or default_catalog()
    psr = cat.params(psrname)
    if psr is None:
        raise KeyError("PSR %s not found in catalog" % psrname)
    difft = SECPERDAY * (epoch - psr.timepoch)
    f, fd = psr.f, psr.fd
    psr.f = f + fd * difft + 0.5 * psr.fdd * difft * difft
    psr.fd = fd + psr.fdd * difft
    psr.p = 1.0 / psr.f
    psr.pd = -psr.fd * psr.p * psr.p
    # note: the reference evaluates pdd with the PRE-advance f/fd
    # (database.c:199); here the advanced values are used so p/pd/pdd
    # are all consistent at the returned timepoch
    psr.pdd = ((2.0 * psr.fd * psr.fd / psr.f - psr.fdd)
               / (psr.f * psr.f)) if psr.f else 0.0
    psr.timepoch = epoch
    if psr.orb is not None and psr.orb.p:
        difft = SECPERDAY * (epoch - psr.orb.t)   # orb.t held T0 (MJD)
        psr.orb.p = psr.orb.p * SECPERDAY + psr.orb.pd * difft
        psr.orb.t = math.fmod(difft, psr.orb.p)
        if psr.orb.t < 0.0:
            psr.orb.t += psr.orb.p
        psr.orb.w = psr.orb.w + psr.orb.wd * (difft / (SECPERDAY * 365.25))
    return psr


def binary_velocity(T: float, orb: OrbitParams):
    """(min, max) pulsar radial velocity (v/c) during an observation of
    length T seconds (binary_velocity responses.c:92-140).  orb.p in
    seconds, orb.t seconds since periastron at obs start."""
    if T >= orb.p:
        c1 = TWOPI * orb.x / (orb.p * math.sqrt(1.0 - orb.e ** 2))
        c2 = orb.e * math.cos(math.radians(orb.w))
        return c1 * (c2 - 1.0), c1 * (c2 + 1.0)
    t = orb.t + np.linspace(0.0, T, 1025)
    E = keplers_eqn(t, orb.p, orb.e)
    v = E_to_v(E, orb) * 1000.0 / SOL     # km/s -> v/c
    return float(np.min(v)), float(np.max(v))
