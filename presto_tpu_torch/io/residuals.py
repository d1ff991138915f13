"""TEMPO resid2.tmp reader (lib/python/residuals.py analog).

Host copy of ``presto_tpu/io/residuals.py`` for the PyTorch port, which
imports nothing from the JAX package.

resid2.tmp is a Fortran-unformatted file of 9-float64 (72-byte)
records: (bary TOA [MJD], postfit residual [pulse phase], postfit
residual [sec], orbital phase, bary obs freq [MHz], weight, timing
uncertainty [us], prefit residual [sec], ddm).  Each record is wrapped
in block markers whose width depends on the Fortran compiler; the
reference autodetects g77 (4-byte) vs gfortran (8-byte) markers
(src/barycenter.c read_resid_rec) — mirrored here.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_RECLEN = 72


@dataclass
class Residuals:
    numTOAs: int = 0
    bary_TOA: np.ndarray = field(default_factory=lambda: np.zeros(0))
    postfit_phs: np.ndarray = field(default_factory=lambda: np.zeros(0))
    postfit_sec: np.ndarray = field(default_factory=lambda: np.zeros(0))
    orbit_phs: np.ndarray = field(default_factory=lambda: np.zeros(0))
    bary_freq: np.ndarray = field(default_factory=lambda: np.zeros(0))
    weight: np.ndarray = field(default_factory=lambda: np.zeros(0))
    uncertainty: np.ndarray = field(default_factory=lambda: np.zeros(0))
    prefit_phs: np.ndarray = field(default_factory=lambda: np.zeros(0))
    prefit_sec: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ddm: np.ndarray = field(default_factory=lambda: np.zeros(0))


def _detect_marker(raw: bytes) -> int:
    """Marker width: the record marker holds the record length (72) as
    int32 (g77) or int64 (gfortran).  The low 4 bytes of a little-
    endian int64 72 also read as int32 72, so the TRAILING marker
    position disambiguates (the reference autodetects the same way,
    src/barycenter.c read_resid_rec)."""
    for m, fmt in ((4, "<i"), (8, "<q")):
        end = m + _RECLEN
        if (len(raw) >= end + m
                and struct.unpack(fmt, raw[:m])[0] == _RECLEN
                and struct.unpack(fmt, raw[end:end + m])[0] == _RECLEN):
            return m
    raise ValueError("not a resid2.tmp file (no Fortran record marker)")


def read_residuals(path: str) -> Residuals:
    with open(path, "rb") as f:
        raw = f.read()
    m = _detect_marker(raw)
    recsize = m + _RECLEN + m
    n = len(raw) // recsize
    rows = np.zeros((n, 9))
    for i in range(n):
        off = i * recsize
        rows[i] = np.frombuffer(raw[off + m:off + m + _RECLEN],
                                dtype="<f8")
    r = Residuals(numTOAs=n)
    r.bary_TOA = rows[:, 0]
    r.postfit_phs = rows[:, 1]
    r.postfit_sec = rows[:, 2]
    r.orbit_phs = rows[:, 3]
    r.bary_freq = rows[:, 4]
    r.weight = rows[:, 5]
    r.uncertainty = rows[:, 6]
    r.prefit_sec = rows[:, 7]
    r.ddm = rows[:, 8]
    # prefit residual in phase derived from sec via the TOA spacing is
    # not recoverable without the ephemeris; expose sec only
    r.prefit_phs = np.zeros(n)
    return r


def write_residuals(path: str, bary_TOA: np.ndarray,
                    postfit_phs: np.ndarray, postfit_sec: np.ndarray,
                    orbit_phs=None, bary_freq=None, weight=None,
                    uncertainty=None, prefit_sec=None, ddm=None,
                    marker: int = 4) -> None:
    """Write resid2.tmp (used for tests and for feeding tools that
    expect TEMPO output)."""
    n = len(bary_TOA)

    def arr(x):
        return np.zeros(n) if x is None else np.asarray(x, float)

    cols = [np.asarray(bary_TOA, float), np.asarray(postfit_phs, float),
            np.asarray(postfit_sec, float), arr(orbit_phs),
            arr(bary_freq), arr(weight), arr(uncertainty),
            arr(prefit_sec), arr(ddm)]
    fmt = "<i" if marker == 4 else "<q"
    with open(path, "wb") as f:
        for i in range(n):
            rec = b"".join(struct.pack("<d", c[i]) for c in cols)
            f.write(struct.pack(fmt, _RECLEN))
            f.write(rec)
            f.write(struct.pack(fmt, _RECLEN))
