"""JPL SPK (.bsp) planetary-ephemeris kernel reader, pure NumPy.

Host copy of ``presto_tpu/astro/spk.py`` for the PyTorch port, which
imports nothing from the JAX package.

The reference reaches DE405 through the external TEMPO process
(src/barycenter.c:134 "EPHEM DE405" + system() at :156); the rebuild's
analytic ephemeris (astro/ephem.py) is search-grade (~16,000 km worst,
see tests/test_bary_golden.py).  This module closes the timing-grade
gap the same way TEMPO does — with a real JPL ephemeris file the user
supplies (de405.bsp / de421.bsp / de440s.bsp...), read natively:

    ephem = SPKEphemeris("de405.bsp")
    pos, vel = ephem.earth_posvel(jd_tdb)      # AU, AU/day, ICRS

Format: NAIF DAF (Double-precision Array File) containers holding SPK
segments; planetary ephemerides use data types 2 (Chebyshev position,
velocity by differentiation) and 3 (Chebyshev position+velocity).
Layout follows the public NAIF SPK/DAF "Required Reading" documents.
No SPICE code involved; ~200 lines of struct parsing + a Chebyshev
evaluator.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

AU_KM = 1.4959787069098932e8              # IAU 2012 definition, km
DAY_S = 86400.0
J2000_JD = 2451545.0

# NAIF integer codes
SSB, SUN, EMB, EARTH, MOON = 0, 10, 3, 399, 301


@dataclass
class _Segment:
    target: int
    center: int
    frame: int
    data_type: int
    start_et: float
    end_et: float
    init: float
    intlen: float
    rsize: int
    n_records: int
    records: np.ndarray        # [n_records, rsize] float64


class SPK:
    """Parsed SPK kernel: segments indexed by (center, target)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        self._raw = data
        locidw = data[:8].decode("ascii", "replace")
        if not locidw.startswith("DAF/SPK"):
            raise ValueError(f"not an SPK kernel: LOCIDW={locidw!r}")
        locfmt = data[88:96].decode("ascii", "replace")
        if locfmt.startswith("LTL"):
            self._end = "<"
        elif locfmt.startswith("BIG"):
            self._end = ">"
        else:
            raise ValueError(f"unsupported DAF binary format {locfmt!r}")
        nd, ni = struct.unpack(self._end + "ii", data[8:16])
        if (nd, ni) != (2, 6):
            raise ValueError(f"not an SPK summary format: ND={nd} NI={ni}")
        fward, = struct.unpack(self._end + "i", data[76:80])
        # all segments per (center, target) pair — merged kernels (e.g.
        # de430+de431 splices) carry several per pair over different
        # time spans; evaluation selects by epoch
        self.segments: Dict[Tuple[int, int], list] = {}
        self._read_summaries(fward)

    # -- DAF plumbing --------------------------------------------------

    def _record(self, recno: int) -> bytes:
        """1-indexed 1024-byte physical record."""
        off = (recno - 1) * 1024
        return self._raw[off:off + 1024]

    def _doubles(self, addr0: int, n: int) -> np.ndarray:
        """Read n float64 starting at 1-indexed DAF address (in doubles)."""
        off = (addr0 - 1) * 8
        return np.frombuffer(self._raw, dtype=self._end + "f8",
                             count=n, offset=off)

    def _read_summaries(self, recno: int):
        while recno:
            rec = self._record(recno)
            nxt, _prev, nsum = struct.unpack(self._end + "ddd", rec[:24])
            for i in range(int(nsum)):
                s = rec[24 + i * 40: 24 + (i + 1) * 40]   # SS=5 doubles
                start_et, end_et = struct.unpack(self._end + "dd", s[:16])
                tgt, ctr, frame, dtype, a0, a1 = struct.unpack(
                    self._end + "6i", s[16:40])
                if dtype not in (2, 3):
                    continue            # only planetary Chebyshev types
                self._add_segment(start_et, end_et, tgt, ctr, frame,
                                  dtype, a0, a1)
            recno = int(nxt)

    def _add_segment(self, start_et, end_et, tgt, ctr, frame, dtype,
                     a0, a1):
        init, intlen, rsize, n = self._doubles(a1 - 3, 4)
        rsize, n = int(rsize), int(n)
        recs = self._doubles(a0, rsize * n).reshape(n, rsize)
        self.segments.setdefault((ctr, tgt), []).append(_Segment(
            target=tgt, center=ctr, frame=frame, data_type=dtype,
            start_et=start_et, end_et=end_et, init=init, intlen=intlen,
            rsize=rsize, n_records=n, records=recs))

    # -- evaluation ----------------------------------------------------

    def posvel(self, center: int, target: int, et) -> Tuple[np.ndarray,
                                                            np.ndarray]:
        """(position km, velocity km/s) of target w.r.t. center at
        ephemeris time(s) et (TDB seconds past J2000).  Chains through
        the barycenters when no direct segment exists (e.g. SSB->Earth
        = SSB->EMB + EMB->Earth)."""
        et = np.atleast_1d(np.asarray(et, np.float64))
        key = (center, target)
        if key in self.segments:
            return self._eval_list(self.segments[key], et)
        if (target, center) in self.segments:
            p, v = self._eval_list(self.segments[(target, center)], et)
            return -p, -v
        # one-level chaining via any common intermediate body
        for (c1, t1), _seg in self.segments.items():
            if c1 == center and (t1, target) in self.segments:
                p1, v1 = self._eval_list(self.segments[(c1, t1)], et)
                p2, v2 = self._eval_list(self.segments[(t1, target)], et)
                return p1 + p2, v1 + v2
        raise KeyError(f"no segment path {center}->{target}; have "
                       f"{sorted(self.segments)}")

    def _eval_list(self, segs: list, et: np.ndarray):
        """Evaluate choosing the covering segment per epoch; epochs no
        segment covers RAISE — a clipped evaluation would silently
        extrapolate the edge Chebyshev polynomial, corrupting exactly
        the timing-grade corrections this reader exists to provide."""
        if len(segs) == 1:
            return self._eval(segs[0], et)
        pos = np.empty(et.shape + (3,))
        vel = np.empty(et.shape + (3,))
        done = np.zeros(et.shape, dtype=bool)
        for seg in segs:
            # same 1 s edge slack as _eval so a boundary epoch behaves
            # identically whether the kernel is spliced or monolithic
            m = (~done) & (et >= seg.start_et - 1.0) \
                & (et <= seg.end_et + 1.0)
            if np.any(m):
                pos[m], vel[m] = self._eval(seg, et[m])
                done |= m
        if not np.all(done):
            bad = et[~done]
            raise ValueError(
                f"epoch(s) outside kernel coverage: et={bad[:3]}... "
                f"(spans {[(s.start_et, s.end_et) for s in segs]})")
        return pos, vel

    def _eval(self, seg: _Segment, et: np.ndarray):
        # tolerance: one second of slack at the span edges for TT/TDB
        # round-off; beyond that, clipping would silently extrapolate
        if np.any((et < seg.start_et - 1.0) | (et > seg.end_et + 1.0)):
            bad = et[(et < seg.start_et - 1.0) | (et > seg.end_et + 1.0)]
            raise ValueError(
                f"epoch(s) outside SPK segment coverage "
                f"[{seg.start_et}, {seg.end_et}] s past J2000 TDB: "
                f"et={bad[:3]}{'...' if bad.size > 3 else ''} — check "
                f"the kernel's time span and that epochs are TDB")
        i = np.clip(((et - seg.init) // seg.intlen).astype(np.int64),
                    0, seg.n_records - 1)
        recs = seg.records[i]                       # [n, rsize]
        mid, radius = recs[:, 0], recs[:, 1]
        tau = (et - mid) / radius                   # in [-1, 1]
        if seg.data_type == 2:
            ncoef = (seg.rsize - 2) // 3
            coef = recs[:, 2:].reshape(-1, 3, ncoef)
            pos = _cheby(coef, tau)
            vel = _cheby_deriv(coef, tau) / radius[:, None]
        else:                                       # type 3: pos+vel
            ncoef = (seg.rsize - 2) // 6
            coef = recs[:, 2:].reshape(-1, 6, ncoef)
            pos = _cheby(coef[:, :3], tau)
            vel = _cheby(coef[:, 3:], tau)
        return pos, vel


def _cheby_terms(tau: np.ndarray, n: int) -> np.ndarray:
    """T_k(tau) for k < n: [len(tau), n] via the recurrence."""
    T = np.empty(tau.shape + (n,))
    T[..., 0] = 1.0
    if n > 1:
        T[..., 1] = tau
    for k in range(2, n):
        T[..., k] = 2.0 * tau * T[..., k - 1] - T[..., k - 2]
    return T


def _cheby(coef: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """coef: [n, 3, ncoef]; tau: [n] -> [n, 3]."""
    T = _cheby_terms(tau, coef.shape[-1])
    return np.einsum("nck,nk->nc", coef, T)


def _cheby_deriv(coef: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """d/dtau of the Chebyshev sum, via U-polynomials:
    T_k'(tau) = k * U_{k-1}(tau)."""
    n = coef.shape[-1]
    U = np.empty(tau.shape + (n,))
    U[..., 0] = 1.0
    if n > 1:
        U[..., 1] = 2.0 * tau
    for k in range(2, n):
        U[..., k] = 2.0 * tau * U[..., k - 1] - U[..., k - 2]
    k = np.arange(n, dtype=np.float64)
    dT = np.zeros(tau.shape + (n,))
    dT[..., 1:] = U[..., :-1] * k[1:]
    return np.einsum("nck,nk->nc", coef, dT)


class SPKEphemeris:
    """astro/ephem.py-compatible ephemeris backed by an SPK kernel.

    Matches AnalyticEphemeris's interface: earth_posvel(jd_tdb) ->
    (AU, AU/day) and sun_pos(jd_tdb) -> AU, all ICRS/J2000 equatorial
    (planetary bsp kernels are ICRF frame 1)."""

    def __init__(self, path: str):
        self.spk = SPK(path)
        self.name = path

    @staticmethod
    def _et(jd_tdb):
        return (np.asarray(jd_tdb, np.float64) - J2000_JD) * DAY_S

    def earth_posvel(self, jd_tdb):
        et = self._et(jd_tdb)
        p, v = self.spk.posvel(SSB, EARTH, et)
        return p / AU_KM, v * (DAY_S / AU_KM)

    def sun_pos(self, jd_tdb):
        et = self._et(jd_tdb)
        p, _ = self.spk.posvel(SSB, SUN, et)
        return p / AU_KM
