"""Polycos: polynomial pulsar-phase predictors (TEMPO polyco.dat).

Host copy of ``presto_tpu/astro/polycos.py`` for the PyTorch port, which
imports nothing from the JAX package.

Parity targets:
  src/polycos.c — make_polycos (:44-190, shells out to 'tempo -z'),
    getpoly (:195-280, polyco.dat parser), phcalc (:282-320, phase +
    frequency evaluation at topocentric MJD);
  lib/python/polycos.py — polyco/polycos classes (rotation/phase/freq
    evaluation and span selection).

TPU-era redesign: **no TEMPO subprocess**.  Polycos are generated
directly from a .par file using the framework's own barycentering
(astro.bary) and binary-orbit (astro.binary) machinery: for each span
the exact topocentric->emission phase is evaluated on a sample grid
and least-squares fit with the standard TEMPO polynomial
  rotation(t) = RPHASE + DT*60*F0 + sum_k coeffs[k] * DT^k,
DT in minutes from TMID.  Absolute rotation counts are carried in
numpy longdouble (80-bit) so ~1e10 rotations keep sub-1e-6 phase
precision.  Files written are standard TEMPO polyco.dat format, so
reference tools (and prepfold -polycos here) interoperate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from presto_tpu_torch.io.parfile import Parfile
from presto_tpu_torch.astro.bary import barycenter

SECPERDAY = 86400.0
# observing-freq dispersion delay constant (dispersion.c:30-39)
DM_CONST = 1.0 / 0.000241


# TEMPO single-char site codes used in polyco.dat (polycos.c:91-140,
# lib/python/polycos.py telescope_to_id)
TELESCOPE_TO_SITE = {
    "GBT": "1", "Arecibo": "3", "VLA": "6", "Parkes": "7",
    "Jodrell": "8", "GB43m": "a", "GB 140FT": "a", "NRAO20": "a",
    "Nancay": "f", "Effelsberg": "g", "LOFAR": "t", "WSRT": "i",
    "GMRT": "r", "CHIME": "y", "MeerKAT": "m", "KAT-7": "k",
    "Geocenter": "0", "Barycenter": "@",
}
# single-char site code -> 2-letter TEMPO obs code for our bary layer
SITE_TO_OBSCODE = {
    "1": "GB", "3": "AO", "6": "VL", "7": "PK", "8": "JB", "a": "G1",
    "f": "NC", "g": "EF", "t": "LF", "i": "WT", "r": "GM", "y": "CH",
    "m": "MK", "k": "K7", "0": "EC", "@": "EC",
}


@dataclass
class Polyco:
    """One polyco block: phase polynomial valid for `dataspan` minutes
    around TMID (lib/python/polycos.py:58-131)."""
    psr: str
    tmid_i: int                 # integer MJD
    tmid_f: float               # fractional MJD
    dm: float
    doppler: float              # v/c (stored *1e4 in the file)
    log10rms: float
    rphase: float               # fractional reference phase at TMID
    f0: float                   # reference spin freq (Hz) at TMID
    obs: str                    # TEMPO site char
    dataspan: int               # minutes
    numcoeff: int
    obsfreq: float              # MHz (0 or 1e6+ => infinite freq)
    coeffs: np.ndarray = field(default_factory=lambda: np.zeros(12))
    binphase: Optional[float] = None
    date: str = ""
    utc: str = ""

    @property
    def tmid(self) -> float:
        return self.tmid_i + self.tmid_f

    def _dt_min(self, mjdi, mjdf):
        """minutes from TMID, split-precision (polycos.py:113)."""
        return (((np.asarray(mjdi) - self.tmid_i)
                 + (np.asarray(mjdf) - self.tmid_f)) * 1440.0)

    def rotation(self, mjdi, mjdf):
        """Absolute (fractional) rotation count at topocentric MJD
        (polycos.py:107-119; phcalc polycos.c:282-320)."""
        DT = self._dt_min(mjdi, mjdf)
        phase = np.polynomial.polynomial.polyval(DT, self.coeffs)
        return phase + self.rphase + DT * 60.0 * self.f0

    def phase(self, mjdi, mjdf):
        """Predicted pulse phase in [0,1)."""
        return self.rotation(mjdi, mjdf) % 1.0

    def freq(self, mjdi, mjdf):
        """Apparent topocentric spin frequency (Hz)
        (polycos.py:121-130)."""
        DT = self._dt_min(mjdi, mjdf)
        dcoef = np.polynomial.polynomial.polyder(self.coeffs)
        return self.f0 + np.polynomial.polynomial.polyval(DT, dcoef) / 60.0


class Polycos:
    """A set of polyco blocks for one pulsar, with span selection
    (lib/python/polycos.py:133-199)."""

    def __init__(self, blocks: Sequence[Polyco]):
        if not blocks:
            raise ValueError("no polyco blocks")
        self.blocks = list(blocks)
        self.psr = blocks[0].psr
        self.dataspan = blocks[0].dataspan
        self.tmids = np.array([b.tmid for b in blocks])
        self.validrange = 0.5 * self.dataspan / 1440.0

    def __len__(self):
        return len(self.blocks)

    def select(self, mjdi, mjdf) -> int:
        """Index of the block whose TMID is closest; warns outside the
        valid range (select_polyco polycos.py:156-164)."""
        t = mjdi + mjdf
        good = int(np.argmin(np.abs(self.tmids - t)))
        if abs(self.tmids[good] - t) > self.validrange:
            import sys
            sys.stderr.write("Cannot find a valid polyco at %f!\n" % t)
        return good

    def get_phase(self, mjdi, mjdf) -> float:
        return float(self.blocks[self.select(mjdi, mjdf)].phase(mjdi, mjdf))

    def get_rotation(self, mjdi, mjdf) -> float:
        return float(self.blocks[self.select(mjdi, mjdf)]
                     .rotation(mjdi, mjdf))

    def get_freq(self, mjdi, mjdf) -> float:
        return float(self.blocks[self.select(mjdi, mjdf)].freq(mjdi, mjdf))

    def get_phs_and_freq(self, mjdi, mjdf) -> Tuple[float, float]:
        """phcalc equivalent (polycos.c:282-320): (phase [0,1), freq)."""
        b = self.blocks[self.select(mjdi, mjdf)]
        return float(b.phase(mjdi, mjdf)), float(b.freq(mjdi, mjdf))


# ------------------------------------------------------------------ #
# polyco.dat I/O

def _parse_block(lines: List[str], k: int) -> Tuple[Optional[Polyco], int]:
    while k < len(lines) and not lines[k].strip():
        k += 1
    if k >= len(lines):
        return None, k
    sl = lines[k].split()
    psr, date, utc = sl[0], sl[1], sl[2]
    tmid_i = int(sl[3].split(".")[0])
    tmid_f = float("0." + sl[3].split(".")[1]) if "." in sl[3] else 0.0
    dm = float(sl[4])
    if len(sl) >= 7:
        doppler = float(sl[5]) * 1e-4
        log10rms = float(sl[6])
    else:
        # doppler/rms columns fused like '-0.123-7' (polycos.py:75-79)
        tail = sl[-1]
        rms = "-" + tail.split("-")[-1]
        doppler = float(tail[:tail.find(rms)]) * 1e-4
        log10rms = float(rms)
    sl = lines[k + 1].split()
    rphase = float(sl[0])
    f0 = float(sl[1])
    obs = sl[2]
    dataspan = int(sl[3])
    numcoeff = int(sl[4])
    obsfreq = float(sl[5])
    binphase = float(sl[6]) if len(sl) >= 7 else None
    coeffs = np.zeros(numcoeff)
    k += 2
    n = 0
    while n < numcoeff:
        for tok in lines[k].split():
            coeffs[n] = float(tok.replace("D", "E").replace("d", "e"))
            n += 1
            if n == numcoeff:
                break
        k += 1
    return Polyco(psr=psr, tmid_i=tmid_i, tmid_f=tmid_f, dm=dm,
                  doppler=doppler, log10rms=log10rms, rphase=rphase,
                  f0=f0, obs=obs, dataspan=dataspan, numcoeff=numcoeff,
                  obsfreq=obsfreq, coeffs=coeffs, binphase=binphase,
                  date=date, utc=utc), k


def read_polycos(path: str, psrname: Optional[str] = None) -> Polycos:
    """Parse a TEMPO polyco.dat (getpoly polycos.c:195-280)."""
    with open(path) as f:
        lines = f.readlines()
    blocks, k = [], 0
    while True:
        b, k = _parse_block(lines, k)
        if b is None:
            break
        if psrname is None or b.psr.lstrip("JB").startswith(
                psrname.lstrip("JB")[:4]):
            blocks.append(b)
    return Polycos(blocks)


def write_polycos(pcs: Polycos, path: str) -> None:
    """Write standard TEMPO polyco.dat format."""
    with open(path, "w") as f:
        for b in pcs.blocks:
            ti, tf = b.tmid_i, round(b.tmid_f * 1e11)
            if tf >= 10 ** 11:        # .99999... rounded up a day
                ti, tf = ti + 1, 0
            tmid = "%05d.%011d" % (ti, tf)
            f.write("%-10s %9s%11s%20s%21.6f%7.3f%7.3f\n"
                    % (b.psr[:10], b.date or "DD-MMM-YY",
                       b.utc or "000000.00", tmid, b.dm,
                       b.doppler * 1e4, b.log10rms))
            bin_str = ("%7.4f" % b.binphase) if b.binphase is not None \
                else ""
            f.write("%20.6f%18.12f%5s%5d%5d%10.3f%s\n"
                    % (b.rphase, b.f0, b.obs, b.dataspan, b.numcoeff,
                       b.obsfreq, bin_str))
            for i in range(0, b.numcoeff, 3):
                row = b.coeffs[i:i + 3]
                f.write("".join("%25.17E" % c for c in row)
                        .replace("E", "D") + "\n")


# ------------------------------------------------------------------ #
# TEMPO-free polyco generation

def make_polycos(par: Union[str, Parfile], mjd_start: float,
                 duration_min: float, telescope: str = "GBT",
                 obsfreq: float = 0.0, span_min: int = 60,
                 numcoeff: int = 12, ephem: str = "DEANALYTIC",
                 outfile: Optional[str] = None,
                 barytime: bool = False) -> Polycos:
    """Generate polycos covering [mjd_start, mjd_start+duration] by
    fitting the framework's own topo->bary->emission phase model.

    Replaces make_polycos' 'tempo -z' subprocess (polycos.c:44-190):
    same polyco.dat contract, but the phase model is astro.bary
    barycentering + astro.binary orbit demodulation + the .par spin
    polynomial.  obsfreq (MHz) folds the dispersion delay at the band
    center into the prediction (0 => infinite frequency).

    barytime=True: the input timestamps are ALREADY barycentric MJDs
    (e.g. folding a prepdata-barycentered .dat) — skip the topo->bary
    Roemer/Shapiro conversion entirely (doppler=0), keeping only the
    DM delay and binary demodulation.  Telescope 'Barycenter' ('@')
    implies this too.
    """
    if isinstance(par, str):
        par = Parfile(par)
    site = TELESCOPE_TO_SITE.get(telescope, telescope
                                 if len(telescope) == 1 else "0")
    obscode = SITE_TO_OBSCODE.get(site, "EC")
    if site == "@" or telescope == "Barycenter":
        barytime = True
    psrname = par.name.lstrip("JB") or "PSR"
    dm = getattr(par, "DM", 0.0)
    pepoch = getattr(par, "PEPOCH", mjd_start)
    f0 = getattr(par, "F0")
    f1 = getattr(par, "F1", 0.0)
    f2 = getattr(par, "F2", 0.0)
    ra = getattr(par, "RAJ", "00:00:00")
    dec = getattr(par, "DECJ", "00:00:00")
    binary = None
    if par.is_binary:
        from presto_tpu_torch.astro.binary import BinaryPsr
        binary = BinaryPsr(par)

    def emission_mjd(topo_mjd):
        """topo UTC MJD -> emission-frame MJD (bary - DM - orbit)."""
        if barytime:
            tb = np.atleast_1d(np.asarray(topo_mjd, dtype=np.float64))
        else:
            tb, _ = barycenter(topo_mjd, ra, dec, obs=obscode,
                               ephem=ephem)
            tb = np.atleast_1d(tb)
        if obsfreq > 0.0:
            tb = tb - dm * DM_CONST / (obsfreq * obsfreq) / SECPERDAY
        if binary is not None:
            tb = binary.demodulate_TOAs(tb)
        return tb

    def spin_phase(em_mjd):
        """Absolute rotation count since PEPOCH, longdouble."""
        dt = (np.asarray(em_mjd, dtype=np.longdouble)
              - np.longdouble(pepoch)) * np.longdouble(SECPERDAY)
        return (np.longdouble(f0) * dt
                + np.longdouble(0.5 * f1) * dt * dt
                + np.longdouble(f2 / 6.0) * dt * dt * dt)

    nspans = max(1, int(math.ceil(duration_min / span_min)))
    blocks = []
    for i in range(nspans):
        tmid = mjd_start + (i + 0.5) * span_min / 1440.0
        tmid_i = int(tmid)
        tmid_f = tmid - tmid_i
        # sample grid across the span (over-sampled 4x for the fit)
        npts = max(4 * numcoeff, 32)
        dts_min = np.linspace(-span_min / 2, span_min / 2, npts)
        topo = tmid + dts_min / 1440.0
        phs = spin_phase(emission_mjd(topo))
        phs_mid = spin_phase(emission_mjd(np.array([tmid])))[0]
        # apparent freq at tmid: d(phase)/dt via a short central diff
        eps_d = 1.0 / SECPERDAY
        p_lo = spin_phase(emission_mjd(np.array([tmid - eps_d])))[0]
        p_hi = spin_phase(emission_mjd(np.array([tmid + eps_d])))[0]
        f0_app = float((p_hi - p_lo) / 2.0)
        rphase = float(np.fmod(phs_mid, np.longdouble(1.0)))
        if rphase < 0:
            rphase += 1.0
        # residual after removing the linear TEMPO term, in float64
        resid = np.asarray(
            phs - phs_mid
            - np.longdouble(f0_app) * np.longdouble(60.0)
            * np.asarray(dts_min, dtype=np.longdouble),
            dtype=np.float64)
        coeffs = np.polynomial.polynomial.polyfit(dts_min, resid,
                                                  numcoeff - 1)
        fit = np.polynomial.polynomial.polyval(dts_min, coeffs)
        rms = float(np.sqrt(np.mean((resid - fit) ** 2)))
        log10rms = math.log10(max(rms, 1e-30))
        if barytime:
            voverc = 0.0
        else:
            _, voverc = barycenter(tmid, ra, dec, obs=obscode,
                                   ephem=ephem)
        binphase = None
        if binary is not None:
            ma, _, _ = binary.calc_anoms(tmid)
            binphase = float(ma[0] / (2 * np.pi))
        blocks.append(Polyco(
            psr=psrname, tmid_i=tmid_i, tmid_f=tmid_f, dm=dm,
            doppler=float(voverc), log10rms=log10rms, rphase=rphase,
            f0=f0_app, obs=site, dataspan=span_min, numcoeff=numcoeff,
            obsfreq=obsfreq, coeffs=coeffs, binphase=binphase))
    pcs = Polycos(blocks)
    if outfile:
        write_polycos(pcs, outfile)
    return pcs


def fit_fold_params(pcs: Polycos, mjd_start: float, T_sec: float,
                    npts: int = 128) -> Tuple[float, float, float, float]:
    """Fit topocentric (f, fd, fdd) for a constant-derivative fold over
    [mjd_start, mjd_start + T] from a polyco set.

    The reference's prepfold re-evaluates polyco phase block-by-block
    (prepfold.c:1347-1369); the folder here uses one cubic phase
    polynomial, so the polycos are collapsed to the best-fit
    (f, fd, fdd) at the start epoch.  Returns (f, fd, fdd, rms) where
    rms is the residual in rotations — callers should warn when it
    exceeds ~0.1/proflen (phase model too curvy for one polynomial).
    """
    ts = np.linspace(0.0, T_sec, npts)
    mjds = mjd_start + ts / SECPERDAY
    rot = np.array([pcs.get_rotation(int(m), m - int(m)) for m in mjds])
    rot = rot - rot[0]
    # guard against inter-block fractional-rphase jumps: integrate the
    # per-sample phase increments mod the expected f*dt.  The expected
    # step uses the LOCAL instantaneous frequency at each interval
    # midpoint (not the start-epoch f): for a binary, orbital Doppler
    # can drift f by more than 0.5 rotations per sample interval over
    # the start value, which would make a fixed-f re-wrap subtract
    # spurious integers from genuine phase steps
    mids = mjds[:-1] + 0.5 * np.diff(ts) / SECPERDAY
    f_mid = np.array([pcs.get_freq(int(m), m - int(m)) for m in mids])
    expect = f_mid * np.diff(ts)
    steps = np.diff(rot)
    steps = steps - np.round((steps - expect))   # re-wrap block joins
    rot = np.concatenate([[0.0], np.cumsum(steps)])
    c = np.polynomial.polynomial.polyfit(ts, rot, 3)
    resid = rot - np.polynomial.polynomial.polyval(ts, c)
    return (float(c[1]), float(2.0 * c[2]), float(6.0 * c[3]),
            float(np.sqrt(np.mean(resid ** 2))))
