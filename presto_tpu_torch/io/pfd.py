""".pfd (prepfold data) and .bestprof artifacts.

Host copy of ``presto_tpu/io/pfd.py`` for the PyTorch
port, which imports nothing from the JAX package.

Binary layout parity with the reference's writer (prepfold.c delayed
write) as documented by its pure-Python reader
(lib/python/prepfold.py:17-150): little-endian —
  12 x i32: numdms numperiods numpdots nsub npart proflen numchan
            pstep pdstep dmstep ndmfact npfact
  4 length-prefixed strings: filenm candnm telescope pgdev
  2 x 16-byte char: rastr decstr (must contain ':')
  9 x f64: dt startT endT tepoch bepoch avgvoverc lofreq chan_wid bestdm
  3 x (f32 pow, f32 pad, 3 x f64 p1 p2 p3): topo, bary, fold
     (NOTE: fold values are frequencies f, fd, fdd)
  7 x f64 orbit params (p e x w t pd wd)
  f64 arrays: dms[numdms] periods[numperiods] pdots[numpdots]
  f64 profs [npart][nsub][proflen]
  7 x f64 foldstats per (part, sub): numdata data_avg data_var numprof
     prof_avg prof_var redchi
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


def _wstr(f, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _rstr(f, path: str = "") -> str:
    from presto_tpu_torch.io.errors import PrestoIOError, read_exact
    n = struct.unpack("<i", read_exact(f, 4, path,
                                       "pfd string length"))[0]
    if n < 0 or n > 1 << 20:
        raise PrestoIOError("implausible pfd string length %d" % n,
                            path=path, offset=f.tell() - 4,
                            kind="bad-magic")
    return read_exact(f, n, path, "pfd string").decode()


@dataclass
class Pfd:
    """In-memory .pfd contents (field names follow the reference's
    Python pfd class for drop-in familiarity)."""
    numdms: int = 1
    numperiods: int = 1
    numpdots: int = 1
    nsub: int = 1
    npart: int = 1
    proflen: int = 64
    numchan: int = 1
    pstep: int = 1
    pdstep: int = 2
    dmstep: int = 1
    ndmfact: int = 2
    npfact: int = 1
    filenm: str = ""
    candnm: str = ""
    telescope: str = "Unknown"
    pgdev: str = ""
    rastr: str = "00:00:00.0000"
    decstr: str = "00:00:00.0000"
    dt: float = 0.0
    startT: float = 0.0
    endT: float = 1.0
    tepoch: float = 0.0
    bepoch: float = 0.0
    avgvoverc: float = 0.0
    lofreq: float = 0.0
    chan_wid: float = 0.0
    bestdm: float = 0.0
    topo_pow: float = 0.0
    topo_p1: float = 0.0
    topo_p2: float = 0.0
    topo_p3: float = 0.0
    bary_pow: float = 0.0
    bary_p1: float = 0.0
    bary_p2: float = 0.0
    bary_p3: float = 0.0
    fold_pow: float = 0.0
    fold_p1: float = 0.0     # frequencies!
    fold_p2: float = 0.0
    fold_p3: float = 0.0
    orb_p: float = 0.0
    orb_e: float = 0.0
    orb_x: float = 0.0
    orb_w: float = 0.0
    orb_t: float = 0.0
    orb_pd: float = 0.0
    orb_wd: float = 0.0
    dms: np.ndarray = field(default_factory=lambda: np.zeros(1))
    periods: np.ndarray = field(default_factory=lambda: np.zeros(1))
    pdots: np.ndarray = field(default_factory=lambda: np.zeros(1))
    profs: np.ndarray = field(
        default_factory=lambda: np.zeros((1, 1, 64)))
    stats: np.ndarray = field(
        default_factory=lambda: np.zeros((1, 1, 7)))


def pfd_subfreqs(p: Pfd) -> np.ndarray:
    """Subband center frequencies (MHz), ascending: lofreq is the
    CENTER of the lowest channel (infodata convention, makeinf.h)."""
    chan_per_sub = max(p.numchan // max(p.nsub, 1), 1)
    sub_bw = chan_per_sub * p.chan_wid
    lo_edge = p.lofreq - 0.5 * p.chan_wid
    return lo_edge + (np.arange(p.nsub) + 0.5) * sub_bw


def write_pfd(path: str, p: Pfd) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<5i", p.numdms, p.numperiods, p.numpdots,
                            p.nsub, p.npart))
        f.write(struct.pack("<7i", p.proflen, p.numchan, p.pstep,
                            p.pdstep, p.dmstep, p.ndmfact, p.npfact))
        for s in (p.filenm, p.candnm, p.telescope, p.pgdev):
            _wstr(f, s)
        for s in (p.rastr, p.decstr):
            b = s.encode()[:15]
            f.write(b + b"\0" * (16 - len(b)))
        f.write(struct.pack("<2d", p.dt, p.startT))
        f.write(struct.pack("<7d", p.endT, p.tepoch, p.bepoch,
                            p.avgvoverc, p.lofreq, p.chan_wid, p.bestdm))
        for pow_, p1, p2, p3 in ((p.topo_pow, p.topo_p1, p.topo_p2,
                                  p.topo_p3),
                                 (p.bary_pow, p.bary_p1, p.bary_p2,
                                  p.bary_p3),
                                 (p.fold_pow, p.fold_p1, p.fold_p2,
                                  p.fold_p3)):
            f.write(struct.pack("<2f", pow_, 0.0))
            f.write(struct.pack("<3d", p1, p2, p3))
        f.write(struct.pack("<7d", p.orb_p, p.orb_e, p.orb_x, p.orb_w,
                            p.orb_t, p.orb_pd, p.orb_wd))
        np.asarray(p.dms, "<f8").tofile(f)
        np.asarray(p.periods, "<f8").tofile(f)
        np.asarray(p.pdots, "<f8").tofile(f)
        np.ascontiguousarray(p.profs, "<f8").tofile(f)
        np.ascontiguousarray(p.stats, "<f8").tofile(f)


def read_pfd(path: str) -> Pfd:
    """Parse one .pfd.  Missing or truncated input raises the typed
    PrestoIOError (path + byte-offset context) instead of a bare
    FileNotFoundError / struct.error escape — a discovery-DAG timing
    node fed a corrupt fold fails terminal with a diagnosable event,
    not a stack trace into the struct module."""
    from presto_tpu_torch.io.errors import PrestoIOError, read_exact
    p = Pfd()
    try:
        f = open(path, "rb")
    except OSError as e:
        raise PrestoIOError("cannot open .pfd: %s" % e.strerror,
                            path=path, kind="missing") from None
    with f:
        (p.numdms, p.numperiods, p.numpdots, p.nsub,
         p.npart) = struct.unpack(
            "<5i", read_exact(f, 20, path, "pfd header"))
        (p.proflen, p.numchan, p.pstep, p.pdstep, p.dmstep, p.ndmfact,
         p.npfact) = struct.unpack(
            "<7i", read_exact(f, 28, path, "pfd header"))
        p.filenm, p.candnm = _rstr(f, path), _rstr(f, path)
        p.telescope, p.pgdev = _rstr(f, path), _rstr(f, path)
        p.rastr = read_exact(f, 16, path,
                             "pfd header").split(b"\0")[0].decode()
        p.decstr = read_exact(f, 16, path,
                              "pfd header").split(b"\0")[0].decode()
        p.dt, p.startT = struct.unpack(
            "<2d", read_exact(f, 16, path, "pfd header"))
        (p.endT, p.tepoch, p.bepoch, p.avgvoverc, p.lofreq, p.chan_wid,
         p.bestdm) = struct.unpack(
            "<7d", read_exact(f, 56, path, "pfd header"))
        for pre in ("topo", "bary", "fold"):
            pow_, _ = struct.unpack(
                "<2f", read_exact(f, 8, path, "pfd header"))
            p1, p2, p3 = struct.unpack(
                "<3d", read_exact(f, 24, path, "pfd header"))
            setattr(p, pre + "_pow", pow_)
            setattr(p, pre + "_p1", p1)
            setattr(p, pre + "_p2", p2)
            setattr(p, pre + "_p3", p3)
        (p.orb_p, p.orb_e, p.orb_x, p.orb_w, p.orb_t, p.orb_pd,
         p.orb_wd) = struct.unpack(
            "<7d", read_exact(f, 56, path, "pfd header"))

        def _farr(n, what):
            arr = np.frombuffer(
                read_exact(f, 8 * n, path, what), "<f8")
            return arr.copy()

        p.dms = _farr(p.numdms, "pfd dms")
        p.periods = _farr(p.numperiods, "pfd periods")
        p.pdots = _farr(p.numpdots, "pfd pdots")
        n = p.npart * p.nsub * p.proflen
        if n <= 0 or n > (1 << 28):
            raise PrestoIOError(
                "implausible pfd cube %d x %d x %d"
                % (p.npart, p.nsub, p.proflen), path=path,
                kind="bad-magic")
        p.profs = _farr(n, "pfd profile cube").reshape(
            p.npart, p.nsub, p.proflen)
        p.stats = _farr(p.npart * p.nsub * 7, "pfd foldstats").reshape(
            p.npart, p.nsub, 7)
    return p


def write_bestprof(path: str, p: Pfd, best_prof: np.ndarray,
                   best_p: float, best_pd: float, best_redchi: float,
                   perr: float = 0.0, pderr: float = 0.0,
                   datnm: str = "", candnm: str = "") -> None:
    """Text .bestprof (format of lib/python/bestprof.py's parser)."""
    N = float(p.stats[:, 0, 0].sum())
    data_avg = float(np.average(p.stats[:, :, 1]))
    data_std = float(np.sqrt(np.average(p.stats[:, :, 2])))
    prof_avg = float(best_prof.mean())
    prof_std = float(best_prof.std())
    with open(path, "w") as f:
        w = f.write
        w("# Input file       =  %s\n" % (datnm or p.filenm))
        w("# Candidate        =  %s\n" % (candnm or p.candnm or
                                          "PSR_CAND"))
        w("# Telescope        =  %s\n" % p.telescope)
        w("# Epoch_topo       =  %.15g\n" % p.tepoch)
        w("# Epoch_bary (MJD) =  %.15g\n" % p.bepoch)
        w("# T_sample         =  %g\n" % p.dt)
        w("# Data Folded      =  %d\n" % N)
        w("# Data Avg         =  %.6g\n" % data_avg)
        w("# Data StdDev      =  %.6g\n" % data_std)
        w("# Profile Bins     =  %d\n" % p.proflen)
        w("# Profile Avg      =  %.6g\n" % prof_avg)
        w("# Profile StdDev   =  %.6g\n" % prof_std)
        w("# Reduced chi-sqr  =  %.4f\n" % best_redchi)
        w("# Best DM          =  %.6f\n" % p.bestdm)
        w("# P_topo (ms)      =  %.12g +/- %.3g\n"
          % (best_p * 1000.0, perr * 1000.0))
        w("# P'_topo (s/s)    =  %.6g +/- %.3g\n" % (best_pd, pderr))
        w("######################################################\n")
        for i, v in enumerate(best_prof):
            w("%4d  %.7g\n" % (i, v))


def use_for_timing(p: Pfd) -> bool:
    """True when the fold can produce valid TOAs: the best (searched)
    solution must agree with the FOLD solution to within a 0.1-bin
    rotation over the observation, else prepfold's search moved the
    profile and TOAs from it are bogus (prepfold.py:325-346).
    """
    from presto_tpu_torch.utils.psr import p_to_f
    T = p.dt * float(p.stats[:, 0, 0].sum())
    # best-solution choice mirrors freq_offsets (prepfold.py:250-266):
    # barycentric fold (fold_pow == 1) compares against the bary
    # values; an un-searched topocentric fold (topo_p1 == 0) has zero
    # offsets by construction
    if p.fold_pow == 1.0:
        best = (p.bary_p1, p.bary_p2, p.bary_p3)
    elif p.topo_p1 == 0.0:
        return True
    else:
        best = (p.topo_p1, p.topo_p2, p.topo_p3)
    if not best[0]:
        return False
    f3 = p_to_f(*best)
    offs = np.abs(np.asarray(f3) -
                  np.asarray([p.fold_p1, p.fold_p2, p.fold_p3]))
    dphi = offs * np.asarray([T, T ** 2 / 2.0, T ** 3 / 6.0])
    return bool(dphi.max() <= 0.1 / p.proflen)
