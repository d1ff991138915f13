"""prepfold: fold a candidate from raw (.fil), time-series (.dat) or
event data, search (DM, p, pd), and write .pfd + .bestprof.

PyTorch counterpart of ``presto_tpu/apps/prepfold.py``, with its flags
(clig/prepfold_cmd.cli; src/prepfold.c): -p/-pd/-pdd | -f/-fd/-fdd |
-accelcand/-accelfile, -dm, -n (proflen), -npart, -nsub, the search
switches and steps, -start/-end, -events, the ephemeris folds (-par,
-timing, -polycos, -absphase, -barypolycos; polycos made by
astro/polycos on the port's barycentring, collapsed to one cubic phase
by fit_fold_params), -psr (utils/catalog's parameters at the epoch,
with the orbit of a binary) and -bin with -pb -x -e -To -w -wdot
(ops/orbit's Roemer delays fed to ops/fold.plan_fold).  Raw data are
dedispersed to nsub subbands at the fold DM on the device first
(prepfold.c:1267-1330), so the DM search shifts whole subbands like the
reference.  The fold and the trial search run on ``device``
(search/prepfold.py); the .pfd of a fold with no search is byte-equal
to the JAX package's.  -barypolycos is parsed and, as in the JAX
package, read by nothing.

Unless -noplot is given, the diagnostic plot is drawn to <outbase>.pfd.png
(plotting/pfdplot: its chi2 panels computed on ``device``, drawn with
matplotlib; -scaleparts, -allgrey, -fixchi and -justprofs choose how).
Without matplotlib such a run raises ImportError before any work.  A raw
fold (SIGPROC or PSRFITS,
apps/common.open_raw_args) streams through pipeline/fusion.feed_blocks
(the native decoder, the -mask substitution with padding values from
the .stats beside the mask, the clip and -ignorechan on the host, the
transpose on the device).

The stacked .dat candidate fold (fold_dat_cands) writes the bytes of
``prepfold -accelfile <acc>.cand -accelcand K -dm D -nosearch -noplot
-o <outbase> <datfile>`` run beside the artifacts.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass

import numpy as np

from presto_tpu_torch.astro.polycos import (fit_fold_params, make_polycos,
                                            read_polycos)
from presto_tpu_torch.apps.common import (add_common_flags, add_raw_flags,
                                          block_prep, load_timeseries,
                                          obs_metadata, open_raw_args,
                                          stream_blocklen)
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.io.parfile import Parfile
from presto_tpu_torch.io.pfd import Pfd, write_bestprof, write_pfd
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.ops.fold import shift_prof, subband_fold_shifts
from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.prepfold import (FoldConfig, fold_errors,
                                              fold_events,
                                              finish_fold_nosearch,
                                              fold_series_batch,
                                              fold_subband_series,
                                              search_fold)
from presto_tpu_torch.utils.catalog import psrepoch
from presto_tpu_torch.utils.psr import p_to_f


def build_parser():
    p = argparse.ArgumentParser(prog="prepfold")
    add_common_flags(p)
    p.add_argument("-p", type=float, default=0.0, help="Period (s)")
    p.add_argument("-pd", type=float, default=0.0)
    p.add_argument("-pdd", type=float, default=0.0)
    p.add_argument("-f", type=float, default=0.0, help="Frequency (Hz)")
    p.add_argument("-fd", type=float, default=0.0)
    p.add_argument("-fdd", type=float, default=0.0)
    p.add_argument("-pfact", type=float, default=1.0,
                   help="Factor to multiply the candidate p/p-dot by")
    p.add_argument("-ffact", type=float, default=1.0,
                   help="Factor to multiply the candidate f/f-dot by")
    p.add_argument("-phs", type=float, default=0.0,
                   help="Offset phase for the profile")
    p.add_argument("-accelcand", "-rzwcand", dest="accelcand",
                   type=int, default=0)
    p.add_argument("-accelfile", "-rzwfile", dest="accelfile",
                   type=str, default=None)
    p.add_argument("-psr", type=str, default=None,
                   help="Name of pulsar to fold (catalog lookup)")
    p.add_argument("-par", dest="parfile", type=str, default=None,
                   help="Fold using an ephemeris from a .par file "
                        "(polycos generated in-framework, no TEMPO)")
    p.add_argument("-timing", type=str, default=None,
                   help="TOA-generation mode: par file to fold with "
                        "(implies -nosearch, -fine, npart=60)")
    p.add_argument("-polycos", type=str, default=None,
                   help="Fold using an existing TEMPO polyco.dat")
    p.add_argument("-ephem", type=str, default="DE405",
                   help="Ephemeris for -par/-timing polycos: a DE name,"
                        " a .npz table, or a JPL .bsp SPK kernel")
    p.add_argument("-absphase", action="store_true",
                   help="Use the absolute phase of the polycos")
    p.add_argument("-barypolycos", action="store_true",
                   help="Force polycos for barycentered events/data")
    p.add_argument("-topo", action="store_true",
                   help="Fold topocentrically (the default here; kept "
                        "for parity)")
    p.add_argument("-dm", type=float, default=0.0)
    p.add_argument("-n", dest="proflen", type=int, default=0,
                   help="Profile bins (0 = auto)")
    p.add_argument("-npart", type=int, default=64)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-pstep", type=int, default=2)
    p.add_argument("-pdstep", type=int, default=4)
    p.add_argument("-dmstep", type=int, default=2)
    p.add_argument("-npfact", type=int, default=2)
    p.add_argument("-ndmfact", type=int, default=3)
    p.add_argument("-fine", action="store_true",
                   help="Finer p/pd gridding (well-known p, pd)")
    p.add_argument("-coarse", action="store_true",
                   help="Coarser p/pd gridding (unknown p, pd)")
    p.add_argument("-slow", action="store_true",
                   help="Useful flags for slow pulsars (implies -fine, "
                        "proflen=100)")
    p.add_argument("-searchpdd", action="store_true",
                   help="Search p-dotdots as well as p and p-dots")
    p.add_argument("-searchfdd", action="store_true",
                   help="Search f-dotdots (implies -searchpdd)")
    p.add_argument("-noplot", "-noxwin", action="store_true",
                   help="Skip the diagnostic plot")
    p.add_argument("-nosearch", action="store_true")
    p.add_argument("-nopsearch", action="store_true")
    p.add_argument("-nopdsearch", action="store_true")
    p.add_argument("-nodmsearch", action="store_true")
    p.add_argument("-scaleparts", action="store_true",
                   help="Scale the part profiles independently")
    p.add_argument("-allgrey", action="store_true",
                   help="Greyscale images instead of color")
    p.add_argument("-fixchi", action="store_true",
                   help="Scale so off-pulse reduced chi2 = 1")
    p.add_argument("-justprofs", action="store_true",
                   help="Only output the profile portions of the plot")
    p.add_argument("-start", dest="startT", type=float, default=0.0,
                   help="Folding start as a fraction of the obs")
    p.add_argument("-end", dest="endT", type=float, default=1.0,
                   help="Folding end as a fraction of the obs")
    p.add_argument("-mask", type=str, default=None)
    p.add_argument("-clip", type=float, default=6.0)
    p.add_argument("-zerodm", action="store_true")
    p.add_argument("-runavg", action="store_true",
                   help="Subtract each block's average as it is read")
    p.add_argument("-ignorechan", type=str, default=None)
    # binary-orbit folding (prepfold.c:878-903 orbit delays)
    p.add_argument("-bin", dest="binary", action="store_true",
                   help="Fold a binary pulsar (give all orbit params)")
    p.add_argument("-pb", type=float, default=0.0,
                   help="Orbital period (s)")
    p.add_argument("-x", dest="asinic", type=float, default=0.0,
                   help="Projected semi-major axis (lt-s)")
    p.add_argument("-e", dest="ecc", type=float, default=0.0)
    p.add_argument("-To", type=float, default=0.0,
                   help="Time of periastron passage (MJD)")
    p.add_argument("-w", dest="wdeg", type=float, default=0.0,
                   help="Longitude of periastron (deg)")
    p.add_argument("-wdot", type=float, default=0.0,
                   help="Rate of advance of periastron (deg/yr)")
    # event-list folding (prepfold.c:1012-1067)
    p.add_argument("-events", action="store_true",
                   help="Input is an event (TOA) file, not samples")
    p.add_argument("-days", action="store_true",
                   help="Events are days since the .inf EPOCH")
    p.add_argument("-mjds", action="store_true",
                   help="Events are MJDs")
    p.add_argument("-double", dest="evdouble", action="store_true",
                   help="Events are binary float64 (default ASCII)")
    p.add_argument("-offset", type=float, default=0.0,
                   help="Time offset to add to the first event")
    add_raw_flags(p, start_flags=False)
    p.add_argument("infile")
    return p


def apply_presets(args):
    """The -timing/-slow/-fine/-coarse flag interactions
    (prepfold.c:103-137)."""
    if args.timing:
        args.parfile = args.timing
        args.nosearch = True
        args.nopsearch = args.nopdsearch = args.nodmsearch = True
        if args.npart == 64:
            args.npart = 60
        args.fine = True
    if args.slow:
        args.fine = True
        if not args.proflen:
            args.proflen = 100
    if args.fine:
        args.ndmfact = 1
        args.dmstep = 1
        args.npfact = 1
        args.pstep = 1
        args.pdstep = 2
    elif args.coarse:
        args.npfact = 4
        args.pstep = 2 if args.pstep == 1 else 3
        args.pdstep = 4 if args.pdstep == 2 else 6
    if args.searchfdd:
        args.searchpdd = True
    return args


def accel_cand_fold_params(accelfile: str, candnum: int, T: float):
    """(f, fd, fdd) for one .cand candidate: accel candidates quote MEAN
    values over the observation (r = mean-f*T, z = mean-fdot*T^2,
    w = fdd*T^3), the fold's phase polynomial wants the t=0 Taylor
    coefficients."""
    from presto_tpu_torch.apps.accelsearch import read_cand_file
    cands = read_cand_file(accelfile)
    idx = max(int(candnum), 1) - 1
    if idx >= len(cands):
        raise ValueError("accelcand %d not in %s (%d candidates)"
                         % (candnum, accelfile, len(cands)))
    c = cands[idx]
    fdd = c.w / (T * T * T)
    fd0 = (c.z - c.w / 2.0) / (T * T)
    f0 = (c.r - c.z / 2.0 + c.w / 12.0) / T
    return f0, fd0, fdd


def _ephemeris_fold_params(args, T: float, obs: dict):
    """(f, fd, fdd) at the fold start from a .par (-par/-timing: polycos
    made here, no TEMPO) or a TEMPO polyco.dat (-polycos); -absphase
    keeps the polycos for _apply_absphase."""
    mjd0 = obs.get("mjd", 0.0)
    if args.polycos:
        pcs = read_polycos(args.polycos)
        if not args.dm and pcs.blocks:
            args.dm = pcs.blocks[0].dm
    else:
        par = Parfile(args.parfile)
        dur_min = T / 60.0 + 2.0
        # barycentred .dat input: the timestamps are already bary MJDs,
        # so the polycos are made in the bary frame (no double Doppler)
        pcs = make_polycos(par, mjd0 - 1.0 / 1440.0, dur_min,
                           telescope=obs.get("telescope", "GBT"),
                           obsfreq=obs.get("obsfreq", 0.0),
                           ephem=args.ephem,
                           barytime=obs.get("bary", False))
        if not args.dm:
            args.dm = getattr(par, "DM", 0.0)
    f, fd, fdd, rms = fit_fold_params(pcs, mjd0, T)
    if rms > 0.01:
        print("prepfold: WARNING polyco->polynomial fit rms = "
              "%.2g rotations (obs too long for one cubic?)" % rms)
    if args.absphase:
        # pin profile bin 0 to the ephemeris' absolute phase 0, resolved
        # at the fold's actual start epoch (_apply_absphase: -start
        # moves it past the file start)
        args._abs_pcs = pcs
    print("prepfold: ephemeris fold  f=%.12g Hz  fd=%.4g  fdd=%.4g"
          % (f, fd, fdd))
    return f, fd, fdd


def _catalog_fold_params(args, obs: dict):
    """(f, fd, fdd) of catalog pulsar -psr at the observation epoch; a
    binary's orbit switches -bin on with the catalog's elements."""
    epoch = obs.get("mjd", 0.0)
    if not epoch or epoch <= 0:      # .inf convention: -1 unknown
        print("prepfold -psr: WARNING no valid epoch in the input "
              "metadata; extrapolating catalog parameters to MJD 51000 "
              "(orbital phase of binaries will be wrong)")
        epoch = 51000.0
    try:
        # spin advanced by its derivatives, orb.p in SECONDS, orb.t in
        # seconds since the last periastron (get_psr_at_epoch)
        pp = psrepoch(args.psr, epoch)
    except (KeyError, ValueError):
        raise SystemExit("prepfold: pulsar %r not in catalog" % args.psr)
    if not args.dm:
        args.dm = pp.dm or 0.0
    if pp.orb is not None and pp.orb.p and not args.binary:
        args.binary = True
        args.pb = pp.orb.p
        args.asinic = pp.orb.x
        args.ecc = pp.orb.e
        args.wdeg = pp.orb.w
        args.To = epoch - pp.orb.t / 86400.0
    if pp.f:
        return pp.f, pp.fd, pp.fdd
    return p_to_f(pp.p, pp.pd, pp.pdd or 0.0)


def _fold_params(args, T: float, obs=None):
    """Resolve (f, fd, fdd) from an ephemeris (-par/-timing/-polycos),
    an accelsearch .cand file, the catalog (-psr) or the flags."""
    obs = obs or {}
    if args.parfile or args.polycos:
        return _ephemeris_fold_params(args, T, obs)
    if args.accelfile:
        try:
            return accel_cand_fold_params(args.accelfile, args.accelcand, T)
        except ValueError:
            raise SystemExit("accelcand %d not in %s"
                             % (args.accelcand, args.accelfile))
    if args.psr:
        return _catalog_fold_params(args, obs)
    if args.f > 0:
        return args.f, args.fd, args.fdd
    if args.p > 0:
        return p_to_f(args.p, args.pd, args.pdd)
    raise SystemExit("prepfold: give -p, -f, -psr, or "
                     "-accelfile/-accelcand")


def _auto_proflen(p_sec: float, dt: float) -> int:
    """Reference heuristic: ~p/dt bins, a power of two in [16, 256]
    (prepfold.c proflen selection)."""
    raw = p_sec / dt
    n = 16
    while n < raw / 2 and n < 256:
        n *= 2
    return n


def _apply_absphase(args, tepoch: float) -> None:
    """Fold-time half of -absphase: offset the profile by the polyco
    rotation fraction at the fold start epoch (which -start moves past
    the file start), pinning bin 0 to ephemeris phase 0."""
    pcs = getattr(args, "_abs_pcs", None)
    if pcs is None:
        return
    rot0 = pcs.get_rotation(int(tepoch), tepoch - int(tepoch))
    args.phs = (args.phs + rot0) % 1.0
    args._abs_pcs = None       # applied once
    print("prepfold: -absphase offset = %.6f rotations" % (rot0 % 1.0))


def _orbit_model(args, T, tepoch):
    """(delays, delaytimes) from the -bin orbit parameters: Roemer
    delays sampled across the fold span (the dorbint table,
    prepfold.c:878-903), with the secular periastron advance; (None,
    None) without -bin."""
    if not args.binary:
        return None, None
    if not (args.pb > 0 and args.asinic > 0):
        raise SystemExit("prepfold -bin: -pb and -x are required")
    t_since_peri = (tepoch - args.To) * 86400.0 if args.To else 0.0
    w = args.wdeg
    if args.wdot:
        w = w + args.wdot * ((tepoch - args.To) / 365.25)
    orb = OrbitParams(p=args.pb, e=args.ecc, x=args.asinic, w=w,
                      t=t_since_peri, wd=args.wdot)
    delaytimes = np.linspace(0.0, T, 2049)
    delays = np.asarray(orbit_delays(delaytimes, orb), np.float64)
    return delays, delaytimes


def _make_cfg(args, proflen, nsub, search_dm):
    return FoldConfig(proflen=proflen, npart=args.npart, nsub=nsub,
                      pstep=args.pstep, pdstep=args.pdstep,
                      dmstep=args.dmstep,
                      npfact=args.npfact, ndmfact=args.ndmfact,
                      search_p=not (args.nosearch or args.nopsearch),
                      search_pd=not (args.nosearch or args.nopdsearch),
                      search_dm=search_dm,
                      search_pdd=args.searchpdd)


def _slice_fractions(args, N):
    lo = int(max(args.startT, 0.0) * N)
    hi = int(min(args.endT, 1.0) * N)
    return lo, max(hi, lo + 1)


def fold_events_file(args, f, fd, fdd):
    """-events mode: the infile is a TOA/event list (host histogram)."""
    base = os.path.splitext(args.infile)[0]
    try:
        info = read_inf(base)
        mjd0 = info.mjd
        candnm = info.object or "PSR_CAND"
    except Exception:
        info, mjd0, candnm = None, 0.0, "PSR_CAND"
    if args.evdouble:
        ev = np.fromfile(args.infile, np.float64)
    else:
        ev = np.loadtxt(args.infile, usecols=(0,), ndmin=1)
    if ev.size == 0:
        raise SystemExit("prepfold -events: no events in %s"
                         % args.infile)
    ev = np.sort(ev)
    # read_events semantics (prepfold_utils.c:289-306): -offset is in
    # the INPUT units and defaults to -first_event for non-MJD input;
    # an explicit "-offset 0" also re-zeroes, as in the reference
    off = float(args.offset)
    if off == 0.0 and not args.mjds:
        off = -float(ev[0])
    if args.mjds:
        ev = ev + off
        ev = (ev - (mjd0 or float(ev.min()))) * 86400.0
    elif args.days:
        ev = (ev + off) * 86400.0
    else:
        ev = ev + off
    # -start/-end are fractions of the .inf duration when known (else
    # the event span); T = last kept event (prepfold_utils.c:308-338)
    Ttot = (float(info.N * info.dt)
            if info is not None and info.N and info.dt
            else (float(ev.max()) or 1.0) + 1e-8)
    lo, hi = args.startT * Ttot, args.endT * Ttot
    ev = ev[(ev >= lo) & (ev < hi)]
    if ev.size == 0:
        raise SystemExit("prepfold -events: -start/-end window "
                         "contains no events")
    T = (float(ev.max()) or 1.0) + 1e-8
    _apply_absphase(args, mjd0)
    proflen = args.proflen or _auto_proflen(1.0 / f, T / 1e6)
    cfg = _make_cfg(args, proflen, 1, search_dm=False)
    delays, delaytimes = _orbit_model(args, T, mjd0)
    res = fold_events(ev, f, fd, fdd, cfg, fold_dm=args.dm,
                      tepoch=mjd0, phs0=args.phs, T=T,
                      delays=delays, delaytimes=delaytimes)
    res.numchan = 1
    return res, cfg, candnm


def fold_dat(args, f, fd, fdd, device):
    data, info = load_timeseries(args.infile)
    dt = info.dt
    lo, hi = _slice_fractions(args, data.size)
    data = data[lo:hi]
    tepoch = info.mjd + lo * dt / 86400.0
    _apply_absphase(args, tepoch)
    proflen = args.proflen or _auto_proflen(1.0 / f, dt)
    cfg = _make_cfg(args, proflen, 1, search_dm=False)
    delays, delaytimes = _orbit_model(args, data.size * dt, tepoch)
    res = fold_subband_series(data, dt, f, fd, fdd, cfg,
                              fold_dm=info.dm, tepoch=tepoch,
                              phs0=args.phs, delays=delays,
                              delaytimes=delaytimes, device=device)
    res.numchan = 1
    return res, cfg, info.object or "PSR_CAND"


def fold_raw(args, f, fd, fdd, device):
    """Dedisperse the filterbank to nsub subbands at the fold DM on the
    device (full per-channel alignment, so the DM search models only
    the residual), then fold the subbands."""
    fb = open_raw_args([args.infile], args)
    hdr = fb.header
    nchan, dt = hdr.nchans, hdr.tsamp
    nsub = min(args.nsub, nchan)
    while nchan % nsub:        # need equal channels per subband
        nsub -= 1
    if nsub != args.nsub:
        print("prepfold: adjusted -nsub %d -> %d (must divide %d "
              "channels)" % (args.nsub, nsub, nchan))
    chan_del = dd.dedisp_delays(nchan, args.dm, hdr.lofreq,
                                abs(hdr.foff))
    chan_bins = dd.delays_to_bins(chan_del - chan_del.min(), dt)
    maxd = int(chan_bins.max())
    blocklen = stream_blocklen(nchan, maxd, nspec=int(hdr.N))
    series = fusion.stream_subbands(fb, block_prep(args, nchan, dt),
                                    chan_bins, nsub, blocklen, device)
    lo, hi = _slice_fractions(args, series.shape[1])
    series = series[:, lo:hi]
    tepoch = hdr.tstart + lo * dt / 86400.0
    _apply_absphase(args, tepoch)

    proflen = args.proflen or _auto_proflen(1.0 / f, dt)
    cfg = _make_cfg(args, proflen, nsub,
                    search_dm=not (args.nosearch or args.nodmsearch))
    chanpersub = nchan // nsub
    subfreqs = (hdr.lofreq + (np.arange(nsub) + 0.5) * chanpersub
                * abs(hdr.foff) - 0.5 * abs(hdr.foff))
    delays, delaytimes = _orbit_model(args, series.shape[1] * dt,
                                      tepoch)
    res = fold_subband_series(series, dt, f, fd, fdd, cfg,
                              fold_dm=args.dm, subfreqs=subfreqs,
                              tepoch=tepoch, phs0=args.phs,
                              delays=delays, delaytimes=delaytimes,
                              device=device)
    res.lofreq = hdr.lofreq
    res.chan_wid = abs(hdr.foff)
    res.numchan = nchan
    fb.close()
    return res, cfg, hdr.source_name or "PSR_CAND"


def _pfd(res, cfg, filenm, candnm, telescope, pgdev) -> Pfd:
    return Pfd(
        numdms=len(res.dms), numperiods=len(res.periods),
        numpdots=len(res.pdots), nsub=res.nsub, npart=res.npart,
        proflen=res.proflen, numchan=res.numchan, pstep=cfg.pstep,
        pdstep=cfg.pdstep, dmstep=cfg.dmstep, ndmfact=cfg.ndmfact,
        npfact=cfg.npfact, filenm=filenm, candnm=candnm,
        telescope=telescope or "Unknown", pgdev=pgdev,
        dt=res.dt, startT=0.0, endT=1.0, tepoch=res.tepoch,
        lofreq=res.lofreq, chan_wid=res.chan_wid, bestdm=res.best_dm,
        topo_p1=res.best_p, topo_p2=res.best_pd,
        fold_p1=res.fold_f, fold_p2=res.fold_fd, fold_p3=res.fold_fdd,
        dms=res.dms, periods=res.periods, pdots=res.pdots,
        profs=res.cube, stats=res.stats)


def _errors(res, device):
    """fold_errors, or (0, 0) where the fit is degenerate (a singular
    normal matrix, as the JAX package reports it)."""
    try:
        return fold_errors(res, device)
    except (np.linalg.LinAlgError, ValueError, ZeroDivisionError):
        return 0.0, 0.0


def run(args, device="cuda"):
    """Fold ``args.infile`` on ``device`` and write <outbase>.pfd and
    .pfd.bestprof (and, unless -noplot, .pfd.png); returns the
    FoldResult."""
    device = resolve_device(device)
    if not args.noplot:     # a run that draws needs matplotlib: raise now
        from presto_tpu_torch.plotting import pyplot
        pyplot("prepfold's diagnostic plot (-noplot skips it)")
    apply_presets(args)
    if args.absphase and not (args.polycos or args.parfile):
        raise SystemExit("prepfold: -absphase requires -polycos or "
                         "-par/-timing (the reference errors too)")
    is_dat = args.infile.endswith(".dat") or args.events
    # T turns an accelcand's (r, z) into (f, fd): read N*dt cheaply; the
    # epoch, site and frequency feed the ephemeris and catalog folds
    if is_dat:
        try:
            info = read_inf(os.path.splitext(args.infile)[0])
            T = info.N * info.dt
            obs = {"mjd": info.mjd, "telescope": info.telescope,
                   "bary": bool(info.bary),
                   "obsfreq": (0.0 if info.bary
                               else info.freq + 0.5 * info.freqband)}
        except Exception:
            if not args.events:
                raise
            T, obs = 1.0, {}
    else:
        fb0 = open_raw_args([args.infile], args)
        hdr0 = fb0.header
        T = hdr0.N * hdr0.tsamp
        tel, _, _ = obs_metadata(fb0)
        obs = {"mjd": hdr0.tstart, "telescope": tel,
               "obsfreq": hdr0.lofreq + 0.5 * abs(hdr0.foff)
               * hdr0.nchans}
        fb0.close()
    telescope = obs.get("telescope")
    f, fd, fdd = _fold_params(args, T, obs)
    # -pfact/-ffact are reciprocal, not independent: pfact beats ffact,
    # and all of f/fd/fdd scale by ffact (prepfold.c:845-861)
    if args.pfact == 0.0 or args.ffact == 0.0:
        raise SystemExit("prepfold: -pfact/-ffact cannot be 0")
    ffact = (1.0 / args.pfact if args.pfact != 1.0 else args.ffact)
    if ffact != 1.0:
        f, fd, fdd = f * ffact, fd * ffact, fdd * ffact

    if args.events:
        res, cfg, candnm = fold_events_file(args, f, fd, fdd)
    elif is_dat:
        res, cfg, candnm = fold_dat(args, f, fd, fdd, device)
    else:
        res, cfg, candnm = fold_raw(args, f, fd, fdd, device)

    res = search_fold(res, cfg, device)
    perr, pderr = _errors(res, device)

    outbase = args.outfile or os.path.splitext(args.infile)[0]
    pfdnm = outbase + ".pfd"
    # re-align the stored cube at the search-optimized DM so a .pfd's
    # bestdm is always the DM its profile cube is aligned at (what
    # get_TOAs' subband realignment assumes)
    if (res.nsub > 1 and res.subfreqs is not None
            and res.best_dm != res.fold_dm):
        shifts = subband_fold_shifts(
            res.subfreqs, res.best_dm, res.fold_dm, res.fold_f,
            res.proflen,
            ref_freq=res.lofreq + (res.numchan - 1) * res.chan_wid)
        for j in range(res.nsub):
            for i in range(res.npart):
                res.cube[i, j] = shift_prof(res.cube[i, j], shifts[j])
    pfd = _pfd(res, cfg, args.infile, candnm, telescope,
               pfdnm + ".ps/CPS")
    write_pfd(pfdnm, pfd)
    write_bestprof(pfdnm + ".bestprof", pfd, res.best_prof,
                   res.best_p, res.best_pd, res.best_redchi,
                   perr, pderr, datnm=args.infile, candnm=candnm)
    print("prepfold: folded %s  best p=%.9g s  pd=%.3g  DM=%.3f  "
          "redchi=%.2f -> %s" % (args.infile, res.best_p, res.best_pd,
                                 res.best_dm, res.best_redchi, pfdnm))
    if not args.noplot:
        from presto_tpu_torch.plotting import plot_pfd
        from presto_tpu_torch.plotting.pfdplot import PlotFlags
        flags = PlotFlags(scaleparts=args.scaleparts,
                          allgrey=args.allgrey,
                          justprofs=args.justprofs,
                          fixchi=args.fixchi)
        plot_pfd(pfd, pfdnm + ".png", best_prof=res.best_prof,
                 flags=flags, device=device)
        print("prepfold: diagnostic plot -> %s.png" % pfdnm)
    return res


# ----------------------------------------------------------------------
# Stacked .dat candidate folding
# ----------------------------------------------------------------------

@dataclass
class DatFoldSpec:
    """Fold accelsearch candidate ``candnum`` of ``accelfile`` (the
    binary .cand companion) from the dedispersed series ``datfile``,
    writing ``outbase``.pfd/.bestprof."""
    datfile: str
    accelfile: str
    candnum: int
    outbase: str
    dm: float = 0.0         # CLI -dm parity; .dat folds use the .inf DM


def fold_stack_key(N: int, dt: float, proflen: int,
                   npart: int = 64, subdiv: int = 1) -> str:
    """The fold stack signature: two folds share one stacked drizzle
    only when series length, sample time, profile bins,
    sub-integrations and the drizzle subdivision all match."""
    return "fold:%d:%r:%d:%d:%d" % (int(N), float(dt), int(proflen),
                                    int(npart), int(subdiv))


def fold_geometry(datfile: str, f: float, fd: float = 0.0,
                  npart: int = 64):
    """(N, dt, proflen, subdiv) a fold of `datfile` at frequency `f`
    will use, from the .inf alone (no data read)."""
    info = read_inf(datfile[:-4] if datfile.endswith(".dat")
                    else datfile)
    N, dt = int(info.N), float(info.dt)
    proflen = _auto_proflen(1.0 / f, dt)
    fmax = max(abs(f), abs(f + fd * N * dt))     # plan_fold's rule
    subdiv = max(1, int(np.ceil(fmax * dt * proflen)))
    return N, dt, proflen, subdiv


def fold_dat_cands(specs, device="cuda", obs=None):
    """Fold accelsearch candidates from .dat series on ``device``, single
    or stacked: same-geometry items (fold_stack_key) share one drizzle
    and one profile-total.  Each .pfd/.bestprof is byte-identical to the
    CLI's (see the module docstring); the labels in the artifacts
    (filenm, pgdev, datnm) are basenames.  The folds' dispatches are
    booked on ``obs`` (obs/devtel: ``fold``/``fold_batch``/
    ``fold_total``), as the JAX package books them.  Returns one result
    dict per spec (pfd path, best p/pd/redchi, stack size)."""
    device = resolve_device(device)
    prepped = []
    for spec in specs:
        data, info = load_timeseries(spec.datfile)
        T = info.N * info.dt
        f0, fd0, fdd = accel_cand_fold_params(spec.accelfile,
                                              spec.candnum, T)
        proflen = _auto_proflen(1.0 / f0, info.dt)
        cfg = FoldConfig(proflen=proflen, npart=64, nsub=1,
                         pstep=2, pdstep=4, dmstep=2, npfact=2,
                         ndmfact=3, search_p=False, search_pd=False,
                         search_dm=False)
        fmax = max(abs(f0), abs(f0 + fd0 * data.size * info.dt))
        subdiv = max(1, int(np.ceil(fmax * info.dt * proflen)))
        key = fold_stack_key(data.size, info.dt, proflen,
                             cfg.npart, subdiv)
        prepped.append({"spec": spec, "data": data, "info": info,
                        "f": f0, "fd": fd0, "fdd": fdd, "cfg": cfg,
                        "key": key})

    groups = {}
    for ent in prepped:
        groups.setdefault(ent["key"], []).append(ent)
    for ents in groups.values():
        items = [(e["data"], e["info"].dt, e["f"], e["fd"], e["fdd"],
                  e["cfg"], e["info"].dm, e["info"].mjd)
                 for e in ents]
        results = fold_series_batch(items, device=device, obs=obs)
        finish_fold_nosearch(results, device=device, obs=obs)
        for e, res in zip(ents, results):
            res.numchan = 1
            e["res"] = res

    out = []
    for ent in prepped:
        spec, res, cfg = ent["spec"], ent["res"], ent["cfg"]
        info = ent["info"]
        candnm = info.object or "PSR_CAND"
        perr, pderr = _errors(res, device)
        pfdnm = spec.outbase + ".pfd"
        datnm = os.path.basename(spec.datfile)
        pfd = _pfd(res, cfg, datnm, candnm, info.telescope,
                   os.path.basename(spec.outbase) + ".pfd.ps/CPS")
        write_pfd(pfdnm, pfd)
        write_bestprof(pfdnm + ".bestprof", pfd, res.best_prof,
                       res.best_p, res.best_pd, res.best_redchi,
                       perr, pderr, datnm=datnm, candnm=candnm)
        out.append({"pfd": pfdnm, "bestprof": pfdnm + ".bestprof",
                    "best_p": res.best_p, "best_pd": res.best_pd,
                    "best_redchi": res.best_redchi,
                    "stacked": len(groups[ent["key"]])})
    return out


def main(argv=None, device="cuda") -> int:
    from presto_tpu_torch.utils.timing import app_timer
    args = build_parser().parse_args(argv)
    with app_timer("prepfold"):
        run(args, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
