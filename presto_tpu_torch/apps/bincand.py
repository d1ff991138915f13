"""bincand: refine a phase-modulation binary candidate against the
full FFT (src/bincand.c: grid-optimize (P_orb, x, T_peri) with
gen_bin_response templates around a trial orbit).

PyTorch counterpart of ``presto_tpu/apps/bincand.py``, with its flags
and trial sources (-candfile, -psr, -mak, then the explicit orbit); each
round's correlation runs on ``device`` (search/bincand).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.ops.orbit import OrbitParams
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.search.bincand import optimize_bincand


def build_parser():
    p = argparse.ArgumentParser(prog="bincand")
    p.add_argument("-ppsr", type=float, default=0.0,
                   help="Trial pulsar period, s")
    p.add_argument("-plo", type=float, default=0.0,
                   help="The low pulsar period to check (s)")
    p.add_argument("-phi", type=float, default=0.0,
                   help="The high pulsar period to check (s)")
    p.add_argument("-rlo", type=float, default=0.0,
                   help="The low Fourier frequency bin to check")
    p.add_argument("-rhi", type=float, default=0.0,
                   help="The high Fourier frequency bin to check")
    p.add_argument("-porb", type=float, default=0.0,
                   help="Trial orbital period, s")
    p.add_argument("-x", "-asinic", dest="x", type=float, default=0.0,
                   help="Trial a sin(i)/c, lt-s")
    p.add_argument("-e", type=float, default=0.0)
    p.add_argument("-w", type=float, default=0.0)
    p.add_argument("-wdot", type=float, default=0.0,
                   help="Periastron advance (deg/yr); applied to w at "
                        "the obs epoch")
    p.add_argument("-t", type=float, default=0.0,
                   help="Trial time since periastron, s")
    p.add_argument("-To", type=float, default=0.0,
                   help="Time of periastron passage (MJD; converted "
                        "to -t using the .inf epoch)")
    p.add_argument("-pb", dest="porb_alias", type=float, default=0.0,
                   help="Alias for -porb (the -usr parameter set)")
    p.add_argument("-usr", action="store_true",
                   help="Orbit given explicitly via -pb/-x/-e/-To/-w")
    p.add_argument("-psr", type=str, default=None,
                   help="Name of a catalog pulsar to check")
    p.add_argument("-candfile", type=str, default=None,
                   help="search_bin candidate file (.cand)")
    p.add_argument("-candnum", type=int, default=1,
                   help="Candidate number in -candfile to optimize")
    p.add_argument("-mak", "-makefile", dest="makfile",
                   action="store_true",
                   help="Read optimization parameters from infile.mak")
    p.add_argument("-nsteps", type=int, default=3)
    p.add_argument("-rounds", type=int, default=2)
    p.add_argument("fftfile")
    return p


def _trial_from_args(args, base, info):
    """Resolve (ppsr, OrbitParams) from the various candidate
    sources, in the reference's precedence: -candfile, -psr, -mak,
    explicit (-usr / the plain flags)."""
    if args.porb_alias and not args.porb:
        args.porb = args.porb_alias
    if args.candfile:
        from presto_tpu_torch.search.phasemod import read_bincands
        cands = read_bincands(args.candfile)
        idx = max(args.candnum, 1) - 1
        if idx >= len(cands):
            raise SystemExit("bincand: candidate %d not in %s"
                             % (args.candnum, args.candfile))
        c = cands[idx]
        ppsr = args.ppsr or c.psr_p
        porb = args.porb or c.orb_p
        # a rawbincand does not record a*sin(i)/c (presto.h:221-232);
        # seed at 2 pulsar periods of light travel (phase-modulation
        # index ~4pi — mid-range for a detectable sideband comb) and
        # let the optimizer refine; give -x to seed explicitly
        x = args.x or max(2.0 * ppsr, 1e-3)
        return ppsr, OrbitParams(p=porb, x=x, e=args.e, w=args.w,
                                 t=args.t)
    if args.psr:
        from presto_tpu_torch.utils.catalog import psrepoch
        epoch = (info.mjd if info is not None else 0.0)
        if not epoch or epoch <= 0:      # .inf convention: -1 unknown
            print("bincand -psr: WARNING no valid epoch in the .inf; "
                  "extrapolating catalog parameters to MJD 51000 "
                  "(orbital phase will be wrong)")
            epoch = 51000.0
        try:
            # advanced to the obs epoch: orb.p in SECONDS, orb.t in
            # seconds since periastron — the optimizer's units
            pp = psrepoch(args.psr, epoch)
        except KeyError:
            raise SystemExit("bincand: %r not in catalog" % args.psr)
        if pp.orb is None or not pp.orb.p:
            raise SystemExit("bincand: %r not a catalog binary"
                             % args.psr)
        return (args.ppsr or pp.p), pp.orb
    if args.makfile:
        from presto_tpu_torch.io.makfile import read_mak
        mk = read_mak(base + ".mak")
        if not mk.orb_p:
            raise SystemExit("bincand: no orbit in %s.mak" % base)
        orb = OrbitParams(p=mk.orb_p, x=mk.orb_x, e=mk.orb_e,
                          w=mk.orb_w, t=getattr(mk, "orb_t", 0.0))
        return (args.ppsr or 1.0 / mk.f), orb
    ppsr = args.ppsr
    if not ppsr and args.plo and args.phi:
        ppsr = 0.5 * (args.plo + args.phi)
    if not ppsr and args.rlo and args.rhi and info is not None:
        T = info.N * info.dt
        ppsr = 2.0 * T / (args.rlo + args.rhi)
    if not (ppsr and args.porb and args.x):
        raise SystemExit("bincand: need -ppsr (or -plo/-phi or "
                         "-rlo/-rhi) plus -porb/-pb and -x, or "
                         "-candfile/-psr/-mak")
    t_since = args.t
    if args.To and info is not None:
        t_since = (info.mjd - args.To) * 86400.0
    w = args.w
    if args.wdot and args.To and info is not None:
        w += args.wdot * (info.mjd - args.To) / 365.25
    return ppsr, OrbitParams(p=args.porb, x=args.x, e=args.e, w=w,
                             t=t_since)


def main(argv=None, device="cuda") -> int:
    dev = resolve_device(device)
    args = build_parser().parse_args(argv)
    base = os.path.splitext(args.fftfile)[0]
    amps = datfft.read_fft(args.fftfile)
    pairs = np.stack([amps.real, amps.imag], -1).astype(np.float32)
    info = read_inf(base + ".inf")
    ppsr, trial = _trial_from_args(args, base, info)
    args.ppsr = ppsr
    res = optimize_bincand(pairs, N=2 * len(amps), dt=info.dt,
                           trial_orb=trial, ppsr=args.ppsr,
                           nsteps=args.nsteps, rounds=args.rounds,
                           device=dev)
    o = res.orb
    print("bincand: power %.3f" % res.power)
    print("  P_psr  = %.12g s" % res.ppsr)
    print("  P_orb  = %.8g s" % o.p)
    print("  x      = %.6g lt-s" % o.x)
    print("  T_peri = %.6g s" % o.t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
