"""injectpsr: add a synthetic pulsar to a filterbank file
(bin/injectpsr.py parity in spirit: -p/-f period/freq, -dm, -amp or
-snr, gaussian profile or -profile file, optional circular orbit).

Host copy of ``presto_tpu/apps/injectpsr.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.models.inject import (InjectParams, amp_for_snr,
                                            inject_into_filterbank)


def build_parser():
    p = argparse.ArgumentParser(prog="injectpsr")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-p", type=float, help="Period, s")
    g.add_argument("-f", type=float, help="Frequency, Hz")
    p.add_argument("-fdot", type=float, default=0.0)
    p.add_argument("-dm", type=float, default=0.0)
    p.add_argument("-amp", type=float, default=None,
                   help="Peak amplitude, data units")
    p.add_argument("-snr", type=float, default=None,
                   help="Target matched-filter S/N (assumes unit "
                        "per-sample noise unless -noise given)")
    p.add_argument("-noise", type=float, default=1.0,
                   help="Per-sample noise sigma for -snr scaling")
    p.add_argument("-width", type=float, default=0.05,
                   help="Gaussian FWHM, rotations")
    p.add_argument("-profile", type=str, default=None,
                   help="Text file, one profile value per line")
    p.add_argument("-phase", type=float, default=0.0)
    # scattering tail (bin/injectpsr.py's scattering model)
    p.add_argument("-tau", type=float, default=0.0,
                   help="Scattering timescale, s, at -taufreq "
                        "(0 = no scattering)")
    p.add_argument("-taufreq", type=float, default=0.0,
                   help="Reference freq for -tau, MHz (default: the "
                        "highest channel)")
    p.add_argument("-tauidx", type=float, default=-4.0,
                   help="Scattering spectral index: tau ~ nu^idx")
    # circular-orbit injection (bin/injectpsr.py's orbit options)
    p.add_argument("-porb", type=float, default=0.0,
                   help="Orbital period, s (0 = isolated)")
    p.add_argument("-xorb", type=float, default=0.0,
                   help="Projected semi-major axis, lt-s")
    p.add_argument("-torb", type=float, default=0.0,
                   help="Time of periastron passage, s")
    p.add_argument("-o", type=str, required=True, help="Output .fil")
    p.add_argument("-truth-out", dest="truth_out", type=str,
                   default=None,
                   help="Ground-truth sidecar path (default: "
                        "<out>_injected.json; 'none' disables)")
    p.add_argument("infile")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    f = args.f if args.f else 1.0 / args.p
    profile = (np.loadtxt(args.profile, usecols=(-1,))
               if args.profile else None)
    orbit = None
    if args.porb > 0:
        from presto_tpu_torch.ops.orbit import OrbitParams
        # -torb: time OF periastron (obs seconds); OrbitParams.t is
        # time SINCE periastron at t=0, hence the sign flip
        orbit = OrbitParams(p=args.porb, x=args.xorb, e=0.0, w=0.0,
                            t=-args.torb)
    params = InjectParams(f=f, fdot=args.fdot, phase0=args.phase,
                          dm=args.dm, shape="gauss", width=args.width,
                          profile=profile, orbit=orbit, tau=args.tau,
                          tau_ref_mhz=args.taufreq,
                          tau_index=args.tauidx)
    if args.amp is not None:
        params.amp = args.amp
    elif args.snr is not None:
        from presto_tpu_torch.io.sigproc import FilterbankFile
        with FilterbankFile(args.infile) as fb:
            N, nchan = fb.header.N, fb.header.nchans
        params.amp = amp_for_snr(args.snr, params, N, args.noise, nchan)
    else:
        raise SystemExit("one of -amp / -snr is required")
    write_truth = (args.truth_out or "").lower() != "none"
    inject_into_filterbank(
        args.infile, args.o, params,
        truth_out=args.truth_out if write_truth else None,
        write_truth=write_truth)
    print("injectpsr: %s + (f=%.6g Hz, DM=%.2f, amp=%.4g%s%s) -> %s"
          % (args.infile, f, args.dm, params.amp,
             ", orbit" if orbit else "",
             ", tau=%.3gs" % args.tau if args.tau else "", args.o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
