"""fit_circular_orbit / fitorb: fit a binary orbit to (time, period)
measurements from .bestprof files or a two-column text file
(bin/fit_circular_orbit.py, bin/fitorb.py).

Host copy of ``presto_tpu/apps/fit_circular_orbit.py`` for the PyTorch
port, which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.search.orbitfit import fit_circular_orbit, \
    fit_eccentric_orbit

SECPERDAY = 86400.0


def _load_measurements(paths):
    """(times_sec_from_first, periods_sec, t0_sec).  t0 is the first
    epoch in seconds (MJD*86400) so T0 can be reported as an MJD.
    .bestprof inputs use their topo epoch and period; a text file is
    'MJD period_s' per line."""
    ts, ps = [], []
    for path in paths:
        if path.endswith(".bestprof"):
            from presto_tpu_torch.io.bestprof import read_bestprof
            bp = read_bestprof(path)
            ts.append(bp.epoch * SECPERDAY)
            ps.append(bp.p0_topo)
        else:
            arr = np.loadtxt(path, ndmin=2)
            ts.extend(arr[:, 0] * SECPERDAY)
            ps.extend(arr[:, 1])
    t = np.asarray(ts, float)
    t0 = t.min()
    return t - t0, np.asarray(ps, float), t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fit_circular_orbit")
    p.add_argument("-porb", type=float, required=True,
                   help="Orbital period guess, HOURS")
    p.add_argument("-x", type=float, default=1.0,
                   help="a sin(i)/c guess, lt-s")
    p.add_argument("-e", action="store_true", dest="ecc",
                   help="Fit an eccentric orbit (fitorb mode)")
    p.add_argument("inputs", nargs="+",
                   help=".bestprof files or 'MJD period' text files")
    args = p.parse_args(argv)
    t, periods, t0 = _load_measurements(args.inputs)
    fitfn = fit_eccentric_orbit if args.ecc else fit_circular_orbit
    fit = fitfn(t, periods, args.porb * 3600.0, args.x)
    print("p_psr  = %.12g s" % fit.p_psr)
    print("P_orb  = %.8g s (%.6g hr)" % (fit.p_orb, fit.p_orb / 3600))
    print("x      = %.6g lt-s" % fit.x)
    print("T0     = MJD %.8f" % ((t0 + fit.T0) / SECPERDAY))
    if args.ecc:
        print("e      = %.6g" % fit.e)
        print("w      = %.6g deg" % fit.w)
    print("rms    = %.4g s" % fit.rms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
