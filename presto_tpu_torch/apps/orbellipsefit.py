"""orbellipsefit: initial orbit from (period, acceleration) pairs.

Twin of bin/orbellipsefit.py (Freire, Kramer & Lyne 2001 method):
reads P0/P1 (or F0/F1) with errors from .bestprof and/or .par files,
forms accelerations a = c * P1 / P0, fits Eqn A1's parabola
a^2 = p2 P^2 + p1 P + p0 (the period-acceleration ellipse) by
weighted least squares, and reports the circular-orbit estimates:

    P0   = -p1 / (2 p2)                (intrinsic period)
    A1^2 = a^2(P0)                     (max line-of-sight accel)
    P1w  = sqrt(-A1^2 / p2)            (period half-amplitude)
    Porb = 2 pi c P1w / (P0 A1)
    X    = asini/c = P1w^2 c / (P0^2 A1)

Host copy of ``presto_tpu/apps/orbellipsefit.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np

CSPEED = 299792458.0


def build_parser():
    p = argparse.ArgumentParser(
        prog="orbellipsefit",
        description="ellipse fit to (P, accel) measurements")
    p.add_argument("-f1errmax", type=float, default=3.0e-7,
                   help="ignore points with F1 error above this")
    p.add_argument("files", nargs="+",
                   help=".bestprof and/or .par files")
    return p


def _read_point(path, f1errmax):
    """-> (mjd, p0, p0err, p1, p1err) or None."""
    if path.endswith(".bestprof"):
        from presto_tpu_torch.io.bestprof import read_bestprof
        b = read_bestprof(path)
        if not b.p0_topo:
            return None
        p0, p0e = b.p0_topo, b.p0err_topo or 1e-10
        p1, p1e = b.p1_topo, b.p1err_topo or 1e-12
        mjd = b.epoch
    else:
        from presto_tpu_torch.io.parfile import read_parfile
        pf = read_parfile(path)
        f0 = float(getattr(pf, "F0"))
        f1 = float(getattr(pf, "F1", 0.0))
        f0e = float(getattr(pf, "F0_ERR", 2e-5) or 2e-5)
        f1e = float(getattr(pf, "F1_ERR", 1e-7) or 1e-7)
        mjd = float(getattr(pf, "PEPOCH", 0.0))
        p0 = 1.0 / f0
        p0e = f0e / f0 ** 2
        p1 = -f1 / f0 ** 2
        p1e = f1e / f0 ** 2
        if f1e > f1errmax:
            return None
    return mjd, p0, p0e, p1, p1e


def fit_parabola(ps, a2, a2err):
    """Weighted LSQ of a^2 = q2 u^2 + q1 u + q0 with u = P - mean(P)
    (raw-P columns are catastrophically collinear: P varies by parts
    in 1e6 of itself around an orbit).  Returns (q0, q1, q2, pbar)."""
    pbar = ps.mean()
    u = ps - pbar
    su = u.std() or 1.0          # unit-scale columns: raw u ~ 1e-6 s
    un = u / su
    A = np.stack([np.ones_like(un), un, un * un], axis=1)
    w = 1.0 / np.maximum(a2err, 1e-30)
    coef, *_ = np.linalg.lstsq(A * w[:, None], a2 * w, rcond=None)
    return coef[0], coef[1] / su, coef[2] / su ** 2, pbar


def orbit_from_parabola(q0, q1, q2, pbar):
    if q2 >= 0:
        raise ValueError("parabola opens upward: no ellipse "
                         "(need points on both sides of the orbit)")
    u0 = -q1 / (2.0 * q2)
    P0 = pbar + u0
    A1sq = q0 - q1 * q1 / (4.0 * q2)
    if A1sq <= 0:
        raise ValueError("negative peak acceleration^2")
    A1 = np.sqrt(A1sq)
    P1w = np.sqrt(-A1sq / q2)
    Porb = 2.0 * np.pi * CSPEED * P1w / (P0 * A1)
    X = P1w ** 2 * CSPEED / (P0 ** 2 * A1)
    return P0, Porb, X, A1, P1w


def main(argv=None):
    args = build_parser().parse_args(argv)
    pts = [q for q in (_read_point(f, args.f1errmax)
                       for f in args.files) if q]
    if len(pts) < 3:
        raise SystemExit("orbellipsefit: need >= 3 usable "
                         "measurements, have %d" % len(pts))
    mjd, p0s, p0es, p1s, p1es = map(np.asarray, zip(*pts))
    accs = CSPEED * p1s / p0s
    accerrs = np.abs(accs) * np.sqrt((p1es / np.where(p1s, p1s, 1))**2
                                     + (p0es / p0s) ** 2)
    accerrs = np.maximum(accerrs, 1e-4 * max(1.0, np.abs(accs).max()))
    print("MJD            P (ms)          accel (m/s^2)")
    for m, p, a in zip(mjd, p0s, accs):
        print("%.4f  %.9f  %+.6f" % (m, p * 1e3, a))
    # sigma(a^2) = sqrt((2 a sigma_a)^2 + 2 sigma_a^4): the second
    # term keeps near-zero-acceleration points from getting unbounded
    # weight and degenerating the fit
    a2err = np.sqrt((2 * accs * accerrs) ** 2 + 2 * accerrs ** 4)
    a2err = np.maximum(a2err, 1e-8 * (accs ** 2).max())
    q0, q1, q2, pbar = fit_parabola(p0s, accs ** 2, a2err)
    P0, Porb, X, A1, P1w = orbit_from_parabola(q0, q1, q2, pbar)
    print("\nFitted circular-orbit estimates (Freire+ 2001, Eqn A1):")
    print("  P0   = %.12g s" % P0)
    print("  Porb = %g s (%.4f days)" % (Porb, Porb / 86400.0))
    print("  asini/c = %.6g lt-s" % X)
    print("  A1 (max accel) = %.6g m/s^2" % A1)
    print("  P half-amplitude = %.6g s" % P1w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
