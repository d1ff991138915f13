"""sum_profiles: align (FFTFIT) and sum profiles from .pfd/.bestprof
files (bin/sum_profiles.py analog) into one high-S/N profile.

Host copy of ``presto_tpu/apps/sum_profiles.py`` for the PyTorch port,
which imports nothing from the JAX package: FFTFIT and the profile
rotation are host float64 code, so there is no device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from presto_tpu_torch.timing.fftfit import fftfit
from presto_tpu_torch.ops.fold import shift_prof


def _load_profile(path: str) -> np.ndarray:
    if path.endswith(".pfd"):
        from presto_tpu_torch.io.pfd import read_pfd
        return np.asarray(read_pfd(path).profs, float).sum(axis=(0, 1))
    from presto_tpu_torch.io.bestprof import read_bestprof
    return read_bestprof(path).profile


def sum_profiles(paths, template=None):
    profs = [np.asarray(_load_profile(p), float) for p in paths]
    n = len(profs[0])
    if any(len(p) != n for p in profs):
        raise SystemExit("sum_profiles: profile lengths differ")
    if template is None:
        template = profs[0]
    total = np.zeros(n)
    shifts = []
    for prof in profs:
        fit = fftfit(prof, template)
        # remove the fitted shift: rotate LEFT by shift*n bins
        total += shift_prof(prof - fit.offset, fit.shift * n) \
            / max(fit.b, 1e-12)
        shifts.append(fit.shift)
    return total, shifts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sum_profiles")
    p.add_argument("-t", type=str, default=None,
                   help="Template .bestprof (default: first input)")
    p.add_argument("-o", type=str, default="sum.prof")
    p.add_argument("profiles", nargs="+")
    args = p.parse_args(argv)
    template = _load_profile(args.t) if args.t else None
    total, shifts = sum_profiles(args.profiles, template)
    with open(args.o, "w") as f:
        for i, v in enumerate(total):
            f.write("%4d  %.7g\n" % (i, v))
    print("sum_profiles: %d profiles -> %s (shifts: %s)"
          % (len(args.profiles), args.o,
             " ".join("%.4f" % s for s in shifts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
