"""powerstats: significance calculator for normalized FFT powers.

Non-interactive twin of the reference's Q&A tool (bin/powerstats.py):
given a normalized power (and optionally a number of summed
powers/harmonics and a number of independent trials), print the
equivalent Gaussian significance, the single-trial probability, and
the detection threshold at a requested sigma.

Host copy of ``presto_tpu/apps/powerstats.py`` for the PyTorch port,
which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np

from presto_tpu_torch.ops.stats import (candidate_sigma, chi2_logp,
                                        power_for_sigma)


def build_parser():
    p = argparse.ArgumentParser(
        prog="powerstats",
        description="Normalized-power significance statistics")
    p.add_argument("-power", type=float, default=None,
                   help="summed normalized power to evaluate")
    p.add_argument("-numsum", type=int, default=1,
                   help="number of summed powers/harmonics (default 1)")
    p.add_argument("-numtrials", type=float, default=1.0,
                   help="independent trials searched (default 1)")
    p.add_argument("-sigma", type=float, default=None,
                   help="also print the power needed for this "
                        "equivalent Gaussian significance")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.power is None and args.sigma is None:
        build_parser().error("give -power and/or -sigma")
    if args.power is not None:
        # P(>p | numsum powers) = chi2 survival with 2*numsum dof at
        # 2*power (exponential statistics of normalized powers)
        logp1 = chi2_logp(2.0 * args.power, 2 * args.numsum)
        sig = candidate_sigma(args.power, args.numsum, args.numtrials)
        print("power = %.4f  (numsum=%d, numtrials=%g)"
              % (args.power, args.numsum, args.numtrials))
        print("  single-trial log10(prob) = %.4f"
              % (logp1 / np.log(10.0)))
        print("  equivalent gaussian sigma (after trials) = %.4f"
              % sig)
    if args.sigma is not None:
        need = power_for_sigma(args.sigma, args.numsum, args.numtrials)
        print("power for %.2f sigma (numsum=%d, numtrials=%g) = %.4f"
              % (args.sigma, args.numsum, args.numtrials, need))
        # matched-filter amplitude sensitivity scale: S/N ~ sqrt(P)
        print("  corresponding amplitude S/N ~ sqrt(power) = %.3f"
              % np.sqrt(need))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
