"""monte_binresp: Monte-Carlo binary-detection efficiency campaign.

PyTorch counterpart of ``presto_tpu/apps/monte_binresp.py``: the
scalable analog of the reference's validation studies
(python/binresponses/monte_short.py / monte_ffdot.py / monte_sideb.py):
simulate binary pulsars across orbital regimes, run the acceleration and
phase-modulation searches on ``device``, report detection fractions.
Raise --ntrials/--N for a publication-grade campaign (same code path).
"""

from __future__ import annotations

import argparse

from presto_tpu_torch.pipeline.monte import (MonteConfig, format_table,
                                             run_campaign, save_json)
from presto_tpu_torch.search.accel import resolve_device


def build_parser():
    p = argparse.ArgumentParser(prog="monte_binresp")
    p.add_argument("--ntrials", type=int, default=8)
    p.add_argument("--N", type=int, default=1 << 19)
    p.add_argument("--dt", type=float, default=1e-2)
    p.add_argument("--fpsr", type=float, default=20.0)
    p.add_argument("--amp", type=float, default=0.2)
    p.add_argument("--asini", type=float, default=0.2,
                   help="Projected semi-major axis (lt-s)")
    p.add_argument("--ecc", type=float, default=0.0)
    p.add_argument("--ratios", type=float, nargs="+",
                   default=[0.1, 0.3, 3.0, 10.0],
                   help="Orbital period / observation length grid")
    p.add_argument("--methods", nargs="+",
                   default=["ffdot", "short", "long"],
                   choices=["ffdot", "short", "long"])
    p.add_argument("--sigma", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("-o", "--out", default=None,
                   help="Write results JSON here")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None, device="cuda"):
    dev = resolve_device(device)
    args = build_parser().parse_args(argv)
    cfg = MonteConfig(N=args.N, dt=args.dt, f_psr=args.fpsr,
                      amp=args.amp, asini_lts=args.asini,
                      ecc=args.ecc, pb_over_t=tuple(args.ratios),
                      ntrials=args.ntrials, sigma_cut=args.sigma,
                      seed=args.seed)
    res = run_campaign(cfg, methods=list(args.methods),
                       progress=not args.quiet, device=dev)
    print(format_table(res))
    if args.out:
        save_json(res, args.out)
        print("monte_binresp: wrote %s" % args.out)
    return 0


if __name__ == "__main__":
    main()
