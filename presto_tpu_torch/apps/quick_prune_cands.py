"""quick_prune_cands: sigma-threshold an ACCEL candidate file.

Twin of bin/quick_prune_cands.py: reads one ACCEL_* file through the
sifting machinery, drops candidates under the sigma threshold (the
reference applies its sifting.sigma_threshold at read time), prints
the survivors' summary, and writes <file>.pruned.

Host copy of ``presto_tpu/apps/quick_prune_cands.py`` for the PyTorch
port, which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse

from presto_tpu_torch.pipeline import sifting


def build_parser():
    p = argparse.ArgumentParser(
        prog="quick_prune_cands",
        description="threshold an ACCEL file's candidates")
    p.add_argument("accelfile")
    p.add_argument("sigma", type=float, nargs="?", default=None,
                   help="sigma threshold (default: sifting's %.1f)"
                        % sifting.SIGMA_THRESHOLD)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cands = sifting.read_candidates([args.accelfile],
                                    prelim_reject=False)
    sigma = args.sigma if args.sigma is not None \
        else sifting.SIGMA_THRESHOLD
    kept = sifting.Candlist([c for c in cands if c.sigma >= sigma])
    kept.sort_by_sigma()
    print("quick_prune_cands: %d of %d candidates above sigma %.2f"
          % (len(kept), len(cands), sigma))
    for c in kept:
        print("  %s" % c)
    out = args.accelfile + ".pruned"
    kept.to_file(out)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
