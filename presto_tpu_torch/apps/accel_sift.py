"""ACCEL_sift: sift accelsearch candidates across DM trials.

Host copy of ``presto_tpu/apps/accel_sift.py`` for the PyTorch port.

Parity: python/ACCEL_sift.py — glob *_ACCEL_<z> files, apply default
rejections, collapse duplicates, DM checks, harmonic removal, write
the sifted list.
"""

from __future__ import annotations

import argparse
import glob
import sys

from presto_tpu_torch.pipeline.sifting import sift_candidates


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ACCEL_sift",
        description="Sift *_ACCEL_<zmax> candidates across DM trials")
    p.add_argument("-g", "--glob", default="*_ACCEL_*[0-9]",
                   help="Glob for ACCEL files")
    p.add_argument("-o", "--out", default="cands_sifted.txt")
    p.add_argument("--min-dm-hits", type=int, default=2)
    p.add_argument("--low-dm-cutoff", type=float, default=2.0)
    p.add_argument("-defaultbirds", action="store_true",
                   help="Also reject candidates at the shipped "
                        "mains-harmonic birdie frequencies")
    p.add_argument("files", nargs="*")
    return p


def run(args):
    files = args.files or sorted(
        f for f in glob.glob(args.glob)
        if not f.endswith((".cand", ".txtcand", ".inf")))
    if not files:
        print("ACCEL_sift: no candidate files match")
        return None
    birds = ()
    if args.defaultbirds:
        from presto_tpu_torch.pipeline.sifting import default_known_birds_f
        birds = default_known_birds_f()
    cl = sift_candidates(files, numdms_min=args.min_dm_hits,
                         known_birds_f=birds,
                         low_DM_cutoff=args.low_dm_cutoff)
    cl.to_file(args.out)
    nbad = sum(len(v) for v in cl.badcands.values())
    print("ACCEL_sift: %d good cands (%d rejected, %d duplicates) -> %s"
          % (len(cl), nbad, len(cl.duplicates), args.out))
    return cl


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
