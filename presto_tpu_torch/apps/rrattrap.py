"""rrattrap: group + rate single-pulse events across DM trials.

Host copy of ``presto_tpu/apps/rrattrap.py`` for the PyTorch port.

CLI parity with bin/rrattrap.py in spirit: takes the per-DM
.singlepulse files of a search, groups events close in (time, DM),
rates each group by its sigma-vs-DM structure, and writes groups.txt.
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.singlepulse.grouping import (read_and_group,
                                                   write_groups)


def build_parser():
    p = argparse.ArgumentParser(prog="rrattrap")
    p.add_argument("--time-thresh", type=float, default=0.1,
                   help="Grouping time tolerance, s")
    p.add_argument("--dm-thresh", type=float, default=None,
                   help="Grouping DM tolerance, pc/cm^3 (default: "
                        "2x the DM trial spacing)")
    p.add_argument("--min-group", type=int, default=30,
                   help="Members needed for a non-noise group")
    p.add_argument("--min-sigma", type=float, default=0.0)
    p.add_argument("--min-rank", type=int, default=3,
                   help="Only report groups with at least this rank")
    p.add_argument("-o", type=str, default="groups.txt")
    p.add_argument("spfiles", nargs="+")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    groups = read_and_group(args.spfiles, time_thresh=args.time_thresh,
                            dm_thresh=args.dm_thresh,
                            min_group=args.min_group,
                            min_sigma=args.min_sigma)
    write_groups(args.o, groups, min_rank=args.min_rank)
    shown = [g for g in groups if g.rank >= args.min_rank]
    print("rrattrap: %d events -> %d groups (%d with rank >= %d) -> %s"
          % (sum(g.numcands for g in groups), len(groups), len(shown),
             args.min_rank, args.o))
    for g in shown[:20]:
        print("  " + str(g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
