"""weights_to_ignorechan: .weights file -> -ignorechan range string.

Twin of bin/weights_to_ignorechan.py: reads the chan/weight table
(rfifind_stats writes one), compresses the zero-weight channels into
the 'a:b,c,d:e' range syntax every prep* tool's -ignorechan accepts,
and prints it (plus a ready-to-paste paz -z line for psrfits users).

Host copy of ``presto_tpu/apps/weights_to_ignorechan.py`` for the
PyTorch port, which imports nothing from the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="weights_to_ignorechan",
        description=".weights -> -ignorechan line")
    p.add_argument("-o", "--output", default="",
                   help="also write the line to this file")
    p.add_argument("weightsfile")
    return p


def build_chanline(weights):
    """Zero-weight channel list as compressed ranges 'a:b,c'."""
    bad = np.flatnonzero(np.asarray(weights) == 0)
    if bad.size == 0:
        return ""
    parts = []
    start = prev = int(bad[0])
    for c in bad[1:]:
        c = int(c)
        if c == prev + 1:
            prev = c
            continue
        parts.append("%d:%d" % (start, prev) if prev > start
                     else "%d" % start)
        start = prev = c
    parts.append("%d:%d" % (start, prev) if prev > start
                 else "%d" % start)
    return ",".join(parts)


def main(argv=None):
    args = build_parser().parse_args(argv)
    chans, weights = np.loadtxt(args.weightsfile, unpack=True,
                                ndmin=2)[:2]
    line = build_chanline(weights)
    print(line)
    if line:
        print("# paz equivalent: paz -z \"%s\" ..."
              % line.replace(":", "-").replace(",", " "))
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
