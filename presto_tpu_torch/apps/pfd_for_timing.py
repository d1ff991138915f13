"""pfd_for_timing: can these .pfd files be used for TOA extraction?

Host copy of ``presto_tpu/apps/pfd_for_timing.py`` for the PyTorch port,
which imports nothing from the JAX package.

Twin of bin/pfd_for_timing.py: prints '<file>: true' when the fold
solution was not moved by searching (see io/pfd.use_for_timing),
'false' otherwise.
"""

from __future__ import annotations

import argparse
import sys

from presto_tpu_torch.io.pfd import read_pfd, use_for_timing


def build_parser():
    p = argparse.ArgumentParser(
        prog="pfd_for_timing",
        description="check .pfd files for timing usability")
    p.add_argument("pfdfiles", nargs="+")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    bad = 0
    for path in args.pfdfiles:
        try:
            ok = use_for_timing(read_pfd(path))
            print("%s: %s" % (path, "true" if ok else "false"))
            bad += 0 if ok else 1
        except Exception as e:
            sys.stderr.write("Error: can't check '%s' (%s)\n"
                             % (path, e))
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
