"""pfd2png: render .pfd fold archives straight to PNG.

The reference's bin/pfd2png is a two-line shell wrapper converting
prepfold's PostScript output with pstoimg (`pstoimg -density 200
-antialias -flip cw`); this rebuild renders the same multi-panel
diagnostic natively with matplotlib (plotting/pfdplot via the
show_pfd machinery), so the tool is just show_pfd pointed at PNG
output — kept as its own entry point for command-name parity.

Usage: python -m presto_tpu_torch.apps.pfd2png file1.pfd [file2.pfd ...]
Writes <file>.png beside each input.

PyTorch counterpart of ``presto_tpu/apps/pfd2png.py``: the plot's panels
are computed on ``device`` (CUDA unless the caller passes "cpu"), and
drawing needs matplotlib (ImportError naming it where it is missing).
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(prog="pfd2png")
    p.add_argument("pfdfiles", nargs="+")
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.apps import show_pfd
    rc = 0
    for f in args.pfdfiles:
        rc |= show_pfd.main([f, "-noxwin"], device=device) or 0
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
