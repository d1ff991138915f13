"""show_pfd: re-render a .pfd file's diagnostic plot (src/show_pfd.c).

The reference re-creates the prepfold plot (and optionally modified
versions) from a saved .pfd; here it renders the matplotlib
multi-panel plot to <root>.png (and .ps with -portrait/-noxwin
semantics folded into file output).  Flags (clig/show_pfd_cmd.cli):
-killsubs/-killparts zero out subbands/parts before re-plotting;
-scaleparts/-allgrey/-justprofs/-fixchi/-portrait control rendering;
-infoonly prints the candidate info without plotting; -showfold uses
the fold values instead of re-deriving the best profile; -events
treats the cube as event counts (Poisson stats).

PyTorch counterpart of ``presto_tpu/apps/show_pfd.py``: the plot's
panels (plotting/pfdplot.pfd_panels: the chi2(P, Pdot) plane, the DM and
growth curves) are computed on ``device``, CUDA unless the caller passes
"cpu"; drawing needs matplotlib (ImportError naming it where it is
missing).  -infoonly needs neither.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from presto_tpu_torch.io.pfd import read_pfd
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.utils.ranges import parse_ranges


def build_parser():
    p = argparse.ArgumentParser(prog="show_pfd")
    p.add_argument("-o", type=str, default=None,
                   help="Output image (single input only); default "
                        "<input>.png")
    p.add_argument("-noxwin", action="store_true",
                   help="No on-screen display (files only; default "
                        "in this rebuild)")
    p.add_argument("-showfold", action="store_true",
                   help="Plot at the FOLD values (no best-model "
                        "re-derivation)")
    p.add_argument("-scaleparts", action="store_true")
    p.add_argument("-allgrey", action="store_true")
    p.add_argument("-justprofs", action="store_true")
    p.add_argument("-portrait", action="store_true")
    p.add_argument("-fixchi", action="store_true")
    p.add_argument("-infoonly", action="store_true",
                   help="Print candidate info, no plot")
    p.add_argument("-events", action="store_true",
                   help="Cube holds event counts (Poisson stats)")
    p.add_argument("-killsubs", type=str, default=None,
                   help="Subbands to zero, e.g. '0:3,12'")
    p.add_argument("-killparts", type=str, default=None,
                   help="Sub-integrations to zero")
    p.add_argument("pfdfiles", nargs="+")
    return p


def _print_info(pfd):
    from presto_tpu_torch.utils.psr import f_to_p
    bp, bpd, _ = f_to_p(pfd.fold_p1, pfd.fold_p2, pfd.fold_p3)
    print("Cand:        %s" % (pfd.candnm or "?"))
    print("From file:   %s" % pfd.filenm)
    print("Telescope:   %s" % pfd.telescope)
    print("Epoch_topo:  %.12f" % pfd.tepoch)
    print("P_fold (s):  %.12g   Pd: %.6g" % (bp, bpd))
    print("f_fold (Hz): %.12g   fd: %.6g   fdd: %.6g"
          % (pfd.fold_p1, pfd.fold_p2, pfd.fold_p3))
    print("Best DM:     %.4f" % pfd.bestdm)
    print("npart=%d nsub=%d proflen=%d numchan=%d dt=%g"
          % (pfd.npart, pfd.nsub, pfd.proflen, pfd.numchan, pfd.dt))


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    from presto_tpu_torch.plotting import plot_pfd
    from presto_tpu_torch.plotting.pfdplot import PlotFlags
    if args.o and len(args.pfdfiles) > 1:
        raise SystemExit("-o only valid with a single .pfd input")
    if not args.infoonly:
        device = resolve_device(device)
    flags = PlotFlags(scaleparts=args.scaleparts, allgrey=args.allgrey,
                      justprofs=args.justprofs, fixchi=args.fixchi,
                      portrait=args.portrait)
    for f in args.pfdfiles:
        pfd = read_pfd(f)
        if args.killsubs:
            for s in parse_ranges(args.killsubs):
                if 0 <= s < pfd.nsub:
                    pfd.profs[:, s, :] = 0.0
                    # keep numdata (col 0): the time axis and chi2
                    # curves derive part durations from it
                    pfd.stats[:, s, 1:] = 0.0
        if args.killparts:
            for k in parse_ranges(args.killparts):
                if 0 <= k < pfd.npart:
                    pfd.profs[k] = 0.0
                    pfd.stats[k, :, 1:] = 0.0
        if args.infoonly:
            _print_info(pfd)
            continue
        best_prof = (np.asarray(pfd.profs, float).sum(axis=(0, 1))
                     if args.showfold else None)
        out = args.o or (os.path.splitext(f)[0] + ".png")
        plot_pfd(pfd, out, best_prof=best_prof, flags=flags,
                 device=device)
        print("show_pfd: %s -> %s" % (f, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
