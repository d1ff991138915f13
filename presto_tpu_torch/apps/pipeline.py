"""pipeline: the full search flow as one command
(rfifind -> DDplan -> prepsubband -> realfft -> [zapbirds] ->
accelsearch -> sift -> prepfold -> single_pulse_search), the analog of
the reference's survey drivers (bin/PALFA_presto_search.py etc.).
Restartable: stages with existing artifacts are skipped.

PyTorch counterpart of ``presto_tpu/apps/pipeline.py``, on ``device``
(``main(argv, device=)``, default "cuda"): ``--recipe`` expands a named
survey policy (pipeline/recipes), ``--driftprep`` splits a drift scan
into pointings first (pipeline/driftprep) and runs one survey a
pointing.
"""

from __future__ import annotations

import argparse
import os
import sys

from presto_tpu_torch.pipeline.driftprep import ORIG_N, split_drift_scan
from presto_tpu_torch.pipeline.recipes import RECIPES, get_recipe
from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey


def build_parser():
    p = argparse.ArgumentParser(prog="pipeline")
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-hidm", type=float, default=100.0)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-zmax", type=int, default=0)
    p.add_argument("-numharm", type=int, default=8)
    p.add_argument("-sigma", type=float, default=4.0)
    p.add_argument("-rfitime", type=float, default=2.0)
    p.add_argument("-zaplist", type=str, default=None)
    p.add_argument("-foldtop", type=int, default=3)
    p.add_argument("-nosp", action="store_true",
                   help="Skip the single-pulse search stage")
    p.add_argument("-norfi", action="store_true",
                   help="Skip rfifind masking")
    p.add_argument("-workdir", type=str, default=".")
    p.add_argument("--recipe", type=str, default=None,
                   help="named survey policy (%s): sets the accel "
                        "passes, sift thresholds, fold selection, SP "
                        "settings and zaplist; -lodm/-hidm/-nsub/"
                        "-zaplist still apply"
                        % ", ".join(sorted(RECIPES)))
    p.add_argument("--driftprep", action="store_true",
                   help="treat the input as a raw drift scan: split "
                        "it into overlapping pointings first (apps/"
                        "drift_prep) and run the survey per pointing "
                        "(the GBT350_drift_search.py flow)")
    p.add_argument("-orign", type=int, default=None,
                   help="with --driftprep: samples per pointing")
    p.add_argument("-triage", action="store_true",
                   help="learned candidate triage (triage/): rank the "
                        "heuristic fold selection with the trained "
                        "scorer and fold only the top budget; keeps "
                        "the unchanged heuristic when no valid weights "
                        "file is given")
    p.add_argument("-triage-budget", dest="triage_budget", type=int,
                   default=None,
                   help="with -triage: fold at most this many "
                        "candidates (default: the heuristic count)")
    p.add_argument("-triage-weights", dest="triage_weights", type=str,
                   default=None,
                   help="with -triage: the weights file")
    p.add_argument("rawfiles", nargs="+")
    return p


def main(argv=None, device="cuda") -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.recipe:
        # the recipe owns these policies: an explicitly passed value
        # would be silently ignored, so the conflict is an error
        for name in ("zmax", "numharm", "sigma", "rfitime", "foldtop"):
            if getattr(args, name) != parser.get_default(name):
                raise SystemExit(
                    "pipeline: -%s conflicts with --recipe %s (the "
                    "recipe sets that policy); drop the flag or the "
                    "recipe" % (name, args.recipe))
        cfg = get_recipe(args.recipe).to_config(
            args.lodm, args.hidm, nsub=args.nsub, zaplist=args.zaplist)
        cfg.singlepulse = not args.nosp
        cfg.skip_rfifind = args.norfi
    else:
        cfg = SurveyConfig(
            lodm=args.lodm, hidm=args.hidm, nsub=args.nsub,
            zmax=args.zmax, numharm=args.numharm, sigma=args.sigma,
            rfi_time=args.rfitime, zaplist=args.zaplist,
            fold_top=args.foldtop, singlepulse=not args.nosp,
            skip_rfifind=args.norfi)
    if args.triage:
        cfg.triage = {"budget": args.triage_budget,
                      "weights": args.triage_weights}
    if args.driftprep:
        # one survey a pointing, each in its own subdirectory (each
        # pointing is an independent sky position;
        # GBT350_drift_search.py runs the flow once a prepped file)
        pointings = split_drift_scan(args.rawfiles, outdir=args.workdir,
                                     orig_N=args.orign or ORIG_N)
        print("pipeline: drift scan -> %d pointings" % len(pointings))
        results = [run_survey([pf], cfg, workdir=os.path.join(
            args.workdir, os.path.splitext(os.path.basename(pf))[0]),
            device=device) for pf in pointings]
        print("pipeline: done — %d pointings, %d sifted cands, "
              "%d folds, %d SP events"
              % (len(results),
                 sum(len(r.sifted) if r.sifted else 0 for r in results),
                 sum(len(r.folded) for r in results),
                 sum(r.sp_events for r in results)))
        return 0
    res = run_survey(args.rawfiles, cfg, workdir=args.workdir,
                     device=device)
    print("pipeline: done — %d DMs, %d sifted cands, %d folds, "
          "%d SP events" % (len(res.datfiles),
                            len(res.sifted) if res.sifted else 0,
                            len(res.folded), res.sp_events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
