"""pipeline: the full search flow as one command
(rfifind -> DDplan -> prepsubband -> realfft -> accelsearch -> sift ->
prepfold -> single_pulse_search), the analog of the reference's survey
drivers (bin/PALFA_presto_search.py etc.).  Restartable: stages with
existing artifacts are skipped.

PyTorch counterpart of ``presto_tpu/apps/pipeline.py``, on ``device``
(``main(argv, device=)``, default "cuda").  Not in the port yet: ``--recipe`` (pipeline/recipes) and
``--driftprep`` (pipeline/driftprep); the survey itself refuses a
zaplist (zapbirds) and barycentring, which later slices bring.
"""

from __future__ import annotations

import argparse
import sys

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
    args = build_parser().parse_args(argv)
    cfg = SurveyConfig(
        lodm=args.lodm, hidm=args.hidm, nsub=args.nsub,
        zmax=args.zmax, numharm=args.numharm, sigma=args.sigma,
        rfi_time=args.rfitime, zaplist=args.zaplist,
        fold_top=args.foldtop, singlepulse=not args.nosp,
        skip_rfifind=args.norfi)
    if args.triage:
        cfg.triage = {"budget": args.triage_budget,
                      "weights": args.triage_weights}
    res = run_survey(args.rawfiles, cfg, workdir=args.workdir,
                     device=device)
    print("pipeline: done — %d DMs, %d sifted cands, %d folds, "
          "%d SP events" % (len(res.datfiles),
                            len(res.sifted) if res.sifted else 0,
                            len(res.folded), res.sp_events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
