"""presto-triage: train, evaluate and apply the learned candidate
triage ranker (triage/).

PyTorch counterpart of ``presto_tpu/apps/triage.py``: training and
scoring run on ``device`` (``main(argv, device=)``, default "cuda").  The weights path is
an argument: ``train`` needs ``-o`` and ``eval`` needs ``-weights``
(the port reads no environment override and no user cache); ``score``
without ``-weights`` prints the heuristic selection.

Subcommands:

  train DIR...        sift each workdir's ACCEL files, label against
                      its `*_injected.json` ground-truth sidecars
                      (models/inject.py), train the seeded ranker and
                      save the schema-versioned weights file
  train --synthetic   same loop on the seeded synthetic campaign (no
                      data needed)
  eval DIR...         recall-at-budget of a weights file against
                      workdirs with sidecars
  score DIR           rank one workdir's sifted candidates and print
                      the triage selection (what the DAG triage node
                      / -triage survey stage would fold)
  report              the acceptance report: seeded synthetic
                      campaign, train/eval split, recall + fold
                      reduction + determinism
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _workdir_obs(workdir):
    """(candidates, truth) for one survey workdir: re-sift its ACCEL
    files (deterministic: sorted glob) and pool every ground-truth
    sidecar found beside them."""
    from presto_tpu_torch.pipeline.sifting import sift_candidates
    from presto_tpu_torch.triage.calibrate import load_truth

    accfiles = sorted(
        p for p in glob.glob(os.path.join(workdir, "*_ACCEL_*"))
        if not p.endswith((".cand", ".txtcand")))
    cl = sift_candidates(accfiles) if accfiles else []
    truth = []
    for side in sorted(glob.glob(
            os.path.join(workdir, "*_injected.json"))):
        truth += load_truth(side)
    return list(cl), truth


def _gather(dirs):
    obs_sets = []
    for d in dirs:
        cands, truth = _workdir_obs(d)
        if cands:
            obs_sets.append((cands, truth))
        else:
            print("presto-triage: %s: no ACCEL candidates, skipped"
                  % d, file=sys.stderr)
    return obs_sets


def _cmd_train(args) -> int:
    from presto_tpu_torch.triage.calibrate import (synthetic_campaign,
                                                   train_on_observations)

    if args.synthetic:
        obs_sets = synthetic_campaign(seed=args.seed,
                                      n_obs=args.observations)
    else:
        obs_sets = _gather(args.dirs)
    if not obs_sets:
        raise SystemExit("presto-triage: nothing to train on")
    model = train_on_observations(obs_sets, seed=args.seed,
                                  device=args.device)
    path = args.out
    model.save(path)
    print("presto-triage: trained on %d candidates "
          "(%d observations, seed %d) -> %s"
          % (model.trained_on, len(obs_sets), args.seed, path))
    return 0


def _cmd_eval(args) -> int:
    from presto_tpu_torch.triage.calibrate import recall_at_budget
    from presto_tpu_torch.triage.model import load_model

    model, why = load_model(args.weights)
    if model is None:
        raise SystemExit("presto-triage: no usable weights (%s)"
                         % (why or "missing file"))
    rows, tot_truth, tot_rec = [], 0, 0
    for d in args.dirs:
        cands, truth = _workdir_obs(d)
        if not cands:
            continue
        budget = args.budget or max(len(cands) // 5, 1)
        r = recall_at_budget(
            cands, model.score_candidates(cands, device=args.device),
            truth, budget)
        rows.append({"workdir": d, "candidates": len(cands), **r})
        tot_truth += r["truth"]
        tot_rec += r.get("recovered", 0)
    out = {"per_workdir": rows, "injected": tot_truth,
           "recovered": tot_rec,
           "recall": (tot_rec / tot_truth) if tot_truth else 1.0}
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def _cmd_score(args) -> int:
    from presto_tpu_torch.triage.model import TriagePolicy

    cands, _truth = _workdir_obs(args.dirs[0])
    if not cands:
        raise SystemExit("presto-triage: no ACCEL candidates in %s"
                         % args.dirs[0])
    policy = TriagePolicy(weights_path=args.weights,
                          budget=args.budget, datdir=args.dirs[0],
                          device=args.device)
    selected, acct = policy.select(cands)
    print(json.dumps({
        "mode": acct.get("mode"),
        "scored": acct.get("scored", 0),
        "selected": [
            {"candnum": c.candnum, "filename": c.filename,
             "sigma": c.sigma, "dm": c.DM, "f": c.f}
            for c in selected],
        "folds_avoided": acct.get("folds_avoided", 0),
        "load_error": acct.get("load_error"),
    }, indent=1, sort_keys=True))
    return 0


def _cmd_report(args) -> int:
    from presto_tpu_torch.triage.calibrate import acceptance_report

    rep = acceptance_report(seed=args.seed, n_obs=args.observations,
                            reduction=args.reduction, device=args.device)
    text = json.dumps(rep, indent=1, sort_keys=True)
    print(text)
    if args.out:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(args.out, text + "\n")
    ok = (rep["recall"] >= args.min_recall
          and rep["fold_reduction"] >= args.reduction
          and rep["deterministic_ranking"])
    return 0 if ok else 1


def build_parser():
    p = argparse.ArgumentParser(prog="presto-triage")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--synthetic", action="store_true",
                   help="train on the seeded synthetic campaign "
                        "instead of workdirs")
    t.add_argument("-seed", type=int, default=0)
    t.add_argument("-observations", type=int, default=12,
                   help="with --synthetic: campaign size")
    t.add_argument("-o", dest="out", type=str, required=True,
                   help="weights path")
    t.add_argument("dirs", nargs="*")
    t.set_defaults(func=_cmd_train)

    e = sub.add_parser("eval")
    e.add_argument("-weights", type=str, required=True)
    e.add_argument("-budget", type=int, default=None,
                   help="fold budget per workdir (default: n/5)")
    e.add_argument("dirs", nargs="+")
    e.set_defaults(func=_cmd_eval)

    s = sub.add_parser("score")
    s.add_argument("-weights", type=str, default=None)
    s.add_argument("-budget", type=int, default=None)
    s.add_argument("dirs", nargs=1)
    s.set_defaults(func=_cmd_score)

    r = sub.add_parser("report")
    r.add_argument("-seed", type=int, default=20)
    r.add_argument("-observations", type=int, default=12)
    r.add_argument("-reduction", type=float, default=5.0)
    r.add_argument("-min-recall", dest="min_recall", type=float,
                   default=0.99)
    r.add_argument("-out", type=str, default=None,
                   help="write the report here too")
    r.set_defaults(func=_cmd_report)
    return p


def main(argv=None, device="cuda") -> int:
    """Run one subcommand on ``device`` (without a card "cuda"
    raises)."""
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    args.device = resolve_device(device)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
