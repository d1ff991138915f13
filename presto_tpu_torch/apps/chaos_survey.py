"""chaos_survey: randomized kill/corruption schedules over a tiny
synthetic survey, asserting resume equivalence.

Counterpart of ``tools/chaos_survey.py``, with its flags and
``--device``.  Each trial draws a random kill schedule (seeded,
reproducible): the survey is killed at a random instrumented point 1-3
times, optionally with a random artifact corruption
(truncate/bitflip/delete) between crashes, then resumed to completion.
The final artifacts must be byte-identical to a reference run that was
never interrupted.  Every survey runs on ``--device`` (default cuda;
without a card it raises, nothing falls back) through one plan cache
(serve/plancache.SearcherProvider).

    python -m presto_tpu_torch.apps.chaos_survey [--trials 5] [--seed 0]
        [--workdir DIR] [--keep] [--nspec 8192] [--nchan 16]
        [--device cuda]

On the tool's observation both packages' run_survey pass the same kill
points in the same order, on a fresh run and on a resumed one
(tests/test_torch_chaos_survey.py), so a seed's schedule lands on the
same stages in both.

Exit status 0 iff every trial converged to the reference artifacts.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import shutil
import sys
import tempfile

KILL_POINTS = ["pre-rfifind", "post-rfifind", "prepsubband-method",
               "post-prepsubband", "fused-chunk", "pre-sift",
               "post-sift", "fold-cand", "pre-singlepulse"]

COMPARABLE = (".dat", ".fft", ".cand", ".singlepulse", ".mask",
              ".stats", ".txt")


def _artifacts(workdir):
    out = {}
    for p in sorted(glob.glob(os.path.join(workdir, "*"))):
        name = os.path.basename(p)
        comparable = ((name.endswith(COMPARABLE)
                       or "_ACCEL_" in name)
                      and not name.endswith(".inf"))
        if os.path.isfile(p) and comparable:
            with open(p, "rb") as f:
                out[name] = f.read()
    return out


def _make_obs(root, nspec, nchan):
    from presto_tpu_torch.models.synth import FakeSignal, \
        fake_filterbank_file
    raw = os.path.join(root, "psr.fil")
    sig = FakeSignal(f=17.0, dm=10.0, shape="gauss", width=0.08,
                     amp=0.8)
    fake_filterbank_file(raw, nspec, 2e-4, nchan, 400.0, 1.0, sig,
                         noise_sigma=2.0, nbits=8)
    return raw


def _cfg(provider, fault_injector=None):
    from presto_tpu_torch.pipeline.survey import SurveyConfig
    return SurveyConfig(lodm=5.0, hidm=12.0, nsub=16, zmax=0,
                        numharm=2, sigma=3.0, fold_top=0,
                        rfi_time=0.4, singlepulse=True,
                        plan_provider=provider,
                        fault_injector=fault_injector)


def _corrupt_random_artifact(workdir, rng):
    """Truncate, bitflip, or delete one completed artifact."""
    from presto_tpu_torch.testing import chaos
    victims = [p for n, p in
               ((os.path.basename(p), p) for p in
                glob.glob(os.path.join(workdir, "*")))
               if n.endswith((".dat", ".fft")) or "_ACCEL_" in n]
    if not victims:
        return None
    victim = rng.choice(sorted(victims))
    op = rng.choice(["truncate", "bitflip", "delete"])
    if op == "truncate":
        chaos.truncate_file(victim, keep_frac=rng.uniform(0.1, 0.9))
    elif op == "bitflip":
        chaos.bitflip_file(victim, nflips=rng.randrange(1, 5),
                           seed=rng.randrange(1 << 30))
    else:
        os.remove(victim)
    return "%s %s" % (op, os.path.basename(victim))


def run_trial(trial, rng, raw, provider, ref_arts, root,
              device="cuda") -> dict:
    """One randomized schedule: {"trial", "schedule", "hits", "ok",
    "detail"}, ``hits`` naming each kill that fired (an injector that
    never matched its point lets the run complete; later kills in the
    schedule then exercise the no-op resume path)."""
    from presto_tpu_torch.pipeline.survey import run_survey
    from presto_tpu_torch.testing import chaos
    work = os.path.join(root, "trial%02d" % trial)
    os.makedirs(work, exist_ok=True)
    nkills = rng.randrange(1, 4)
    schedule, hits = [], []
    for k in range(nkills):
        kill_at = rng.choice(KILL_POINTS)
        kill_after = rng.randrange(1, 3)
        schedule.append("%s#%d" % (kill_at, kill_after))
        fi = chaos.FaultInjector(kill_at=kill_at,
                                 kill_after=kill_after)
        try:
            run_survey([raw], _cfg(provider, fi), workdir=work,
                       device=device)
        except chaos.SimulatedCrash:
            hits.append(schedule[-1])
            if rng.random() < 0.5:
                note = _corrupt_random_artifact(work, rng)
                if note:
                    schedule.append("corrupt:" + note)
    run_survey([raw], _cfg(provider), workdir=work, device=device)
    got = _artifacts(work)
    ok = got == ref_arts
    detail = ""
    if not ok:
        only_got = sorted(set(got) - set(ref_arts))
        only_ref = sorted(set(ref_arts) - set(got))
        differ = [n for n in ref_arts
                  if n in got and got[n] != ref_arts[n]]
        detail = " only-in-trial=%s only-in-ref=%s differ=%s" % (
            only_got[:5], only_ref[:5], differ[:5])
    print("trial %02d [%s]: %s%s"
          % (trial, " -> ".join(schedule),
             "PASS" if ok else "FAIL", detail))
    return {"trial": trial, "schedule": schedule, "hits": hits,
            "ok": ok, "detail": detail}


def reference(root, nspec, nchan, device="cuda"):
    """(raw, provider, reference artifacts): the observation, the plan
    cache every run shares, and the never-interrupted run's
    comparable artifacts."""
    from presto_tpu_torch.pipeline.survey import run_survey
    from presto_tpu_torch.serve.plancache import PlanCache, SearcherProvider
    provider = SearcherProvider(PlanCache(capacity=8), device=device)
    os.makedirs(root, exist_ok=True)
    raw = _make_obs(root, nspec, nchan)
    refdir = os.path.join(root, "reference")
    run_survey([raw], _cfg(provider), workdir=refdir, device=device)
    return raw, provider, _artifacts(refdir)


def build_parser():
    p = argparse.ArgumentParser(
        prog="chaos_survey",
        description="randomized kill/corruption schedules over a "
                    "tiny survey; asserts resume equivalence")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nspec", type=int, default=1 << 13)
    p.add_argument("--nchan", type=int, default=16)
    p.add_argument("--workdir", type=str, default=None,
                   help="Scratch root (default: a fresh temp dir)")
    p.add_argument("--keep", action="store_true",
                   help="Keep the scratch tree for inspection")
    p.add_argument("-device", "--device", type=str, default="cuda",
                   help="Device of every survey (default cuda; without "
                        "a card it raises)")
    return p


def run(args, device="cuda") -> list:
    """Every trial of ``args`` (build_parser's) on ``device``: the
    trials' records (run_trial's)."""
    root = args.workdir or tempfile.mkdtemp(prefix="chaos_survey_")
    os.makedirs(root, exist_ok=True)
    rng = random.Random(args.seed)
    print("chaos_survey: scratch=%s seed=%d trials=%d device=%s"
          % (root, args.seed, args.trials, device))
    raw, provider, ref_arts = reference(root, args.nspec, args.nchan,
                                        device)
    print("reference run: %d comparable artifacts" % len(ref_arts))
    trials = [run_trial(trial, rng, raw, provider, ref_arts, root,
                        device) for trial in range(args.trials)]
    if not args.keep and args.workdir is None:
        shutil.rmtree(root, ignore_errors=True)
    return trials


def main(argv=None) -> int:
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    trials = run(args, str(resolve_device(args.device)))
    passed = sum(1 for t in trials if t["ok"])
    print("chaos_survey: %d/%d trials passed" % (passed, len(trials)))
    return 0 if passed == len(trials) else 1


if __name__ == "__main__":
    sys.exit(main())
