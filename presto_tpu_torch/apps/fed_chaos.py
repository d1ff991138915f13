"""fed_chaos: whole-fleet kill driver for the port's federation front
door.

Counterpart of ``tools/fed_chaos.py``, with its flags, its reports'
keys and ``-device``.  Two REAL fleets — each its own fleet directory,
router process (``python -m presto_tpu_torch.serve.router``) and
replica process (``python -m presto_tpu_torch.apps.serve -device``) —
sit behind one federation router, and an ENTIRE fleet dies
mid-stream.  Whole-fleet death must look exactly like replica death
one level up:

  1. builds two fleets A and B and a federation driver over them; a
     burst of tiny-survey jobs is admitted through the federated front
     door, priced placement preferring fleet A (data locality);
  2. fleet A is killed at full SIGKILL fidelity in one of two modes:
       fleet-dead        — router AND replica die (the site is gone);
       partition-zombie  — the router dies but the replica is
                           SIGSTOPped, not killed: after the
                           federation has declared A dead, re-admitted
                           its placements, and landed them on B, the
                           replica is SIGCONTed and finishes its work
                           late — the textbook zombie fleet;
  3. the fleet liveness ledger reaps A (heartbeat + epoch fence), fires
     the registered kill points (fleet-dead / pre-readmit /
     post-readmit / zombie-fleet-commit), and re-places A's
     uncommitted items on B;
  4. the trial PASSES iff every federated item commits exactly once
     (zero lost), every committed result's artifact digests are
     byte-equal to a never-failed single-fleet reference, the epoch
     bumped, every item still open at the kill landed on the
     survivor, and — in zombie mode — the zombie's late commits are
     rejected by the fence with the journaled results left untouched.

``-verdict`` additionally runs the acceptance scenario of FED_r19.json:
a load spike on fleet A (tiny router high-water) spills admissions to
fleet B through the priced candidate walk, and the federated
observability folds must EQUAL the single-fleet computations (the /slo
burn-rate math on the merged usage windows, the /fleet/metrics fold
against one flat fleetagg merge of every replica snapshot).

Every replica and the reference survey run on ``-device`` (default
cuda; without a card it raises, nothing falls back); the zombie replica
SIGSTOPped in partition-zombie holds its CUDA context while it is
stopped.  The beams are apps/serve_loadgen.make_beams' (the JAX tool's
bytes).  Usage metering is always on in the port (serve/usage), so
nothing sets the JAX tool's ``PRESTO_TPU_USAGE``.

    python -m presto_tpu_torch.apps.fed_chaos -trials 2 -seed 19
    python -m presto_tpu_torch.apps.fed_chaos -trials 2 -verdict -commit

``-commit`` writes records/torch/FED_CHAOS.json of this checkout (and
records/torch/FED_r19.json with -verdict), never the JAX tool's records
at the repository's root; on a card each names it and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from presto_tpu_torch.apps.serve_loadgen import REPO, _subprocess_env

TINY_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
            "numharm": 2, "fold_top": 0, "singlepulse": False,
            "skip_rfifind": True, "durable_stages": True}

#: the two whole-fleet death modes a trial sweeps
KILL_MODES = ("fleet-dead", "partition-zombie")


def _wait(cond, timeout, poll=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str, timeout: float = 2.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


class SubFleet:
    """One real fleet: a router process + one replica process of the
    port on ``device`` over a shared fleet directory."""

    def __init__(self, base: str, name: str, high_water: int = 256,
                 slo: str = "", device="cuda"):
        self.name = name
        self.fleetdir = os.path.join(base, name, "fleet")
        os.makedirs(self.fleetdir, exist_ok=True)
        self.port = _free_port()
        self.url = "http://127.0.0.1:%d" % self.port
        self.high_water = high_water
        self.slo = slo
        self.device = str(device)
        self.logdir = os.path.join(base, name, "logs")
        os.makedirs(self.logdir, exist_ok=True)
        self.router = None
        self.replica = None

    def _spawn(self, tag, argv):
        with open(os.path.join(self.logdir, tag + ".log"), "ab") as log:
            return subprocess.Popen(argv, stdout=log, stderr=log,
                                    env=_subprocess_env(), cwd=REPO)

    def router_argv(self) -> list:
        argv = [sys.executable, "-m", "presto_tpu_torch.serve.router",
                "-fleetdir", self.fleetdir, "-host", "127.0.0.1",
                "-port", str(self.port), "-poll", "0.2",
                "-hb-timeout", "5", "-retry-after", "0.5",
                "-high-water", str(self.high_water), "-allow-empty"]
        for spec in ([self.slo] if self.slo else []):
            argv += ["-slo", spec]
        return argv

    def replica_argv(self) -> list:
        return [sys.executable, "-m", "presto_tpu_torch.apps.serve",
                "-fleet", self.fleetdir, "-replica", self.name + "-r1",
                "-host", "127.0.0.1", "-port", str(_free_port()),
                "-workdir", os.path.join(self.logdir, "work"),
                "-inflight", "1", "-depth", "64",
                "-hb-interval", "0.25", "-hb-timeout", "2.5",
                "-no-prewarm", "-device", self.device]

    def start(self, timeout: float = 120.0) -> "SubFleet":
        self.router = self._spawn("router", self.router_argv())
        self.replica = self._spawn("replica", self.replica_argv())

        def healthy():
            try:
                _get_json(self.url + "/healthz")
                return True
            except OSError:
                return False
        if not _wait(healthy, timeout, poll=0.25):
            raise RuntimeError("fleet %s router never came up "
                               "(see %s)" % (self.name, self.logdir))
        return self

    def kill(self, router=True, replica="kill") -> None:
        """Whole-fleet SIGKILL fidelity: no drain, no tombstone.
        replica="stop" SIGSTOPs it instead (the zombie half)."""
        if router and self.router is not None:
            self.router.kill()
        if self.replica is not None:
            if replica == "kill":
                self.replica.kill()
            elif replica == "stop":
                os.kill(self.replica.pid, signal.SIGSTOP)

    def resume_replica(self) -> None:
        if self.replica is not None:
            os.kill(self.replica.pid, signal.SIGCONT)

    def stop(self) -> None:
        for proc in (self.replica, self.router):
            if proc is None:
                continue
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=15.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
            proc.wait()


def committed_artifacts(fleets, res: dict) -> dict:
    """The survey-artifact digest table of one federated result: the
    committed result.json on whichever member fleet landed it (the
    ledger view's `artifacts` field is just the pointer to it)."""
    if not res:
        return {}
    by_name = {fl.name: fl for fl in fleets}
    fl = by_name.get(res.get("fleet"))
    if fl is None:
        return {}
    path = os.path.join(fl.fleetdir, "jobs", str(res.get("item")),
                        "result.json")
    try:
        with open(path) as f:
            return json.load(f).get("artifacts") or {}
    except (OSError, ValueError):
        return {}


#: the federation's wire timeout: a port router's first POST /submit
#: imports the survey's modules (~3.4 s on a CPU, past the JAX tool's
#: 2 s); a dead router refuses at once, so no reap waits on it
HTTP_TIMEOUT_S = 15.0


def make_fed(feddir, fleets, beamdir, injector=None, poll_s=0.25,
             hb_ttl=2.0):
    from presto_tpu_torch.serve.federation import (FederationConfig,
                                                   FederationRouter,
                                                   FleetMember)
    members = []
    for i, fl in enumerate(fleets):
        members.append(FleetMember(
            name=fl.name, fleetdir=fl.fleetdir, url=fl.url,
            data_roots=(beamdir,) if i == 0 else ()))
    cfg = FederationConfig(
        feddir=feddir, fleets=members, poll_s=poll_s,
        heartbeat_ttl=hb_ttl, http_timeout=HTTP_TIMEOUT_S,
        retry_after_s=0.5,
        fault_injector=injector)
    return FederationRouter(cfg)


def run_fed_trial(trial: int, rng: random.Random, beam: str,
                  ref: dict, workdir: str, jobs: int,
                  timeout: float, device="cuda") -> dict:
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.testing.chaos import FaultInjector

    mode = (KILL_MODES[trial % len(KILL_MODES)]
            if trial < 2 * len(KILL_MODES)
            else rng.choice(KILL_MODES))
    base = os.path.join(workdir, "trial%02d" % trial)
    rec = {"trial": trial, "mode": mode, "victim": "A", "ok": False,
           "checks": {}}
    fleet_a = SubFleet(base, "A", device=device)
    fleet_b = SubFleet(base, "B", device=device)
    fed = None
    injector = FaultInjector(mode="off")
    try:
        fleet_a.start()
        fleet_b.start()
        fed = make_fed(os.path.join(base, "fed"),
                       [fleet_a, fleet_b],
                       os.path.dirname(beam),
                       injector=injector).start()
        items = []
        for i in range(jobs):
            out = fed.submit({"job_id": "fj-%02d" % i,
                              "rawfiles": [beam],
                              "config": dict(TINY_CFG)})
            items.append(out["item"])
        placed_a = [i for i in items
                    if (fed.status(i) or {}).get("fleet") == "A"]
        rec["placed_on_victim"] = len(placed_a)
        rec["checks"]["victim_got_work"] = bool(placed_a)
        led_a = JobLedger(fleet_a.fleetdir)

        # wait for the victim's replica to actually hold a lease so
        # the kill lands mid-work, then kill the whole fleet
        def a_leasing():
            return any(r["state"] in ("leased", "done")
                       for r in led_a.read()["jobs"].values())
        _wait(a_leasing, timeout=timeout)
        open_at_kill = [i for i in items
                        if (fed.status(i) or {}).get("state")
                        != "done"]
        rec["open_at_kill"] = len(open_at_kill)
        if mode == "partition-zombie":
            fleet_a.kill(router=True, replica="stop")
        else:
            fleet_a.kill(router=True, replica="kill")

        # the liveness ledger must declare A dead and re-admit
        rec["checks"]["fleet_declared_dead"] = _wait(
            lambda: "A" not in fed.alive_fleets(), timeout=timeout)
        if mode == "partition-zombie":
            # only resume the zombie once failover has re-placed its
            # work — its commits are then LATE by construction
            _wait(lambda: int(fed.fedledger.read()["epoch"]) >= 1,
                  timeout=timeout)
            fleet_a.resume_replica()
        rec["checks"]["all_done"] = _wait(
            lambda: all((fed.status(i) or {}).get("state") == "done"
                        for i in items),
            timeout=timeout, poll=0.25)
        placements = fed.fedledger.placements()
        done = [i for i in items
                if placements.get(i, {}).get("state") == "done"]
        rec["checks"]["zero_lost"] = (sorted(done) == sorted(items))
        state = fed.fedledger.read()
        rec["epoch"] = int(state["epoch"])
        rec["checks"]["epoch_bumped"] = state["epoch"] >= 1
        rec["redos"] = {i: placements[i]["redos"]
                        for i in items if placements[i]["redos"]}
        readmits = int(fed.obs.metrics.get(
            "fed_readmits_total").value)
        rec["readmitted"] = readmits
        rec["checks"]["readmitted"] = (
            readmits >= len(open_at_kill) if open_at_kill
            else readmits >= 0)
        # byte-equality: every committed federated result carries the
        # reference artifact digests
        equal = True
        survivors_only = True
        for i in items:
            res = fed.result(i)
            if res is None:
                equal = False
                continue
            if committed_artifacts([fleet_a, fleet_b], res) != ref:
                equal = False
            if i in open_at_kill and res.get("fleet") != "B":
                survivors_only = False
        rec["checks"]["byte_equal_reference"] = equal
        rec["checks"]["open_work_landed_on_survivor"] = \
            survivors_only
        if mode == "partition-zombie":
            # the zombie's late commits all bounce off the fence,
            # leaving the journaled (survivor) results untouched
            def stale():
                return int(fed.obs.metrics.get(
                    "fed_stale_commits_total").value)
            rec["checks"]["zombie_commit_fenced"] = _wait(
                lambda: stale() >= 1, timeout=timeout, poll=0.25)
            rec["stale_rejected"] = stale()
            still_b = all(
                (fed.result(i) or {}).get("fleet") == "B"
                for i in open_at_kill)
            rec["checks"]["journal_untouched_by_zombie"] = still_b
        rec["points_seen"] = sorted(set(injector.points_seen))
        need = {"fleet-dead", "pre-readmit", "post-readmit"}
        if mode == "partition-zombie":
            need.add("zombie-fleet-commit")
        rec["checks"]["kill_points_fired"] = need <= set(
            injector.points_seen)
        rec["ok"] = all(rec["checks"].values())
    finally:
        if fed is not None:
            fed.stop()
        fleet_a.stop()
        fleet_b.stop()
    return rec


def run_verdict(rng: random.Random, beam: str, ref: dict,
                workdir: str, jobs: int, timeout: float,
                trials: list, device="cuda") -> dict:
    """The FED_r19 acceptance scenario: spill-over under a load spike +
    federated-fold equality, summarized with the chaos-trial outcomes
    into the verdict."""
    from presto_tpu_torch.obs import fleetagg, slo
    from presto_tpu_torch.serve.usage import UsageLedger

    base = os.path.join(workdir, "verdict")
    rec = {"issue": 19, "ok": False, "checks": {}}
    # fleet A sheds at 2 active jobs; B absorbs the spike
    fleet_a = SubFleet(base, "A", high_water=2, slo="default:0.95",
                       device=device)
    fleet_b = SubFleet(base, "B", high_water=256,
                       slo="default:0.95", device=device)
    fed = None
    try:
        fleet_a.start()
        fleet_b.start()
        fed = make_fed(os.path.join(base, "fed"),
                       [fleet_a, fleet_b],
                       os.path.dirname(beam)).start()
        items = []
        for i in range(jobs):
            out = fed.submit({"job_id": "sv-%02d" % i,
                              "rawfiles": [beam],
                              "config": dict(TINY_CFG)})
            items.append(out["item"])
        by_fleet = {}
        for i in items:
            fl = (fed.status(i) or {}).get("fleet")
            by_fleet[fl] = by_fleet.get(fl, 0) + 1
        rec["placements"] = by_fleet
        rec["checks"]["spilled_to_sibling"] = (
            by_fleet.get("B", 0) >= 1 and by_fleet.get("A", 0) >= 1)
        spills = int(fed.obs.metrics.get("fed_spills_total").value)
        rec["spill_events"] = spills
        rec["checks"]["spill_observed"] = spills >= 1
        rec["checks"]["all_done"] = _wait(
            lambda: all((fed.status(i) or {}).get("state") == "done"
                        for i in items),
            timeout=timeout, poll=0.25)
        equal = all(
            committed_artifacts([fleet_a, fleet_b], fed.result(i))
            == ref for i in items)
        rec["checks"]["byte_equal_reference"] = equal

        # federated burn-rate math == single-fleet computation on the
        # merged usage windows (the fold-equality acceptance row)
        now = time.time()
        fed_slo = fed.slo_view(now)
        specs = {s.tenant: s
                 for s in slo.load_specs(fleet_a.fleetdir)}
        all_rows = []
        for fl in (fleet_a, fleet_b):
            all_rows.extend(UsageLedger(fl.fleetdir).rows())
        flat = {t: slo.evaluate(s, all_rows, now)
                for t, s in sorted(specs.items())}
        rec["checks"]["burn_rate_fold_equal"] = (
            json.loads(json.dumps(fed_slo["tenants"]))
            == json.loads(json.dumps(flat)))
        rec["fed_slo_tenants"] = sorted(fed_slo["tenants"])

        # federated /fleet/metrics fold == one flat merge over every
        # replica snapshot of both fleets
        fed_metrics = fed.fed_metrics(now)["metrics"]
        flat_merge = {}
        for fl in (fleet_a, fleet_b):
            flat_merge = fleetagg.merge(
                flat_merge,
                fleetagg.aggregate(fl.fleetdir, now=now)["merged"])
        rec["checks"]["fleet_metrics_fold_equal"] = (
            fed_metrics == fleetagg.to_json(flat_merge))

        # the pricing table the placer routed on: per-fingerprint
        # device-second episodes, usage history, or the documented
        # uniform fallback
        pricing = fed.fleets_view(now)["pricing"]
        rec["pricing"] = [
            {"fleet": c["fleet"], "price_s": c["price_s"],
             "source": c["source"], "local": c["local"]}
            for c in pricing]
        rec["checks"]["pricing_sources_known"] = all(
            c["source"] in ("usage-bucket", "usage-median",
                            "perf-ledger", "uniform")
            for c in pricing)
        rec["trials_passed"] = sum(1 for t in trials if t["ok"])
        rec["trials_failed"] = sum(1 for t in trials if not t["ok"])
        rec["checks"]["chaos_trials_pass"] = (
            rec["trials_failed"] == 0 and bool(trials))
        rec["kill_points"] = sorted(
            {p for t in trials for p in t.get("points_seen", [])})
        rec["ok"] = all(rec["checks"].values())
    finally:
        if fed is not None:
            fed.stop()
        fleet_a.stop()
        fleet_b.stop()
    return rec


def reference(workdir, nsamp, nchan, device="cuda"):
    """(beam, digests): make_beams' first beam and the never-failed
    single-fleet reference's artifact digests (one plain survey)."""
    from presto_tpu_torch.apps.serve_loadgen import make_beams
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
    from presto_tpu_torch.serve.fleet import artifact_digests
    os.makedirs(workdir, exist_ok=True)
    beam = make_beams(workdir, 1, nsamp=nsamp, nchan=nchan)[0]
    refdir = os.path.join(workdir, "reference")
    run_survey([beam], SurveyConfig(**TINY_CFG), workdir=refdir,
               device=device)
    return beam, artifact_digests(refdir)


def build_parser():
    p = argparse.ArgumentParser(prog="fed_chaos")
    p.add_argument("-trials", type=int, default=2)
    p.add_argument("-jobs", type=int, default=3)
    p.add_argument("-seed", type=int, default=19)
    p.add_argument("-nsamp", type=int, default=4096)
    p.add_argument("-nchan", type=int, default=8)
    p.add_argument("-timeout", type=float, default=300.0)
    p.add_argument("-workdir", type=str, default=None)
    p.add_argument("-verdict", action="store_true",
                   help="Also run the spill-over + fold-equality "
                        "acceptance scenario (FED_r19.json with "
                        "-commit)")
    p.add_argument("-out", type=str, default=None)
    p.add_argument("-commit", action="store_true",
                   help="Write FED_CHAOS.json (+ FED_r19.json with "
                        "-verdict) to records/torch/ of this checkout")
    p.add_argument("--fast", action="store_true",
                   help="1 trial, CI smoke")
    p.add_argument("-device", "--device", type=str, default="cuda",
                   help="Device of every replica and the reference "
                        "(default cuda; without a card it raises)")
    return p


def run(args, workdir, device="cuda") -> tuple:
    """(report, verdict): the trials of ``args`` (build_parser's) on
    ``device`` and, with -verdict, the FED_r19 scenario (else None)."""
    rng = random.Random(args.seed)
    beam, ref = reference(workdir, args.nsamp, args.nchan, device)
    trials = []
    for t in range(args.trials):
        rec = run_fed_trial(t, rng, beam, ref, workdir, args.jobs,
                            args.timeout, device=device)
        print("fed_chaos: trial %d mode=%s readmitted=%s -> %s"
              % (t, rec["mode"], rec.get("readmitted"),
                 "PASS" if rec["ok"] else "FAIL"), flush=True)
        trials.append(rec)
    report = {
        "seed": args.seed,
        "jobs_per_trial": args.jobs,
        "beam": {"nsamp": args.nsamp, "nchan": args.nchan},
        "config": TINY_CFG,
        "kill_modes": list(KILL_MODES),
        "reference_artifacts": len(ref),
        "trials": trials,
        "passed": sum(1 for r in trials if r["ok"]),
        "failed": sum(1 for r in trials if not r["ok"]),
    }
    verdict = None
    if args.verdict:
        verdict = run_verdict(rng, beam, ref, workdir, args.jobs * 2,
                              args.timeout, trials, device=device)
        print("fed_chaos: verdict -> %s"
              % ("PASS" if verdict["ok"] else "FAIL"), flush=True)
    return report, verdict


def main(argv=None) -> int:
    from presto_tpu_torch.apps.serve_loadgen import card_line, \
        commit_report
    from presto_tpu_torch.io.atomic import atomic_write_text
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    if args.fast:
        args.trials = 1
    device = str(resolve_device(args.device))
    workdir = args.workdir or tempfile.mkdtemp(prefix="fed_chaos_")
    report, verdict = run(args, workdir, device)
    if device.startswith("cuda") and (args.out or args.commit):
        report["card"] = card_line()
    text = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        atomic_write_text(args.out, text + "\n")
        print("fed_chaos: report -> %s" % args.out)
    elif args.commit:
        print("fed_chaos: report -> %s"
              % commit_report(report, "FED_CHAOS.json"))
    else:
        print(text)
    rc = 0 if report["failed"] == 0 else 1
    if verdict is not None:
        if args.commit:
            if device.startswith("cuda"):
                verdict["card"] = report.get("card") or card_line()
            print("fed_chaos: verdict -> %s"
                  % commit_report(verdict, "FED_r19.json"))
        else:
            print(json.dumps(verdict, indent=1, sort_keys=True))
        rc = rc or (0 if verdict["ok"] else 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
