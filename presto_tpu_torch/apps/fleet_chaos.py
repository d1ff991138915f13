"""fleet_chaos: randomized replica-kill driver for the port's fleet.

Counterpart of ``tools/fleet_chaos.py``, with its four modes, its flags,
its reports' keys and ``-device``.  Kill a replica mid-batch and every
leased job must be re-admitted and complete **exactly once**, with
artifacts byte-equal to a never-failed run.  Each classic trial here:

  1. builds a fresh fleet directory and admits J identical tiny-survey
     jobs to the ledger;
  2. starts N replicas; one randomly chosen *victim* is killed at a
     randomized point (right after leasing, right after enqueuing its
     lease — leaving a zombie survey running — or at a random wall-
     clock delay), exactly the way `kill -9` dies: heartbeats stop,
     leases stay claimed;
  3. survivors reap, re-admit, and finish everything;
  4. the trial PASSES iff every job is ledger-done (zero lost), every
     committed result's artifact digests are byte-equal to the
     reference run, and — when the schedule produced a zombie — its
     late commit is rejected by the epoch fence with the journaled
     result left untouched.

``-dag`` runs kill-one trials over whole discovery DAGs (search -> sift
-> fold fan-out -> timing) at DAG-aware kill points (fold-fanout,
post-sift-commit, mid-fold, mid-triage, timed): every node runs exactly
once, the fold set exists exactly once, and the sifted list, .pfd,
.bestprof and toas.tim are byte-equal to a never-failed reference
(the port's run_survey, sift, apps/prepfold.fold_dat_cands and
apps/get_toas.toa_lines).  ``-supervisor`` appends the supervised-fleet
trial: SIGKILL a supervisor-spawned replica process (``python -m
presto_tpu_torch.apps.serve -fleet ... -device``) mid-batch, then kill
the supervisor itself and restart it (adoption, no orphans).
``-campaign`` crashes the campaign driver at a randomized seam of its
admit-mark-then-admit_dag protocol and kills a replica mid-campaign;
the finished campaign must equal an undisturbed sequential run.

Every service, replica and reference runs on ``-device`` (default cuda;
without a card it raises, nothing falls back): in-process replicas as
``SearchService(device=)``, supervised replicas through
``SupervisorConfig.device``.  The beams are apps/serve_loadgen
.make_beams' (the JAX tool's bytes).  The ``timed`` kill delays are the
JAX tool's, drawn for its host's job times: on a card the work may be
done before the kill lands, which the trial's checks then show.  Usage
metering is always on in the port (serve/usage), so nothing sets the
JAX tool's ``PRESTO_TPU_USAGE``.

    python -m presto_tpu_torch.apps.fleet_chaos -trials 3 -seed 9
    python -m presto_tpu_torch.apps.fleet_chaos -trials 3 -supervisor -commit
    python -m presto_tpu_torch.apps.fleet_chaos -trials 3 -dag -commit
    python -m presto_tpu_torch.apps.fleet_chaos -trials 3 -campaign -commit

``-commit`` writes the report to records/torch/FLEET_CHAOS.json of this
checkout (DAG_CHAOS.json with -dag, CAMPAIGN_CHAOS.json with
-campaign), never the JAX tool's records at the repository's root; on
a card the report names it and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time

TINY_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
            "numharm": 2, "fold_top": 0, "singlepulse": False,
            "skip_rfifind": True, "durable_stages": True}

#: "batch-leased" fires while the victim holds a whole same-bucket
#: batch claimed in one lease_batch transaction: the reaper must
#: re-admit every member and the survivors complete each exactly once.
KILL_POINTS = ("job-leased", "job-enqueued", "batch-leased", "timed")

#: DAG-aware kill points (-dag): "fold-fanout" dies with the sift's
#: fan-out computed but UNcommitted (the expand is lost with the
#: attempt; a survivor redoes the sift and expands identically),
#: "post-sift-commit" dies right after the fenced expand landed,
#: "mid-fold" dies holding a leased fold job, "mid-triage" dies
#: holding a leased triage node before its score+fan-out commits (a
#: survivor re-scores with the seeded model and expands identically).
DAG_KILL_POINTS = ("fold-fanout", "post-sift-commit", "mid-fold",
                   "mid-triage", "timed")

#: DAG trial search config (needs a sift-surviving candidate, so the
#: beam is longer/stronger than the classic trials')
DAG_CFG = {"lodm": 50.0, "hidm": 60.0, "nsub": 8, "zmax": 0,
           "numharm": 4, "singlepulse": False, "skip_rfifind": True}

#: campaign driver crash seams (-campaign): the driver dies at the
#: worst instants of the admit-mark-then-admit_dag protocol —
#: "wave-admit" after the durable ``admitting`` mark but before the
#: DAG lands, "mid-wave" between two admissions of one wave,
#: "pre-count-commit" inside settle before the count commits.  Every
#: trial ALSO loses a replica mid-campaign to a SIGKILL-equivalent
#: death with a replacement riding in.
CAMPAIGN_KILL_POINTS = ("wave-admit", "mid-wave", "pre-count-commit")

#: each mode's report name under records/torch with -commit
REPORTS = {"classic": "FLEET_CHAOS.json", "dag": "DAG_CHAOS.json",
           "campaign": "CAMPAIGN_CHAOS.json"}


def _wait(cond, timeout, poll=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def _usage_once(rows, done) -> bool:
    """Every done job has exactly one committed (done) usage row."""
    per_job = {}
    for r in rows:
        if r.get("state") == "done":
            per_job[r["job_id"]] = per_job.get(r["job_id"], 0) + 1
    return (sorted(per_job) == sorted(done)
            and all(n == 1 for n in per_job.values()))


def _dump_checks(rec, fleetdir, replica, kill_point) -> None:
    """The kill left a post-mortem the fleet report can pick up: a
    flightrec dump under <fleet>/obs/<victim>/ whose last chaos record
    names the fired kill point (recorded before the kill)."""
    from presto_tpu_torch.obs import fleetagg
    from presto_tpu_torch.obs.flightrec import find_dumps
    dumps = find_dumps(fleetagg.replica_dump_dir(fleetdir, replica))
    rec["checks"]["flightrec_dump"] = bool(dumps)
    if dumps and kill_point != "timed":
        with open(dumps[-1]) as f:
            d = json.load(f)
        points = [r for r in d.get("records", [])
                  if r.get("kind") == "fleet-chaos-point"]
        rec["checks"]["dump_names_kill_point"] = bool(
            points and points[-1].get("point") == kill_point)


def _result(fleetdir, jid) -> dict:
    with open(os.path.join(fleetdir, "jobs", jid, "result.json")) as f:
        return json.load(f)


def _committed_file(fleetdir, jid, name) -> bytes:
    p = os.path.join(fleetdir, "jobs", jid,
                     _result(fleetdir, jid)["attempt_dir"], name)
    with open(p, "rb") as f:
        return f.read()


def run_trial(trial: int, rng: random.Random, beam: str, ref: dict,
              workdir: str, replicas: int, jobs: int,
              timeout: float, lease_batch: int = 2,
              device="cuda") -> dict:
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.queue import JobStatus
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.serve.usage import UsageLedger

    fleetdir = os.path.join(workdir, "trial%02d" % trial, "fleet")
    led = JobLedger(fleetdir)
    for _ in range(jobs):
        # one shared bucket hint: lease_batch may claim whole batches
        led.admit({"rawfiles": [beam], "config": dict(TINY_CFG)},
                  bucket="chaos-bucket")
    kill_point = rng.choice(KILL_POINTS)
    kill_delay = rng.uniform(0.2, 2.0)
    victim_idx = rng.randrange(replicas)
    rec = {"trial": trial, "kill_point": kill_point,
           "victim": "rep%d" % victim_idx,
           "kill_delay_s": round(kill_delay, 3), "ok": False,
           "checks": {}}
    members = []
    try:
        for i in range(replicas):
            svc = SearchService(
                os.path.join(workdir, "trial%02d" % trial,
                             "rep%d" % i),
                queue_depth=max(8, jobs + 2), device=device).start()
            cfg = FleetConfig(fleetdir=fleetdir,
                              replica="rep%d" % i,
                              lease_ttl=30.0, heartbeat_s=0.1,
                              heartbeat_timeout=0.8, poll_s=0.05,
                              max_inflight=max(
                                  1, lease_batch
                                  if kill_point == "batch-leased"
                                  else 1),
                              lease_batch=lease_batch,
                              prewarm=False)
            rep = FleetReplica(svc, cfg)
            if i == victim_idx and kill_point != "timed":
                rep.kill_on = kill_point
            members.append((svc, rep))
        # victim first so it reliably gets a lease before the pack
        victim_svc, victim = members[victim_idx]
        victim.start()
        if kill_point == "timed":
            time.sleep(kill_delay)
            victim.kill()
        else:
            _wait(lambda: victim._killed, timeout=30.0)
        rec["checks"]["victim_killed"] = bool(victim._killed)
        zombies = dict(victim._inflight)
        rec["zombie_jobs"] = sorted(zombies)
        for i, (svc, rep) in enumerate(members):
            if i != victim_idx:
                rep.start()
        ok_all = _wait(led.all_terminal, timeout=timeout)
        rec["checks"]["all_terminal"] = ok_all
        state = led.read()
        done = [j for j, r in state["jobs"].items()
                if r["state"] == "done"]
        rec["checks"]["zero_lost"] = (len(done) == jobs)
        rec["epoch"] = int(state["epoch"])
        rec["redos"] = {j: r["redos"]
                        for j, r in state["jobs"].items()
                        if r["redos"]}
        # byte-equality of every committed result vs the reference
        rec["checks"]["byte_equal_reference"] = all(
            _result(fleetdir, jid)["artifacts"] == ref for jid in done)
        # zombie fence: its survey finishes on the victim's still-
        # running scheduler; the late commit must bounce off the
        # epoch fence without touching the journaled result
        fence_ok = True
        for jid, (lease, job) in zombies.items():
            if not _wait(lambda: job.status in JobStatus.TERMINAL,
                         timeout=timeout):
                fence_ok = False
                continue
            final = os.path.join(fleetdir, "jobs", jid,
                                 "result.json")
            with open(final, "rb") as f:
                before = f.read()
            if victim._commit(lease, job) is not False:
                fence_ok = False
            with open(final, "rb") as f:
                if f.read() != before:
                    fence_ok = False
        rec["checks"]["zombie_commit_fenced"] = fence_ok
        rec["stale_rejected"] = int(victim_svc.obs.metrics.get(
            "fleet_stale_results_total").value)
        # usage-ledger exactly-once: every done job has EXACTLY one
        # committed usage row — the fenced zombie never metered — and
        # the device-seconds are the very floats the replicas'
        # job_e2e_seconds execute-phase histograms hold
        usage_done = [r for r in UsageLedger(fleetdir).raw_rows()
                      if r.get("state") == "done"]
        rec["checks"]["usage_exactly_once"] = _usage_once(usage_done,
                                                          done)
        fleet_exec = []
        for svc, _rep in members:
            fam = svc.obs.metrics.get("job_e2e_seconds")
            for labels, child in (fam.children() if fam else ()):
                if dict(labels).get("phase") == "execute":
                    fleet_exec.extend(child.samples())
        usage_exec = sorted(float(r["phases"].get("execute") or 0.0)
                            for r in usage_done)
        rec["checks"]["usage_matches_execute_total"] = (
            usage_exec == sorted(fleet_exec))
        rec["device_seconds"] = round(sum(usage_exec), 6)
        _dump_checks(rec, fleetdir, victim.replica, kill_point)
        rec["ok"] = all(rec["checks"].values())
    finally:
        for svc, rep in members:
            rep.stop()
            svc.stop()
    return rec


def _pid_alive(pid) -> bool:
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
        return True
    except OSError:
        return False


def run_supervisor_trial(rng: random.Random, beam: str, ref: dict,
                         workdir: str, jobs: int,
                         timeout: float, device="cuda") -> dict:
    """The supervised-fleet kill trial: real replica processes of the
    port under a FleetSupervisor, on ``device``.

      1. the supervisor brings up 2 replicas from the registry floor;
      2. one replica is SIGKILL'd mid-batch (a lease held); the
         supervisor replaces it outside the hysteresis/cooldown gates
         and the lease reaper re-admits — every job still commits
         exactly once, byte-equal to the never-failed reference;
      3. the supervisor itself then dies abruptly (loop stops, no
         graceful stop event): the fleet degrades to advisory-only —
         a second wave of jobs admitted with NO supervisor running
         still completes;
      4. a restarted supervisor adopts every surviving replica from
         the persisted registry without spawning duplicates — no
         orphans, no double-supervision.
    """
    import signal as _sig
    from presto_tpu_torch.serve import supervisor as suplib
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http as router_http)
    from presto_tpu_torch.serve.supervisor import (FleetSupervisor,
                                                   SupervisorConfig, UP,
                                                   load_registry)
    from presto_tpu_torch.serve.usage import UsageLedger

    suplib.check_replica_device(str(device))
    base = os.path.join(workdir, "suptrial")
    fleetdir = os.path.join(base, "fleet")
    led = JobLedger(fleetdir)
    wave1 = [led.admit({"rawfiles": [beam],
                        "config": dict(TINY_CFG)},
                       bucket="chaos-bucket")["job_id"]
             for _ in range(jobs)]
    rec = {"mode": "supervisor", "ok": False, "checks": {}}
    router = FleetRouter(RouterConfig(
        fleetdir=fleetdir, high_water=256, poll_s=0.2,
        heartbeat_timeout=5.0)).start()
    rhttpd = router_http(router)
    url = "http://%s:%d" % rhttpd.server_address[:2]

    def mkcfg():
        return SupervisorConfig(
            fleetdir=fleetdir, router_url=url, poll_s=0.2,
            scale_up_after=1, scale_down_after=4, cooldown_s=0.5,
            min_replicas=2, max_replicas=2, drain_timeout_s=90.0,
            spawn_timeout_s=240.0, heartbeat_timeout=6.0,
            hb_interval=0.25, hb_timeout=2.5,
            replica_args=["-inflight", "1",
                          "-depth", str(max(8, 2 * jobs + 2))],
            device=str(device))

    sup = FleetSupervisor(mkcfg())
    sup2 = None
    try:
        sup.start()
        rec["checks"]["replicas_up"] = _wait(
            lambda: sorted(r["state"]
                           for r in sup.replicas().values())
            == [UP, UP], timeout=timeout, poll=0.2)

        # mid-batch: wait for a supervised replica to hold a lease,
        # then SIGKILL its process the way a VM dies
        def lease_holder():
            st = led.read()
            for row in st["jobs"].values():
                if row["state"] == "leased" and row.get("owner"):
                    pid = (sup.replicas()
                           .get(row["owner"], {}).get("pid"))
                    if pid:
                        return row["owner"], pid
            return None
        rec["checks"]["victim_leased"] = _wait(
            lambda: lease_holder() is not None, timeout=timeout,
            poll=0.1)
        victim, vpid = lease_holder() or ("?", 0)
        rec["victim"] = victim
        if vpid:
            os.kill(vpid, _sig.SIGKILL)
        rec["checks"]["victim_killed"] = _wait(
            lambda: not _pid_alive(vpid), timeout=30.0)

        # the supervisor must replace the dead replica (repair
        # bypasses hysteresis/cooldown) and bring the fleet back to 2
        rec["checks"]["victim_replaced"] = _wait(
            lambda: victim not in sup.replicas()
            and sorted(r["state"]
                       for r in sup.replicas().values())
            == [UP, UP], timeout=timeout, poll=0.2)

        # abrupt supervisor death: the loop just stops — no graceful
        # stop event, no drain.  Replicas are real processes and keep
        # leasing: the fleet degrades to exactly the advisory-only
        # behavior, so a second wave admitted now still completes.
        sup._stop.set()
        if sup._loop_t is not None:
            sup._loop_t.join(timeout=10.0)
        wave2 = [led.admit({"rawfiles": [beam],
                            "config": dict(TINY_CFG)},
                           bucket="chaos-bucket")["job_id"]
                 for _ in range(jobs)]
        rec["checks"]["all_terminal"] = _wait(
            led.all_terminal, timeout=timeout, poll=0.2)
        state = led.read()
        done = [j for j, r in state["jobs"].items()
                if r["state"] == "done"]
        rec["checks"]["zero_lost"] = (
            sorted(done) == sorted(wave1 + wave2))
        rec["redos"] = {j: r["redos"]
                        for j, r in state["jobs"].items()
                        if r["redos"]}
        rec["checks"]["byte_equal_reference"] = all(
            _result(fleetdir, jid)["artifacts"] == ref for jid in done)
        rec["checks"]["usage_exactly_once"] = _usage_once(
            UsageLedger(fleetdir).raw_rows(), done)

        # restart: the new supervisor adopts every survivor from the
        # persisted registry — nothing spawned anew, no orphans
        before = {n: r.get("pid")
                  for n, r in load_registry(fleetdir)
                  ["replicas"].items()}
        sup2 = FleetSupervisor(mkcfg())
        adopted = sup2.adopt()
        rec["adopted"] = sorted(adopted)
        after = {n: r.get("pid") for n, r in
                 sup2.replicas().items()}
        rec["checks"]["adopt_no_orphans"] = (
            sorted(adopted) == sorted(before)
            and after == before
            and all(_pid_alive(p) for p in after.values()))
        rec["ok"] = all(rec["checks"].values())
    finally:
        teardown = sup2 or sup
        teardown.drain_all(timeout=90.0)
        sup.stop()
        if sup2 is not None:
            sup2.stop()
        rhttpd.shutdown()
        router.stop()
    return rec


def make_dag_beam(workdir: str) -> str:
    """One strong synthetic beam whose injected pulsar survives the
    sift (the DAG trial's fan-out must be non-empty)."""
    from presto_tpu_torch.models.synth import FakeSignal, \
        fake_filterbank_file
    path = os.path.join(workdir, "dagbeam", "beam.fil")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sig = FakeSignal(f=23.0, dm=55.0, shape="gauss", width=0.08,
                     amp=2.0)
    fake_filterbank_file(path, 16384, 5e-4, 8, 400.0, 1.0, sig,
                         noise_sigma=2.0, nbits=8, seed=101)
    return path


def _sift(refdir, accs):
    """The DAG sift node's policy (min 2 DM hits, low-DM cutoff 2) over
    ``accs``, written to refdir/cands_sifted.txt."""
    from presto_tpu_torch.pipeline.sifting import sift_candidates
    cl = sift_candidates(accs, numdms_min=2, low_DM_cutoff=2.0)
    cl.to_file(os.path.join(refdir, "cands_sifted.txt"))
    return cl


def dag_reference(beam: str, workdir: str, device="cuda") -> dict:
    """The never-failed reference for DAG trials: the hand-driven
    sequence (search stages -> sift -> per-candidate folds -> TOAs)
    through the same library entry points the CLIs wrap, on
    ``device``.  Returns {relative artifact name: bytes}."""
    import glob as _glob
    from presto_tpu_torch.apps.get_toas import toa_lines
    from presto_tpu_torch.apps.prepfold import DatFoldSpec, fold_dat_cands
    from presto_tpu_torch.pipeline.sifting import select_fold_candidates
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
    refdir = os.path.join(workdir, "dag-reference")
    run_survey([beam], SurveyConfig(**dict(DAG_CFG, fold_top=0,
                                           durable_stages=True)),
               workdir=refdir, device=device)
    cl = _sift(refdir, sorted(_glob.glob(os.path.join(refdir,
                                                     "*_ACCEL_0"))))
    top = select_fold_candidates(cl, fold_top=3)
    specs = []
    for i, c in enumerate(top):
        accpath = os.path.join(c.path or refdir, c.filename)
        specs.append(DatFoldSpec(
            datfile=accpath.split("_ACCEL_")[0] + ".dat",
            accelfile=accpath + ".cand", candnum=c.candnum,
            outbase=os.path.join(refdir, "fold_cand%d" % (i + 1)),
            dm=c.DM))
    fold_dat_cands(specs, device=device)
    pfds = [s.outbase + ".pfd" for s in specs]
    with open(os.path.join(refdir, "toas.tim"), "w") as f:
        f.write("\n".join(toa_lines(pfds, ntoa=1, device=device)) + "\n")
    out = {}
    for name in (["cands_sifted.txt", "toas.tim"]
                 + ["fold_cand%d.pfd" % (i + 1)
                    for i in range(len(specs))]
                 + ["fold_cand%d.pfd.bestprof" % (i + 1)
                    for i in range(len(specs))]):
        with open(os.path.join(refdir, name), "rb") as f:
            out[name] = f.read()
    return out


def run_dag_trial(trial: int, rng: random.Random, beam: str,
                  ref: dict, workdir: str, replicas: int,
                  timeout: float, device="cuda") -> dict:
    """One DAG kill-one trial: admit a whole discovery DAG, kill the
    victim at a DAG-aware point, let survivors finish, and check
    exactly-once + single-fan-out + byte-equality to the
    never-failed reference."""
    from presto_tpu_torch.serve.dag import plan_dag
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.server import SearchService

    fleetdir = os.path.join(workdir, "dagtrial%02d" % trial, "fleet")
    led = JobLedger(fleetdir)
    # first len(DAG_KILL_POINTS) trials sweep every point once; extra
    # trials randomize
    kill_point = (DAG_KILL_POINTS[trial % len(DAG_KILL_POINTS)]
                  if trial < len(DAG_KILL_POINTS)
                  else rng.choice(DAG_KILL_POINTS))
    payload = {"rawfiles": [beam], "config": dict(DAG_CFG),
               "sift": {"min_dm_hits": 2, "low_dm_cutoff": 2.0},
               "fold": {"fold_top": 3}, "toa": {"ntoa": 1}}
    if kill_point == "mid-triage":
        # the seam only exists on a triage-bearing DAG; pointing at a
        # weights file that cannot exist pins the node to its
        # heuristic degrade, so the byte-equality reference holds no
        # matter what lives in the user's weights cache
        payload["triage"] = {"weights": os.path.join(
            fleetdir, "no-such-weights.json")}
    out = led.admit_dag(plan_dag(payload))
    kill_delay = rng.uniform(0.5, 4.0)
    victim_idx = rng.randrange(replicas)
    rec = {"trial": trial, "mode": "dag", "kill_point": kill_point,
           "victim": "rep%d" % victim_idx, "dag": out["dag_id"],
           "kill_delay_s": round(kill_delay, 3), "ok": False,
           "checks": {}}
    members = []
    try:
        for i in range(replicas):
            svc = SearchService(
                os.path.join(workdir, "dagtrial%02d" % trial,
                             "rep%d" % i), queue_depth=8,
                device=device).start()
            cfg = FleetConfig(fleetdir=fleetdir,
                              replica="rep%d" % i, lease_ttl=30.0,
                              heartbeat_s=0.1, heartbeat_timeout=0.8,
                              poll_s=0.05, max_inflight=2,
                              prewarm=False)
            rep = FleetReplica(svc, cfg)
            if i == victim_idx and kill_point != "timed":
                rep.kill_on = kill_point
            members.append((svc, rep))
        victim_svc, victim = members[victim_idx]
        victim.start()
        if kill_point == "timed":
            time.sleep(kill_delay)
            victim.kill()
        else:
            _wait(lambda: victim._killed, timeout=timeout)
        rec["checks"]["victim_killed"] = bool(victim._killed)
        for i, (svc, rep) in enumerate(members):
            if i != victim_idx:
                rep.start()
        ok_all = _wait(led.all_terminal, timeout=timeout)
        rec["checks"]["all_terminal"] = ok_all
        dv = led.dag_view(out["dag_id"])
        rec["node_counts"] = dv["counts"]
        rec["checks"]["dag_done"] = (dv["state"] == "done")
        fold_ids = sorted(j for j in dv["nodes"] if "-fold-" in j)
        rec["folds"] = len(fold_ids)
        # the fan-out exists exactly once (sequential ids, one set)
        rec["checks"]["single_fanout"] = fold_ids == [
            "%s-fold-%03d" % (out["dag_id"], i + 1)
            for i in range(len(fold_ids))]
        rec["redos"] = {j: r["redos"] for j, r in
                        led.read()["jobs"].items() if r["redos"]}
        equal = True
        try:
            if _committed_file(fleetdir, out["nodes"]["sift"],
                               "cands_sifted.txt") != \
                    ref["cands_sifted.txt"]:
                equal = False
            for i, fid in enumerate(fold_ids):
                for suffix in (".pfd", ".pfd.bestprof"):
                    if _committed_file(fleetdir, fid, "fold_cand%d%s"
                                       % (i + 1, suffix)) != \
                            ref["fold_cand%d%s" % (i + 1, suffix)]:
                        equal = False
            if _committed_file(fleetdir, out["nodes"]["toa"],
                               "toas.tim") != ref["toas.tim"]:
                equal = False
        except (OSError, ValueError, KeyError):
            equal = False
        rec["checks"]["byte_equal_reference"] = equal
        # the DAG-aware kill left a fleet-report-visible post-mortem
        # naming the fired point (fold-fanout and friends)
        _dump_checks(rec, fleetdir, victim.replica, kill_point)
        rec["ok"] = all(rec["checks"].values())
    finally:
        for svc, rep in members:
            rep.stop()
            svc.stop()
    return rec


def run_campaign_trial(trial: int, rng: random.Random, beam: str,
                       ref: dict, ref_sift: bytes, workdir: str,
                       replicas: int, observations: int,
                       timeout: float, device="cuda") -> dict:
    """One campaign churn trial: admit an archive of observations
    through the campaign driver, crash the driver at a randomized
    ledger seam mid-campaign AND kill a replica holding campaign
    leases (replacement spawned), resume crash-only from the ledger,
    and check that the finished campaign is indistinguishable from an
    undisturbed sequential run: every observation done, every DAG
    node admitted and metered exactly once, search artifacts and the
    sifted candidate list byte-equal to the reference."""
    from presto_tpu_torch.serve.campaign import (CampaignConfig,
                                                 CampaignDriver,
                                                 SimulatedCrash,
                                                 events_path)
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.server import SearchService

    base = os.path.join(workdir, "camptrial%02d" % trial)
    fleetdir = os.path.join(base, "fleet")
    cid = "camp"
    wave = 2

    class CrashOnce(CampaignDriver):
        def __init__(self, cfg, crash_at, skip):
            super().__init__(cfg)
            self.crash_at, self.skip = crash_at, skip

        def _seam(self, point):
            if point == self.crash_at:
                if self.skip > 0:
                    self.skip -= 1
                    return
                self.crash_at = None
                raise SimulatedCrash(point)

    crash_point = (CAMPAIGN_KILL_POINTS[trial
                                        % len(CAMPAIGN_KILL_POINTS)]
                   if trial < len(CAMPAIGN_KILL_POINTS)
                   else rng.choice(CAMPAIGN_KILL_POINTS))
    skip = rng.randrange(0, 2)
    kill_delay = rng.uniform(0.5, 3.0)
    victim_idx = rng.randrange(replicas)
    rec = {"trial": trial, "mode": "campaign",
           "crash_point": crash_point, "crash_skip": skip,
           "victim": "rep%d" % victim_idx,
           "kill_delay_s": round(kill_delay, 3), "ok": False,
           "checks": {}}
    manifest = [{"id": "obs-%03d" % i, "rawfiles": [beam],
                 "config": dict(TINY_CFG),
                 "sift": {"min_dm_hits": 2, "low_dm_cutoff": 2.0},
                 "toa": {"ntoa": 1}}
                for i in range(observations)]

    def mkcfg():
        return CampaignConfig(fleetdir=fleetdir, campaign_id=cid,
                              wave_size=wave)

    def mkfleet(name):
        svc = SearchService(os.path.join(base, name), queue_depth=8,
                            device=device).start()
        rep = FleetReplica(svc, FleetConfig(
            fleetdir=fleetdir, replica=name, lease_ttl=30.0,
            heartbeat_s=0.1, heartbeat_timeout=0.8, poll_s=0.05,
            max_inflight=1, prewarm=False))
        return svc, rep

    members = []
    drv = CrashOnce(mkcfg(), crash_point, skip)
    try:
        drv.create(manifest)
        for i in range(replicas):
            members.append(mkfleet("rep%d" % i))
        for _svc, rep in members:
            rep.start()
        victim = members[victim_idx][1]
        crashes = 0
        killed = False
        max_out = 0
        st = drv.status()
        kill_at = time.time() + kill_delay
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not killed and time.time() >= kill_at:
                # SIGKILL-equivalent replica death: heartbeats stop,
                # leases stay claimed; a replacement rides in the way
                # the supervisor's preempt pacer replaces capacity
                victim.kill()
                killed = True
                members.append(mkfleet("rep-replace"))
                members[-1][1].start()
            try:
                st = drv.pulse()
            except SimulatedCrash:
                crashes += 1
                drv.close()
                # crash-only restart: a fresh driver, the durable
                # ledger is the whole handoff
                drv = CampaignDriver(mkcfg())
                drv.resume()
                continue
            max_out = max(max_out, st["outstanding"])
            if st["state"] != "running":
                break
            time.sleep(0.2)
        rec["crashes"] = crashes
        rec["waves"] = st["waves"]
        rec["counts"] = st["counts"]
        rec["checks"]["driver_crashed"] = crashes >= 1
        rec["checks"]["victim_killed"] = killed
        rec["checks"]["campaign_done"] = (st["state"] == "done")
        rec["checks"]["zero_lost"] = (
            st["counts"]["done"] == observations
            and st["counts"]["failed"] == 0)
        rec["checks"]["wave_bound_held"] = (max_out <= wave)
        led = JobLedger(fleetdir)
        jobs = led.read()["jobs"]
        done = [j for j, r in jobs.items() if r["state"] == "done"]
        # the crash matrix never double-admits: 3 nodes per
        # observation (search -> sift -> toa), each exactly once
        rec["checks"]["single_admission"] = (
            len(jobs) == 3 * observations
            and sorted(done) == sorted(jobs))
        rec["checks"]["usage_exactly_once"] = _usage_once(
            led.usage.raw_rows(), done)
        rec["device_seconds"] = round(
            sum(float(r["phases"].get("execute") or 0.0)
                for r in led.usage.rows()
                if r.get("state") == "done"), 6)
        rec["redos"] = {j: r["redos"] for j, r in jobs.items()
                        if r["redos"]}
        equal = True
        try:
            for i in range(observations):
                dag = "%s.obs-%03d" % (cid, i)
                if _result(fleetdir, dag + "-search")["artifacts"] \
                        != ref:
                    equal = False
                if _committed_file(fleetdir, dag + "-sift",
                                   "cands_sifted.txt") != ref_sift:
                    equal = False
        except (OSError, ValueError, KeyError):
            equal = False
        rec["checks"]["byte_equal_reference"] = equal
        # the whole disturbed episode reconstructs from the durable
        # campaign event journal alone
        kinds = {}
        try:
            with open(events_path(fleetdir, cid)) as f:
                for ln in f:
                    if ln.strip():
                        k = json.loads(ln)["kind"]
                        kinds[k] = kinds.get(k, 0) + 1
        except OSError:
            pass
        rec["events_by_kind"] = kinds
        rec["checks"]["episode_reconstructable"] = (
            kinds.get("campaign-create", 0) == 1
            and kinds.get("campaign-resume", 0) == crashes
            and kinds.get("campaign-obs-done", 0) == observations
            and kinds.get("campaign-complete", 0) >= 1)
        rec["ok"] = all(rec["checks"].values())
    finally:
        drv.close()
        for svc, rep in members:
            rep.stop()
            svc.stop()
    return rec


def classic_reference(workdir, nsamp, nchan, device="cuda"):
    """(beam, reference digests): make_beams' first beam and the
    never-failed batch-driver run's artifact digests (the classic,
    supervisor and campaign trials' reference)."""
    from presto_tpu_torch.apps.serve_loadgen import make_beams
    from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
    from presto_tpu_torch.serve.fleet import artifact_digests
    os.makedirs(workdir, exist_ok=True)
    beam = make_beams(workdir, 1, nsamp=nsamp, nchan=nchan)[0]
    refdir = os.path.join(workdir, "reference")
    run_survey([beam], SurveyConfig(**TINY_CFG), workdir=refdir,
               device=device)
    return beam, artifact_digests(refdir)


def _report(mode, args, trials, extra) -> dict:
    return dict(extra, seed=args.seed, replicas=args.replicas,
                trials=trials,
                passed=sum(1 for r in trials if r["ok"]),
                failed=sum(1 for r in trials if not r["ok"]),
                **({"mode": mode} if mode != "classic" else {}))


def run_mode(args, workdir, device) -> tuple:
    """(mode, report) of the mode ``args`` select, on ``device``."""
    rng = random.Random(args.seed)
    trials = []
    if args.dag:
        beam = make_dag_beam(workdir)
        ref = dag_reference(beam, workdir, device=device)
        for t in range(args.trials):
            rec = run_dag_trial(t, rng, beam, ref, workdir,
                                args.replicas, args.timeout,
                                device=device)
            print("fleet_chaos: dag trial %d kill=%s victim=%s -> %s"
                  % (t, rec["kill_point"], rec["victim"],
                     "PASS" if rec["ok"] else "FAIL"), flush=True)
            trials.append(rec)
        return "dag", _report("dag", args, trials, {
            "config": DAG_CFG, "kill_points": list(DAG_KILL_POINTS),
            "reference_artifacts": len(ref)})

    beam, ref = classic_reference(workdir, args.nsamp, args.nchan,
                                  device)
    if args.campaign:
        import glob as _glob
        # the undisturbed reference: one sequential survey + sift
        refdir = os.path.join(workdir, "reference")
        _sift(refdir, sorted(_glob.glob(os.path.join(refdir,
                                                     "*_ACCEL_0"))))
        with open(os.path.join(refdir, "cands_sifted.txt"), "rb") as f:
            ref_sift = f.read()
        for t in range(args.trials):
            rec = run_campaign_trial(t, rng, beam, ref, ref_sift,
                                     workdir, args.replicas,
                                     args.observations, args.timeout,
                                     device=device)
            print("fleet_chaos: campaign trial %d crash=%s victim=%s"
                  " crashes=%d -> %s"
                  % (t, rec["crash_point"], rec["victim"],
                     rec.get("crashes", 0),
                     "PASS" if rec["ok"] else "FAIL"), flush=True)
            trials.append(rec)
        return "campaign", _report("campaign", args, trials, {
            "observations_per_trial": args.observations,
            "config": TINY_CFG,
            "crash_points": list(CAMPAIGN_KILL_POINTS),
            "reference_artifacts": len(ref)})

    for t in range(args.trials):
        rec = run_trial(t, rng, beam, ref, workdir, args.replicas,
                        args.jobs, args.timeout,
                        lease_batch=args.lease_batch, device=device)
        print("fleet_chaos: trial %d kill=%s victim=%s -> %s"
              % (t, rec["kill_point"], rec["victim"],
                 "PASS" if rec["ok"] else "FAIL"), flush=True)
        trials.append(rec)
    sup_rec = None
    if args.supervisor:
        sup_rec = run_supervisor_trial(rng, beam, ref, workdir,
                                       args.jobs, args.timeout,
                                       device=device)
        print("fleet_chaos: supervisor trial victim=%s -> %s"
              % (sup_rec.get("victim", "?"),
                 "PASS" if sup_rec["ok"] else "FAIL"), flush=True)
        trials.append(sup_rec)
    report = _report("classic", args, trials, {
        "jobs_per_trial": args.jobs,
        "beam": {"nsamp": args.nsamp, "nchan": args.nchan},
        "config": TINY_CFG, "reference_artifacts": len(ref)})
    if sup_rec is not None:
        report["supervisor_trial"] = sup_rec
    return "classic", report


def build_parser():
    p = argparse.ArgumentParser(prog="fleet_chaos")
    p.add_argument("-trials", type=int, default=3)
    p.add_argument("-jobs", type=int, default=3)
    p.add_argument("-replicas", type=int, default=2)
    p.add_argument("-seed", type=int, default=9)
    p.add_argument("-nsamp", type=int, default=4096)
    p.add_argument("-nchan", type=int, default=8)
    p.add_argument("-timeout", type=float, default=300.0)
    p.add_argument("-lease-batch", type=int, default=2,
                   help="Same-bucket jobs leased per transaction "
                        "(drives the batch-leased kill point)")
    p.add_argument("-workdir", type=str, default=None)
    p.add_argument("-dag", action="store_true",
                   help="DAG mode: kill-one trials over whole "
                        "discovery DAGs at DAG-aware kill points "
                        "(-> DAG_CHAOS.json with -commit)")
    p.add_argument("-campaign", action="store_true",
                   help="Campaign mode: crash the campaign driver at a "
                        "randomized ledger seam mid-archive AND "
                        "kill/replace a replica, resume crash-only, and "
                        "require the result byte-equal to an "
                        "undisturbed run (-> CAMPAIGN_CHAOS.json with "
                        "-commit)")
    p.add_argument("-observations", type=int, default=4,
                   help="Observations per campaign trial")
    p.add_argument("-supervisor", action="store_true",
                   help="Also run the supervised-fleet kill trial: "
                        "SIGKILL a supervisor-spawned replica "
                        "mid-batch (supervisor replaces it, "
                        "exactly-once preserved), then kill the "
                        "supervisor itself (fleet degrades to "
                        "advisory-only; a restarted supervisor "
                        "adopts with no orphans)")
    p.add_argument("-out", type=str, default=None,
                   help="Report path (default records/torch/"
                        "FLEET_CHAOS.json, DAG_CHAOS.json or "
                        "CAMPAIGN_CHAOS.json of this checkout, only "
                        "with -commit; else stdout)")
    p.add_argument("-commit", action="store_true",
                   help="Write the report to records/torch/ of this "
                        "checkout")
    p.add_argument("--fast", action="store_true",
                   help="1 trial, CI smoke")
    p.add_argument("-device", "--device", type=str, default="cuda",
                   help="Device of every service, replica and reference "
                        "(default cuda; without a card it raises)")
    return p


def main(argv=None) -> int:
    from presto_tpu_torch.apps.serve_loadgen import card_line, \
        commit_report
    from presto_tpu_torch.io.atomic import atomic_write_text
    from presto_tpu_torch.search.accel import resolve_device
    args = build_parser().parse_args(argv)
    if args.fast:
        args.trials = 1
    device = str(resolve_device(args.device))
    workdir = args.workdir or tempfile.mkdtemp(prefix="fleet_chaos_")
    mode, report = run_mode(args, workdir, device)
    if device.startswith("cuda") and (args.out or args.commit):
        report["card"] = card_line()
    text = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        atomic_write_text(args.out, text + "\n")
        print("fleet_chaos: report -> %s" % args.out)
    elif args.commit:
        print("fleet_chaos: report -> %s"
              % commit_report(report, REPORTS[mode]))
    else:
        print(text)
    return 0 if report["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
