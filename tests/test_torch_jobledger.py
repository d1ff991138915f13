"""The port's fleet bookkeeping against the JAX package's, in-process, on
the same seeded operations: serve/jobledger (with pipeline/leaseledger's
flight-recorder events and serve/usage), obs/slo, obs/fleetagg and
serve/dag.plan_dag.

Each ledger lives in its own temporary directory and sees the same
sequence of admits, leases, batch leases, commits (with and without a DAG
fan-out), terminal failures, releases, heartbeats, tombstones and reaps,
every one at the same explicit clock.  After every operation the two
``jobs.json`` states, the two ``usage.jsonl`` row lists and the two
flight-recorder event lists are equal (host names and clocks are the
same on both sides, so nothing is masked), and an operation that raises
(a fenced-off commit, a quota) raises the same typed error on both."""

import json
import os
import random

import pytest

from presto_tpu.obs import Observability as JObs
from presto_tpu.obs import ObsConfig as JObsConfig
from presto_tpu.obs import fleetagg as jfleetagg
from presto_tpu.obs import slo as jslo
from presto_tpu.obs.metrics import MetricsRegistry as JRegistry
from presto_tpu.serve.dag import plan_dag as jplan_dag
from presto_tpu.serve.jobledger import JobLedger as JLedger
from presto_tpu.serve.usage import UsageLedger as JUsage

from presto_tpu_torch.obs import Observability, ObsConfig, fleetagg, slo
from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.pipeline.leaseledger import DONE, FAILED, PENDING
from presto_tpu_torch.serve.dag import plan_dag
from presto_tpu_torch.serve.jobledger import (JobLedger, StaleResultError,
                                              TenantQuotaExceeded)
from presto_tpu_torch.serve.usage import UsageLedger

HOSTS = ("a", "b", "c")


class Pair:
    """One port and one JAX JobLedger driven in lock step."""

    def __init__(self, root):
        self.dirs = (str(root / "port"), str(root / "jax"))
        self.obs = (Observability(ObsConfig(enabled=True)),
                    JObs(JObsConfig(enabled=True)))
        self.leds = (JobLedger(self.dirs[0], obs=self.obs[0]),
                     JLedger(self.dirs[1], obs=self.obs[1]))
        self.held = []          # [(port lease, jax lease, host)]

    def both(self, fn):
        """fn(ledger, index) on both; the same outcome or the same
        error type.  Returns the two results."""
        out, errs = [], []
        for i, led in enumerate(self.leds):
            try:
                out.append(fn(led, i))
                errs.append(None)
            except Exception as e:                 # compared below
                out.append(None)
                errs.append(type(e).__name__)
        assert errs[0] == errs[1], errs
        return out

    def stage(self, i, job_id, n=0):
        """A staged result file (bytes set by ``n``) and its final path in
        ledger i's dir."""
        d = os.path.join(self.dirs[i], "jobs", job_id)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, ".result-%d" % n)
        with open(tmp, "w") as f:
            f.write('{"n": %d}' % n)
        return {os.path.join(d, "result.json"): tmp}

    def check(self):
        port, ref = (led.read() for led in self.leds)
        assert port == ref
        assert self.leds[0].usage.rows() == self.leds[1].usage.rows()
        ev = [[{k: v for k, v in r.items() if k != "ts"}
               for r in o.flightrec.records()] for o in self.obs]
        assert ev[0] == ev[1]


def _fanout(job_id, spec):
    """A sift-node commit's fan-out: two fold children and the toa
    retarget, as serve/dag._fold_fanout shapes them."""
    dag = spec.get("dag") or job_id
    fids = ["%s-fold-%03d" % (dag, i + 1) for i in range(2)]
    children = [[fid, {"spec": {"kind": "fold", "dag": dag,
                                "parents": {"search": "x"},
                                "fold": {"candnum": i + 1}},
                       "bucket": "fold:1", "blocked_on": [job_id],
                       "dag": dag}] for i, fid in enumerate(fids)]
    retarget = ({spec["retarget"]: {"blocked_on": fids,
                                    "parents": {"fold": fids}}}
                if spec.get("retarget") else None)
    return children, retarget


def _dag_nodes(k):
    return [("search", {"rawfiles": ["b%d.fil" % k]}, "B1", []),
            ("sift", {"kind": "sift", "parents": {"search": "search"},
                      "retarget": "toa"}, None, ["search"]),
            ("toa", {"kind": "toa", "parents": {"fold": []}}, None,
             ["sift"])]


def _step(pair, rng, now):
    op = rng.choice(["admit", "admit", "dag", "lease", "lease",
                     "batch", "commit", "commit", "commit", "fail_terminal",
                     "release", "heartbeat", "reap", "tombstone", "join",
                     "renew"])
    host = rng.choice(HOSTS)
    if op == "admit":
        tenant = rng.choice(["t1", "t2", "t3"])
        kw = dict(tenant=tenant, priority=rng.choice([1, 10, 20]),
                  bucket=rng.choice([None, "B1", "B2"]), now=now)
        pair.both(lambda led, i: led.admit({"seed": rng_seed(now)}, **kw))
    elif op == "dag":
        k = int(now)
        pair.both(lambda led, i: led.admit_dag(_dag_nodes(k), tenant="t1",
                                               now=now))
    elif op in ("lease", "batch"):
        if op == "lease":
            got = pair.both(lambda led, i: led.lease(host, 30.0, now=now))
            got = [[g] if g is not None else [] for g in got]
        else:
            k = rng.choice([2, 3])
            got = pair.both(lambda led, i: led.lease_batch(host, 30.0, k,
                                                           now=now))
        assert [l.item_id for l in got[0]] == [l.item_id for l in got[1]]
        for p, j in zip(*got):
            assert (p.epoch, p.data) == (j.epoch, j.data)
            pair.held.append((p, j, host))
    elif op in ("commit", "fail_terminal", "release", "renew") \
            and pair.held:
        p, j, h = pair.held.pop(rng.randrange(len(pair.held)))
        leases = (p, j)
        usage = {"phases": {"execute": round(rng.uniform(0.1, 5.0), 3),
                            "total": round(rng.uniform(5.0, 9.0), 3)},
                 "replica": h}
        if op == "commit":
            spec = p.data.get("spec") or {}
            if spec.get("kind") == "sift":
                children, retarget = _fanout(p.item_id, spec)
                pair.both(lambda led, i: led.complete_and_expand(
                    leases[i], h, pair.stage(i, p.item_id, int(now)),
                    now=now, extra={"result": {"n": 1}}, children=children,
                    retarget=retarget, usage=usage))
            else:
                pair.both(lambda led, i: led.complete(
                    leases[i], h, pair.stage(i, p.item_id, int(now)),
                    now=now, extra={"result": {"n": 2}}, usage=usage))
        elif op == "fail_terminal":
            pair.both(lambda led, i: led.fail_terminal(
                leases[i], h, "boom", now=now, usage=usage))
        elif op == "release":
            pair.both(lambda led, i: led.fail(leases[i], h))
        else:
            pair.both(lambda led, i: led.renew(leases[i], h, 30.0,
                                               now=now))
            pair.held.append((p, j, h))
    elif op == "heartbeat":
        pair.both(lambda led, i: led.heartbeat(host, led.epoch, now=now))
    elif op == "reap":
        got = pair.both(lambda led, i: led.reap(5.0, now=now))
        assert vars(got[0]) == vars(got[1])
    elif op == "tombstone":
        pair.both(lambda led, i: led.tombstone(host, now=now))
    elif op == "join":
        pair.both(lambda led, i: led.join(host, now=now))
    pair.check()


def rng_seed(now):
    return int(now * 7) % 101


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_same_ledger_operations_same_rows(tmp_path, seed):
    """60 seeded operations on both ledgers: equal jobs.json states,
    usage rows and flight-recorder events after every one."""
    rng = random.Random(seed)
    pair = Pair(tmp_path)
    pair.both(lambda led, i: led.set_tenant("t1", weight=2.0))
    pair.both(lambda led, i: led.set_tenant("t2", weight=1.0, quota=6))
    for h in HOSTS:
        pair.both(lambda led, i: led.join(h, now=0.0))
    pair.check()
    for n in range(60):
        _step(pair, rng, now=1.0 + n)
    counts = pair.leds[0].counts()
    assert sum(counts.values()) > 0
    assert pair.leds[0].tenant_counts() == pair.leds[1].tenant_counts()
    assert pair.leds[0].depth() == pair.leds[1].depth()
    assert pair.leds[0].all_terminal() == pair.leds[1].all_terminal()


def test_quota_and_stale_commit_raise_the_same_types(tmp_path):
    """The typed rejections: a tenant over its quota, and a fenced-off
    zombie commit whose staged file is discarded."""
    pair = Pair(tmp_path)
    pair.both(lambda led, i: led.set_tenant("q", quota=1))
    pair.both(lambda led, i: led.admit({}, tenant="q", now=1.0))
    errs = []
    for led in pair.leds:
        with pytest.raises(Exception) as ei:
            led.admit({}, tenant="q", now=2.0)
        errs.append(ei.value)
    assert isinstance(errs[0], TenantQuotaExceeded)
    assert type(errs[1]).__name__ == "TenantQuotaExceeded"
    assert [(e.quota, e.active, e.unit) for e in errs] == [(1, 1, "jobs")] * 2
    for h in ("a", "b"):
        pair.both(lambda led, i: led.join(h, now=0.0))
    got = pair.both(lambda led, i: led.lease("a", 30.0, now=3.0))
    pair.both(lambda led, i: led.heartbeat("b", 0, now=100.0))
    pair.both(lambda led, i: led.reap(10.0, now=100.0))
    staged = [pair.stage(i, got[i].item_id) for i in range(2)]
    for i, led in enumerate(pair.leds):
        with pytest.raises(Exception) as ei:
            led.complete(got[i], "a", staged[i], now=101.0)
        assert type(ei.value).__name__ == "StaleResultError"
        assert not os.path.exists(list(staged[i].values())[0])
    pair.check()


def test_on_commit_runs_inside_the_commit_only_when_fenced_in(tmp_path):
    """The port's commit hook: it runs once per landed commit, before the
    state file shows the job done, and never for a fenced-off one."""
    led = JobLedger(str(tmp_path))
    led.join("a", now=0.0)
    led.join("b", now=0.0)
    led.admit({}, job_id="j1", now=0.0)
    lease = led.lease("a", 30.0, now=0.0)
    seen = []
    final = str(tmp_path / "r.json")
    tmp = str(tmp_path / "stage")
    with open(tmp, "w") as f:
        f.write("{}")
    led.complete(lease, "a", {final: tmp}, now=1.0,
                 on_commit=lambda: seen.append(led.view("j1")["state"]))
    assert seen == ["leased"] and led.view("j1")["state"] == DONE
    led.admit({}, job_id="j2", now=2.0)
    zombie = led.lease("a", 30.0, now=2.0)
    led.heartbeat("b", 0, now=100.0)
    led.reap(10.0, now=100.0)
    with open(tmp, "w") as f:
        f.write("{}")
    with pytest.raises(StaleResultError):
        led.complete(zombie, "a", {final + ".2": tmp}, now=101.0,
                     on_commit=lambda: seen.append("zombie"))
    assert seen == ["leased"] and led.view("j2")["state"] == PENDING


def test_usage_ledger_torn_tail_repair(tmp_path):
    """The same torn-tail repair and dedup as the JAX usage ledger."""
    rows = [{"job_id": "a", "ts": 1.0}, {"job_id": "b", "ts": 2.0},
            {"job_id": "a", "ts": 3.0}]
    for cls, d in ((UsageLedger, "p"), (JUsage, "j")):
        led = cls(str(tmp_path / d))
        for r in rows:
            led.append(r)
        with open(led.path, "ab") as f:
            f.write(b'{"job_id": "torn"')
    port, ref = UsageLedger(str(tmp_path / "p")), JUsage(str(tmp_path / "j"))
    assert port.rows() == ref.rows() and port.raw_rows() == ref.raw_rows()
    port.append({"job_id": "c", "ts": 4.0})
    ref.append({"job_id": "c", "ts": 4.0})
    assert open(port.path, "rb").read() == open(ref.path, "rb").read()
    assert [r["job_id"] for r in port.rows()] == ["a", "b", "c"]


# ----------------------------------------------------------------------
# obs/slo: the same numbers on the same usage rows
# ----------------------------------------------------------------------

def _usage_rows(seed, now=1000.0):
    rng = random.Random(seed)
    rows = []
    for i in range(rng.randint(20, 200)):
        rows.append({"job_id": "j%d" % i,
                     "tenant": rng.choice(["gold", "bronze", "t"]),
                     "bucket": rng.choice(["b1", "b2", None]),
                     "dag": rng.choice([None, "dag-000001"]),
                     "state": FAILED if rng.random() < 0.2 else DONE,
                     "ts": now - rng.uniform(0.0, 3000.0),
                     "phases": {"execute": rng.uniform(0.1, 6.0),
                                "lease_wait": rng.uniform(0.0, 2.0),
                                "total": rng.uniform(0.5, 9.0)}})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slo_numbers_equal(seed):
    rows = _usage_rows(seed)
    now = 1000.0
    for text in ("gold:0.999:5", "bronze:0.5", "t:0.99:2"):
        spec, jspec = slo.parse_spec(text), jslo.parse_spec(text)
        assert slo.window_state(spec, rows, now) == \
            jslo.window_state(jspec, rows, now)
        assert slo.evaluate(spec, rows, now) == \
            jslo.evaluate(jspec, rows, now)
        assert slo.burn_series(spec, rows, now, 600.0, 60.0) == \
            jslo.burn_series(jspec, rows, now, 600.0, 60.0)
    assert slo.usage_rollup(rows) == jslo.usage_rollup(rows)
    assert slo.bucket_cost_model(rows) == jslo.bucket_cost_model(rows)
    est, jest = slo.cost_estimator(rows), jslo.cost_estimator(rows)
    for b in ("b1", "b2", None, "unknown"):
        assert est(b) == jest(b)
    evals = {"gold": {"alert": seed % 2 == 0}, "bronze": {"alert": False}}
    for backlog, ready, camp in ((["b1"] * 7 + [None], 2, 0.0),
                                 ([], 1, 0.0), (["b2"] * 40, 3, 120.0)):
        cfg, jcfg = slo.ScaleConfig(), jslo.ScaleConfig()
        assert slo.scale_advice(backlog, rows, evals, ready, cfg, now,
                                campaign_remaining_s=camp) == \
            jslo.scale_advice(backlog, rows, evals, ready, jcfg, now,
                              campaign_remaining_s=camp)


def test_slo_files_shared(tmp_path):
    """slo.json and backfill.json written by one package read back in
    the other, and the backfill yield updates to the same factor."""
    specs = [slo.parse_spec("gold:0.999:5"), slo.parse_spec("bronze:0.9")]
    slo.save_specs(str(tmp_path), specs)
    assert [s.tenant for s in jslo.load_specs(str(tmp_path))] == \
        ["gold", "bronze"]
    slo.save_backfill(str(tmp_path), ["campaign"])
    assert jslo.load_backfill(str(tmp_path)) == \
        slo.load_backfill(str(tmp_path))
    rows = _usage_rows(7)
    evals = {s.tenant: slo.evaluate(s, rows, 1000.0) for s in specs}
    assert slo.backfill_yield_factor(evals) == \
        jslo.backfill_yield_factor(evals)


# ----------------------------------------------------------------------
# obs/fleetagg: the same merged numbers
# ----------------------------------------------------------------------

def _fill(reg, seed, replica):
    rng = random.Random(seed)
    c = reg.counter("fleet_jobs_committed_total", "commits")
    c.inc(rng.randint(0, 9))
    g = reg.gauge("fleet_inflight", "held")
    g.set(rng.randint(0, 4))
    h = reg.histogram("job_e2e_seconds", "phases", ("phase", "bucket"))
    for _ in range(rng.randint(1, 40)):
        h.labels(phase=rng.choice(["execute", "total"]),
                 bucket=rng.choice(["b1", "b2"])).observe(
                     rng.uniform(0.01, 30.0))
    k = reg.counter("jax_dispatches_total", "dispatches", ("kind",))
    k.labels(kind="fold").inc(rng.randint(1, 5))
    return reg.export_state()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleetagg_merge_states_equal(seed):
    states = {"r%d" % i: _fill(MetricsRegistry(), seed * 10 + i, i)
              for i in range(3)}
    jstates = {"r%d" % i: _fill(JRegistry(), seed * 10 + i, i)
               for i in range(3)}
    assert states == jstates
    merged, jmerged = fleetagg.merge_states(states), \
        jfleetagg.merge_states(jstates)
    assert merged == jmerged
    assert fleetagg.to_json(merged) == jfleetagg.to_json(jmerged)
    assert fleetagg.render_prometheus(merged) == \
        jfleetagg.render_prometheus(jmerged)
    assert fleetagg.counter_rollup(merged, "jax_dispatches_total", "kind") \
        == jfleetagg.counter_rollup(jmerged, "jax_dispatches_total", "kind")


def test_fleetagg_reads_the_jax_snapshots(tmp_path):
    """A snapshot published by either package aggregates in the other."""
    obs, jobs_ = Observability(ObsConfig(enabled=True)), \
        JObs(JObsConfig(enabled=True))
    _fill(obs.metrics, 1, 0)
    _fill(jobs_.metrics, 2, 1)
    fleetagg.publish_snapshot(str(tmp_path), "port-r", obs, now=10.0)
    jfleetagg.publish_snapshot(str(tmp_path), "jax-r", jobs_, now=10.0)
    agg, jagg = fleetagg.aggregate(str(tmp_path), now=11.0), \
        jfleetagg.aggregate(str(tmp_path), now=11.0)
    assert sorted(fleetagg.load_snapshots(str(tmp_path))) == \
        ["jax-r", "port-r"]
    assert agg == jagg


# ----------------------------------------------------------------------
# serve/dag.plan_dag: the same node lists
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    from tools.serve_loadgen import make_beams
    return make_beams(str(tmp_path_factory.mktemp("dagbeam")), 1,
                      nsamp=4096, nchan=8)[0]


@pytest.mark.parametrize("extra", [
    {},
    {"triage": True},
    {"triage": {"budget": 2, "weights": "w.json"}, "toa": {"ntoa": 2}},
    {"sift": {"min_dm_hits": 1}, "fold": {"fold_top": 5},
     "config_extra": {"accel_passes": [[20, 4, 3.0]]}},
])
def test_plan_dag_equal(beam, extra):
    extra = dict(extra)
    cfg = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
           "numharm": 2, "skip_rfifind": True}
    cfg.update(extra.pop("config_extra", {}))
    spec = dict({"rawfiles": [beam], "config": cfg}, **extra)
    nodes, jnodes = plan_dag(dict(spec)), jplan_dag(dict(spec))
    assert json.loads(json.dumps(nodes)) == json.loads(json.dumps(jnodes))
    assert [n[0] for n in nodes] == (
        ["search", "sift", "triage", "toa"] if extra.get("triage")
        else ["search", "sift", "toa"])
    assert nodes[0][2] is not None          # the search bucket hint


# ----------------------------------------------------------------------
# serve/campaign and apps/campaign: the same waves and states
# ----------------------------------------------------------------------

def _campaign_manifest(n):
    """Observation specs (the POST /dag wire schema); the rawfiles need
    not exist: the stub drain below commits without executing."""
    return [{"id": "obs-%03d" % i, "rawfiles": ["/none/beam%03d.fil" % i],
             "config": {"lodm": 50.0, "hidm": 56.0, "nsub": 8}}
            for i in range(n)]


def _drain(led, fail_prefix=None):
    """A stub replica: lease everything grantable and commit it (or fail
    it terminally for the DAG named by fail_prefix)."""
    while True:
        lease = led.lease("r1", ttl=30.0)
        if lease is None:
            return
        if fail_prefix and lease.item_id.startswith(fail_prefix):
            led.fail_terminal(lease, "r1", "injected",
                              usage={"phases": {"execute": 0.0}})
        else:
            led.complete(lease, "r1", {}, usage={
                "phases": {"execute": 0.25, "total": 0.25}})


def test_campaign_waves_match_the_jax_package(tmp_path):
    """Both packages' campaign drivers over the same manifest (wave size
    2, one observation failing): the same waves, outstanding counts,
    settled states and admitted DAG ids, pulse by pulse."""
    from presto_tpu.serve.campaign import CampaignConfig as JCfg
    from presto_tpu.serve.campaign import CampaignDriver as JDriver
    from presto_tpu_torch.serve.campaign import (CampaignConfig,
                                                 CampaignDriver)
    sides = []
    for cfg_cls, drv_cls, led_cls, d in (
            (CampaignConfig, CampaignDriver, JobLedger, "port"),
            (JCfg, JDriver, JLedger, "jax")):
        fleet = str(tmp_path / d)
        drv = drv_cls(cfg_cls(fleetdir=fleet, campaign_id="c",
                              wave_size=2))
        drv.create(_campaign_manifest(5))
        sides.append((drv, led_cls(fleet)))
    trail = [[], []]
    for _ in range(40):
        for i, (drv, led) in enumerate(sides):
            st = drv.pulse()
            trail[i].append((st["state"], st["waves"], st["outstanding"],
                             dict(st["counts"])))
            led.join("r1")
            _drain(led, fail_prefix="c.obs-003-")
        if trail[0][-1][0] != "running":
            break
    assert trail[0] == trail[1]
    assert trail[0][-1][0] == "done"
    assert trail[0][-1][3]["done"] == 4 and trail[0][-1][3]["failed"] == 1
    for drv, led in sides:
        drv.close()
    assert sorted(sides[0][1].read()["jobs"]) == \
        sorted(sides[1][1].read()["jobs"])


def test_campaign_cli_exit_contract(tmp_path, capsys):
    """presto-campaign: rc 1 without a ledger, a first wave with -once,
    rc 0 when resumed to completion, -status with the projection."""
    from presto_tpu_torch.apps.campaign import main as campaign_main
    fleet = str(tmp_path / "fleet")
    man = tmp_path / "manifest.json"
    man.write_text(json.dumps(_campaign_manifest(2)))
    assert campaign_main(["-fleet", fleet, "-id", "c", "-resume"]) == 1
    assert "no ledger" in capsys.readouterr().err
    assert campaign_main(["-fleet", fleet, "-id", "c", "-manifest",
                          str(man), "-wave-size", "1", "-once"]) == 0
    led = JobLedger(fleet)
    assert len(led.read()["jobs"]) == 3          # search, sift, toa
    led.join("r1")
    for _ in range(10):
        _drain(led)
        campaign_main(["-fleet", fleet, "-id", "c", "-once"])
    assert campaign_main(["-fleet", fleet, "-id", "c", "-resume"]) == 0
    capsys.readouterr()
    assert campaign_main(["-fleet", fleet, "-id", "c", "-status"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["state"] == "done" and out["projection"]["remaining"] == 0
