"""The port's federation (serve/federation) against the JAX package's.

Both FedLedgers take the same calls with the same `now` (join, admit,
place, commit, reap, the zombie fleet's fenced late commit, re-place):
`fleets.json` is the same text, its directory aside.  Both routers over
the same member fleet directories price the same (the uniform fallback,
then per-fingerprint perf-ledger episodes read from an explicit path,
then the fleet's own usage), order the same candidates (locality,
saturation) and spill the same way past a shedding or saturated fleet.
The federated burn rates and the /fleet/metrics fold equal the JAX
package's on the same usage rows and replica snapshots.  One end-to-end
run with two port fleets on the CPU: the job placed on fleet A (it holds
the data), A's replica dies at its lease and A's router goes away, the
federation reaps A and re-admits the job on B, which runs it once; its
files equal `run_survey`'s on the same beam."""

import glob
import json
import os
import random
import time
from types import SimpleNamespace

import pytest

from presto_tpu.obs import perfledger as jpl
from presto_tpu.serve import federation as jfed
from presto_tpu.testing.chaos import FaultInjector as JFaultInjector

from presto_tpu_torch.obs import Observability, ObsConfig, fleetagg, slo
from presto_tpu_torch.obs import perfledger as ppl
from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.serve import federation as pfed
from presto_tpu_torch.serve.usage import UsageLedger
from presto_tpu_torch.testing import chaos
from presto_tpu_torch.testing.chaos import FaultInjector

PACKAGES = {"port": (pfed, FaultInjector), "jax": (jfed, JFaultInjector)}


class FakePush:
    """The member routers' wire protocol without HTTP: fleets in `shed`
    answer 429, fleets in `down` are unreachable."""

    def __init__(self, shed=(), down=()):
        self.shed, self.down = set(shed), set(down)
        self.pushed = []

    def __call__(self, member, iid, kind, spec):
        self.pushed.append((member.name, iid))
        if member.name in self.down:
            return "unreachable", {"error": "down"}
        if member.name in self.shed:
            return "shed", {"retry_after_s": 0.5}
        return "ok", {}


def _members(mod, root, names=("A", "B")):
    out = []
    for name in names:
        fleetdir = os.path.join(str(root), "fleets", name)
        os.makedirs(fleetdir, exist_ok=True)
        out.append(mod.FleetMember(name=name, fleetdir=fleetdir))
    return out


def _fed(pkg, root, **kw):
    """One package's router over the shared member fleet directories
    (its own federation directory)."""
    mod, _inj = PACKAGES[pkg]
    members = _members(mod, root)
    for m in members:
        for k in ("fingerprint", "data_roots"):
            if k in kw.get("member", {}).get(m.name, {}):
                setattr(m, k, kw["member"][m.name][k])
    kw.pop("member", None)
    kw.setdefault("heartbeat_ttl", 5.0)
    cfg = mod.FederationConfig(feddir=os.path.join(str(root), "fed-" + pkg),
                               fleets=members, **kw)
    if pkg == "port":
        obs = Observability(ObsConfig(enabled=True, service="presto-fed"))
    else:
        from presto_tpu.obs import Observability as JObs
        from presto_tpu.obs import ObsConfig as JObsConfig
        obs = JObs(JObsConfig(enabled=True, service="presto-fed"))
    return mod.FederationRouter(cfg, obs=obs)


def _fleets_json(feddir):
    with open(os.path.join(feddir, "fleets.json")) as f:
        return f.read().replace(feddir, "<fed>")


#: wall-clock fields of fleets.json (calls that take no `now`)
_CLOCK_KEYS = ("joined", "leased_at", "lease_expires", "completed_at",
               "last_heartbeat", "dead_at")


def _untimed(feddir, drop=()):
    """fleets.json as data, its wall-clock fields (and ``drop``)
    dropped."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in _CLOCK_KEYS and k not in drop}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(json.loads(_fleets_json(feddir)))


def _events(fed):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq")}
            for e in fed.events.tail(1000)]


# ----------------------------------------------------------------------
# FedLedger: the same calls, the same fleets.json
# ----------------------------------------------------------------------

def _ledger_script(mod, feddir):
    """Place, commit, reap, the zombie's fenced commit, re-place and
    commit, with `now` given everywhere; fleets.json after each call."""
    led = mod.FedLedger(feddir)
    snaps = []

    def snap():
        snaps.append(_fleets_json(feddir))

    def staged(name):
        p = os.path.join(feddir, ".staged-%s.json" % name)
        with open(p, "w") as f:
            f.write("{}\n")
        return p
    os.makedirs(os.path.join(feddir, "results"), exist_ok=True)
    final = lambda iid: os.path.join(feddir, "results", iid + ".json")  # noqa: E731
    for name in ("A", "B"):
        led.join(name, addr="http://%s" % name, now=0.0)
        led.heartbeat(name, led.epoch, now=0.0)
    snap()
    led.admit("it-1", "job", {"rawfiles": ["x"]}, "default", "bkt")
    led.admit("it-2", "dag", {"rawfiles": ["y"]}, "gold", None)
    snap()
    l1 = led.place("it-1", "A", ttl=600.0, now=1.0)
    l2 = led.place("it-2", "B", ttl=600.0, now=1.0)
    assert led.place("it-1", "A", ttl=600.0, now=2.0) is None
    snap()
    led.complete(l2, "B", {final("it-2"): staged("it-2")}, now=3.0,
                 extra={"remote_state": "done"})
    snap()
    led.heartbeat("B", led.epoch, now=59.0)
    report = led.reap(5.0, now=60.0)
    assert report.dead_hosts == ["A"] and report.redone == ["it-1"]
    snap()
    with pytest.raises(mod.FedStaleCommit):
        led.complete(l1, "A", {final("it-1"): staged("zombie")}, now=61.0)
    assert not os.path.exists(final("it-1"))
    snap()
    l1b = led.place("it-1", "B", ttl=600.0, now=62.0)
    led.complete(l1b, "B", {final("it-1"): staged("it-1")}, now=63.0)
    snap()
    return snaps, sorted(led.adopt_leases())


def test_fedledger_calls_give_the_jax_fleets_json(tmp_path):
    port = _ledger_script(pfed, str(tmp_path / "p"))
    ref = _ledger_script(jfed, str(tmp_path / "j"))
    assert port == ref
    assert len(port[0]) == 7


# ----------------------------------------------------------------------
# pricing: uniform -> perf-ledger episodes -> usage
# ----------------------------------------------------------------------

def _episodes(mod, path, rates):
    led = mod.PerfLedger()
    for i, (fp, rate) in enumerate(rates):
        ep = mod.make_episode(
            {"jobs_per_hour": mod.metric_from_samples([rate, rate * 1.1,
                                                       rate * 0.9],
                                                      "jobs/h"),
             "wall": mod.metric_from_samples([3.0], "s", "lower")},
            fingerprint=fp, workload="smoke", source="test",
            run_id="e%d" % i)
        ep["ts"] = float(i)
        led.append(ep)
    led.save(path)


def test_pricing_ladder_equals_jax(tmp_path):
    """The same price and source as the JAX router at each rung, for
    every member and bucket, and the same candidate order."""
    datadir = tmp_path / "data"
    os.makedirs(datadir, exist_ok=True)
    perf = str(tmp_path / "perf" / "ledger.json")
    members = {"A": {"fingerprint": "fp-h100", "data_roots":
                     (str(datadir),)},
               "B": {"fingerprint": "fp-other"}}
    feds = {pkg: _fed(pkg, tmp_path, default_job_s=7.0,
                      locality_discount=0.5, perf_ledger_path=perf,
                      member=members) for pkg in PACKAGES}
    spec = {"rawfiles": [str(datadir / "beam.fil")]}
    now = time.time()

    def both():
        out = {}
        for pkg, fed in feds.items():
            out[pkg] = ([fed.price_fleet(m, b) for m in fed.cfg.fleets
                         for b in ("bkt", "other", None)],
                        fed.candidates("bkt", spec, now))
        assert out["port"] == out["jax"]
        return out["port"][0]
    prices = both()
    assert {s for _p, s in prices} == {"uniform"}
    _episodes(ppl, perf, [("fp-h100", 40.0), ("fp-other", 10.0),
                          ("fp-h100", 44.0)])
    prices = both()
    assert {s for _p, s in prices} == {"perf-ledger"}
    # the JAX module reads the port's file the same way (one schema)
    jperf = str(tmp_path / "perf" / "jax.json")
    _episodes(jpl, jperf, [("fp-h100", 40.0), ("fp-other", 10.0),
                           ("fp-h100", 44.0)])
    with open(perf) as f, open(jperf) as g:
        strip = lambda t: [dict(e, ts=0) for e in json.loads(t)[  # noqa: E731
            "episodes"]]
        assert strip(f.read()) == strip(g.read())
    ul = UsageLedger(feds["port"].cfg.fleets[0].fleetdir)
    for i in range(3):
        ul.append({"job_id": "j%d" % i, "state": "done", "bucket": "bkt",
                   "tenant": "default", "ts": 100.0 + i,
                   "phases": {"execute": 2.0 + i, "total": 2.5 + i}})
    prices = both()
    assert prices[0] == (3.0, "usage-bucket")
    assert prices[1][1] == "usage-median"
    assert prices[3][1] == "perf-ledger"


@pytest.mark.parametrize("how", ["shed", "saturated", "down"])
def test_spill_past_a_busy_fleet_equals_jax(tmp_path, how):
    """A shedding (429), saturated (/scale wants more than ready) or
    unreachable first choice: the same walk, placement, events and
    fleets.json as the JAX router."""
    out = {}
    for pkg in PACKAGES:
        fed = _fed(pkg, tmp_path)
        push = FakePush(shed={"A"} if how == "shed" else (),
                        down={"A"} if how == "down" else ())
        fed._push = push
        if how == "saturated":
            with fed._state_lock:
                fed._advice["A"] = {"wanted_replicas": 3, "inputs": {
                    "ready_replicas": 1}}
        got = [fed.submit({"job_id": "j%d" % i, "rawfiles": ["x"]})
               for i in range(2)]
        for g in got:
            g["placement"].pop("price_s", None)
        out[pkg] = (got, push.pushed, _events(fed),
                    _untimed(fed.cfg.feddir),
                    fed.obs.metrics.get("fed_spills_total").value,
                    fed.scale_view()["fleets"]["A"]["saturated"])
        fed.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["placement"]["fleet"] == "B"


def test_failover_and_zombie_fence_equal_jax(tmp_path):
    """Whole-fleet death through the failover pass, the survivor's
    commit through the pump, the dead fleet's late commit fenced: the
    same reports, kill points, counters and fleets.json."""
    out = {}
    for pkg, (mod, inj_cls) in PACKAGES.items():
        from presto_tpu.serve.jobledger import JobLedger as JLedger
        from presto_tpu_torch.serve.jobledger import JobLedger as PLedger
        Ledger = PLedger if pkg == "port" else JLedger
        inj = inj_cls(mode="off")
        fed = _fed(pkg, tmp_path / pkg, fault_injector=inj)
        fed._push = FakePush()
        t0 = 1000.0
        for name in ("A", "B"):
            fed.fedledger.heartbeat(name, fed.fedledger.epoch, now=t0)
        fed.fedledger.admit("j1", "job", {"rawfiles": ["x"]}, "default",
                            None)
        fed._place_and_push("j1", "job", {"rawfiles": ["x"]}, None, now=t0)
        vled = Ledger(fed._members["A"].fleetdir)
        vled.join("r1")
        vled.admit({"rawfiles": ["x"]}, job_id="j1")
        vlease = vled.lease("r1", ttl=600.0)
        t1 = t0 + 10.0
        fed.fedledger.heartbeat("B", fed.fedledger.epoch, now=t1)
        report = fed.failover(now=t1)
        sled = Ledger(fed._members["B"].fleetdir)
        sled.join("r1")
        sled.admit({"rawfiles": ["x"]}, job_id="j1")
        sled.complete(sled.lease("r1", ttl=60.0), "r1", {})
        fed.fedledger.heartbeat("B", fed.fedledger.epoch, now=t1)
        p1 = fed.pump(now=t1)
        vled.complete(vlease, "r1", {})
        p2 = fed.pump(now=t1)
        res = fed.result("j1")
        out[pkg] = (report, p1, p2, list(inj.points_seen),
                    res["fleet"], res["view"]["state"],
                    fed.obs.metrics.get("fed_stale_commits_total").value,
                    fed.obs.metrics.get("fed_commits_total").value,
                    # the committed result file embeds the member
                    # ledger's own clock: its checksum differs
                    _untimed(fed.cfg.feddir, drop=("checksum", "size")))
        fed.stop()
    assert out["port"] == out["jax"]
    assert out["port"][4] == "B" and out["port"][6] >= 1


def test_kill_points_equal_jax():
    assert pfed.FED_KILL_POINTS == jfed.FED_KILL_POINTS
    assert chaos.FED_KILL_POINTS == pfed.FED_KILL_POINTS


# ----------------------------------------------------------------------
# federated folds on the same files
# ----------------------------------------------------------------------

def _usage_row(rng, jid, now):
    total = rng.uniform(0.1, 20.0)
    return {"job_id": jid, "tenant": rng.choice(("default", "gold")),
            "state": "done" if rng.random() < 0.8 else "failed",
            "ts": now - rng.uniform(0.0, 7200.0),
            "bucket": rng.choice(("b1", "b2")),
            "phases": {"execute": total * 0.8, "total": total}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rates_usage_and_metrics_equal_jax(tmp_path, seed):
    """/slo, /usage and /fleet/metrics of both routers over the same
    member directories (usage rows split at random, SLO specs, replica
    snapshots with different histogram layouts a fleet)."""
    rng = random.Random(seed)
    feds = {pkg: _fed(pkg, tmp_path) for pkg in PACKAGES}
    now = time.time()
    members = feds["port"].cfg.fleets
    specs = [slo.parse_spec("default:0.95"),
             slo.parse_spec("gold:0.99:5")]
    for m in members:
        slo.save_specs(m.fleetdir, specs)
    ledgers = [UsageLedger(m.fleetdir) for m in members]
    for i in range(rng.randint(5, 60)):
        rng.choice(ledgers).append(_usage_row(rng, "j%d" % i, now))
    layouts = {"A": (0.1, 1.0, 10.0), "B": (0.5, 5.0)}
    for m in members:
        for r in range(rng.randint(1, 3)):
            reg = MetricsRegistry()
            h = reg.histogram("job_e2e_seconds", "e2e", ("phase",),
                              buckets=layouts[m.name])
            for _ in range(rng.randint(1, 40)):
                h.labels(phase="total").observe(rng.uniform(0.01, 30.0))
            reg.counter("fleet_jobs_committed_total", "c").inc(
                rng.randint(0, 9))
            reg.counter("cuda_kernel_launches_total", "l",
                        ("kernel",)).labels(kernel="plane_build").inc(
                rng.randint(0, 30))
            fleetagg.publish_snapshot(m.fleetdir, "%s-r%d" % (m.name, r),
                                      SimpleNamespace(metrics=reg), now=now)
    views = {pkg: (fed.slo_view(now), fed.usage_view(),
                   dict(fed.fed_metrics(now), feddir=None))
             for pkg, fed in feds.items()}
    assert views["port"] == views["jax"]
    assert views["port"][0]["tenants"]["default"]["events"] >= 0


# ----------------------------------------------------------------------
# end to end: two port fleets on the CPU, fleet A dies whole
# ----------------------------------------------------------------------

E2E_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
           "numharm": 2, "fold_top": 0, "singlepulse": False,
           "skip_rfifind": True, "durable_stages": True}


def _until(cond, timeout, poll=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def test_whole_fleet_death_runs_the_job_once_on_b(tmp_path):
    """Fleet A holds the beam; its replica dies at the job's lease (the
    SIGKILL chaos seam: heartbeats stop, the lease stays claimed) and its
    router goes away.  The federation reaps A and re-admits the job on
    B, whose replica runs it: one federated commit (B's), B's fleet
    ledger done once, A's lease never committed, and the job's files
    equal run_survey's."""
    from tools.serve_loadgen import make_beams
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
    from presto_tpu_torch.serve.jobledger import JobLedger
    from presto_tpu_torch.serve.router import (FleetRouter, RouterConfig,
                                               start_http)
    from presto_tpu_torch.serve.server import SearchService
    from presto_tpu_torch.serve.server import start_http as svc_http
    datadir = tmp_path / "data"
    beam = make_beams(str(datadir), 1, nsamp=4096, nchan=8)[0]
    fleets = {}
    for name in ("A", "B"):
        fleetdir = str(tmp_path / name)
        router = FleetRouter(RouterConfig(fleetdir=fleetdir, poll_s=0.05,
                                          heartbeat_timeout=15.0)).start()
        httpd = start_http(router)
        svc = SearchService(str(tmp_path / ("w-" + name)), queue_depth=8,
                            device="cpu").start()
        shttp = svc_http(svc)
        rep = FleetReplica(svc, FleetConfig(
            fleetdir=fleetdir, replica="r" + name, lease_ttl=60.0,
            heartbeat_s=0.1, heartbeat_timeout=15.0, poll_s=0.02,
            max_inflight=1, prewarm=False),
            addr="http://%s:%d" % shttp.server_address[:2])
        if name == "A":
            rep.kill_on = "job-leased"
        rep.start()
        fleets[name] = (fleetdir, router, httpd, svc, rep, shttp)
    members = [pfed.FleetMember(
        name=n, fleetdir=fleets[n][0],
        url="http://%s:%d" % fleets[n][2].server_address[:2],
        data_roots=(str(datadir),) if n == "A" else ())
        for n in ("A", "B")]
    fed = pfed.FederationRouter(pfed.FederationConfig(
        feddir=str(tmp_path / "fed"), fleets=members, poll_s=0.1,
        heartbeat_ttl=4.0, http_timeout=10.0))
    try:
        assert _until(lambda: all(len(f[1].ready_replicas()) == 1
                                  for f in fleets.values()), 60)
        fed.start()
        out = fed.submit({"rawfiles": [beam], "config": dict(E2E_CFG),
                          "job_id": "fedjob-1"})
        assert out["placement"]["fleet"] == "A"
        assert out["placement"]["local"]
        aled = JobLedger(fleets["A"][0])
        assert _until(lambda: (aled.view("fedjob-1") or {}).get("state")
                      == "leased", 60)
        # fleet A dies whole: its router goes away too (its socket
        # closed, so a probe is refused as a dead process's would be)
        fleets["A"][2].shutdown()
        fleets["A"][2].server_close()
        fleets["A"][1].stop()
        assert _until(lambda: (fed.status("fedjob-1") or {}).get("state")
                      == "done", 120)
    finally:
        fed.stop()
        for fleetdir, router, httpd, svc, rep, shttp in fleets.values():
            rep.stop()
            shttp.shutdown()
            svc.stop()
            if router is not fleets["A"][1]:
                httpd.shutdown()
                router.stop()
    row = fed.fedledger.placements()["fedjob-1"]
    assert row["state"] == "done" and row["owner"] == "B"
    assert row["redos"] == 1
    assert fed.obs.metrics.get("fed_readmits_total").value == 1
    assert fed.obs.metrics.get("fed_commits_total").value == 1
    assert fed.result("fedjob-1")["fleet"] == "B"
    bled = JobLedger(fleets["B"][0])
    assert bled.view("fedjob-1")["state"] == "done"
    assert [u["job_id"] for u in bled.usage.raw_rows()] == ["fedjob-1"]
    assert JobLedger(fleets["A"][0]).view("fedjob-1")["state"] == "leased"
    detail = json.load(open(os.path.join(fleets["B"][0], "jobs",
                                         "fedjob-1", "result.json")))
    jobdir = os.path.join(fleets["B"][0], "jobs", "fedjob-1",
                          detail["attempt_dir"])
    ref = str(tmp_path / "ref")
    survey.run_survey([beam], survey.SurveyConfig(**E2E_CFG), ref,
                      device="cpu")
    pats = ("*.dat", "*_ACCEL_*", "cands_sifted.txt")
    want = sorted(os.path.basename(p) for pat in pats
                  for p in glob.glob(os.path.join(ref, pat)))
    assert want and any(w.endswith(".dat") for w in want)
    for name in want:
        with open(os.path.join(ref, name), "rb") as f, \
                open(os.path.join(jobdir, name), "rb") as g:
            assert f.read() == g.read(), name
