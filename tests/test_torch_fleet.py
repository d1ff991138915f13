"""The port's fleet (serve/fleet, serve/router, serve/dag on
serve/jobledger) on the CPU.

Protocol chaos runs on stub services (deterministic artifact bytes, no
device work) with short lease and heartbeat timers: a replica killed at
a chaos point (job-leased, batch-leased, and in a stub DAG fold-fanout,
post-sift-commit, mid-fold, mid-triage) loses no job and doubles none.
The committed counter already counts every commit when the ledger first
shows all jobs terminal (the JAX replica counts after its commit is
visible; the port counts inside the commit), over 5 seeds of job
timings.  The router sheds with Retry-After, rejects a tenant over its
quota with a typed 429 and answers 503 with no ready replica.

One real discovery DAG with triage runs on a beam of three pulsars
(16384 samples x 8 channels: tests/test_dag.py's strong pulsar and two
weaker ones; it sifts to 4 candidates, 3 of them in the heuristic fold
selection, which a budget of 2 cuts) through a port replica and through
a JAX package replica (its TPU search engine on the CPU, as
tests/test_torch_survey_slice.py runs it), with the same weights file:
the sifted lists agree as tests/test_torch_serve_survey.py holds them,
the triage selection is the same, each .pfd is byte-equal to the port's
refold of the JAX package's candidate from the JAX package's .dat (the
byte rule of tests/test_torch_prepfold.py), and the .tim has one TOA a
fold."""

import glob
import hashlib
import json
import os
import random
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu_torch.pipeline.leaseledger import DONE
from presto_tpu_torch.serve.dag import plan_dag
from presto_tpu_torch.serve.fleet import FleetConfig, FleetReplica
from presto_tpu_torch.serve.jobledger import JobLedger
from presto_tpu_torch.serve.router import FleetRouter, RouterConfig
from presto_tpu_torch.serve.router import start_http as start_router_http
from presto_tpu_torch.serve.server import SearchService

TINY_CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0,
            "numharm": 2, "fold_top": 0, "singlepulse": False,
            "skip_rfifind": True, "durable_stages": True}


def stub_bytes(tag) -> bytes:
    return hashlib.sha256(("stub-%s" % tag).encode()).digest() * 16


class StubService(SearchService):
    """Survey and DAG-node executors that write deterministic bytes (the
    sift stub returns a real fan-out: two folds and the toa retarget)."""

    def _execute_job(self, job):
        os.makedirs(job.workdir, exist_ok=True)
        time.sleep(float(job.spec.get("sleep_s", 0.0)))
        kind = getattr(job, "kind", "survey")
        if kind == "survey":
            tag = job.spec.get("seed", "search")
            with open(os.path.join(job.workdir, "stub.dat"), "wb") as f:
                f.write(stub_bytes(tag))
            return {"ok": True, "seed": job.spec.get("seed", 0)}
        if kind in ("sift", "triage"):
            assert os.path.exists(os.path.join(
                job.spec["parent_dirs"]["search"], "stub.dat"))
            with open(os.path.join(job.workdir, "cands_sifted.txt"),
                      "wb") as f:
                f.write(stub_bytes(kind))
            if job.spec.get("fanout", True) is False:
                return {"folds": 0, "deferred_to_triage": True}
            dag = job.spec.get("dag") or "d"
            fids = ["%s-fold-%03d" % (dag, i + 1) for i in range(2)]
            children = [[fid, {
                "spec": {"kind": "fold", "dag": dag,
                         "parents": {"search": job.spec["parents"]
                                     ["search"]},
                         "fold": {"seed": i + 1}},
                "bucket": "stub-fold", "blocked_on": [job.job_id],
                "dag": dag}] for i, fid in enumerate(fids)]
            retarget = {job.spec["retarget"]: {
                "blocked_on": list(fids), "parents": {"fold": list(fids)}}}
            return {"folds": 2, "dag_children": children,
                    "dag_retarget": retarget}
        if kind == "fold":
            with open(os.path.join(job.workdir, "fold.dat"), "wb") as f:
                f.write(stub_bytes("fold-%s" % job.spec["fold"]["seed"]))
            return {"ok": True}
        if kind == "toa":
            blob = b"".join(hashlib.sha256(open(os.path.join(
                d, "fold.dat"), "rb").read()).digest()
                for d in job.spec["parent_dirs"]["fold"])
            with open(os.path.join(job.workdir, "toas.dat"), "wb") as f:
                f.write(blob)
            return {"ok": True}
        raise ValueError(kind)


@pytest.fixture(scope="module")
def tiny_beam(tmp_path_factory):
    from tools.serve_loadgen import make_beams
    return make_beams(str(tmp_path_factory.mktemp("beams")), 1,
                      nsamp=4096, nchan=8)[0]


def _spec(beam, **extra):
    spec = {"rawfiles": [beam], "config": dict(TINY_CFG)}
    spec.update(extra)
    return spec


def _member(tmp_path, name, fleetdir, svc_cls=StubService, device="cpu",
            **fkw):
    svc = svc_cls(str(tmp_path / ("w-" + name)), queue_depth=8,
                  device=device).start()
    cfg = FleetConfig(fleetdir=str(fleetdir), replica=name,
                      lease_ttl=20.0, heartbeat_s=0.1,
                      heartbeat_timeout=0.6, poll_s=0.02,
                      max_inflight=1, prewarm=False)
    for k, v in fkw.items():
        setattr(cfg, k, v)
    return svc, FleetReplica(svc, cfg)


def _wait(cond, timeout=30.0, poll=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


def _stop(*pairs):
    for svc, rep in pairs:
        rep.stop()
    for svc, rep in pairs:
        svc.stop()


def _committed(svc):
    fam = svc.obs.metrics.get("fleet_jobs_committed_total")
    return 0 if fam is None else int(fam.value)


def _detail(fleetdir, jid):
    return json.load(open(os.path.join(str(fleetdir), "jobs", jid,
                                       "result.json")))


def _result_files(fleetdir):
    return glob.glob(os.path.join(str(fleetdir), "jobs", "*",
                                  "result.json"))


# ----------------------------------------------------------------------
# kill one replica: exactly once
# ----------------------------------------------------------------------

@pytest.mark.parametrize("point,batch", [("job-leased", 1),
                                         ("batch-leased", 2)])
def test_kill_one_replica_exactly_once(tmp_path, tiny_beam, point, batch):
    """A dies at the chaos point holding its lease (or a whole batch);
    B reaps, re-admits and completes everything once, with the stub
    bytes, each stranded job redone once, and B's committed counter at
    the job count the moment the ledger is all terminal."""
    fleetdir = tmp_path / "fleet"
    led = JobLedger(str(fleetdir))
    for i in range(3):
        led.admit(_spec(tiny_beam, seed=i), bucket="B")
    kw = dict(max_inflight=batch, lease_batch=batch)
    a = _member(tmp_path, "a", fleetdir, **kw)
    a[1].kill_on = point
    b = _member(tmp_path, "b", fleetdir, **kw)
    try:
        a[1].start()
        assert _wait(lambda: a[1]._killed)
        stranded = [j for j, v in led.read()["jobs"].items()
                    if v["owner"] == "a"]
        assert len(stranded) == batch
        b[1].start()
        assert _wait(led.all_terminal)
        assert _committed(b[0]) == 3
        state = led.read()
        for jid, row in state["jobs"].items():
            assert row["state"] == DONE and row["owner"] == "b"
            detail = _detail(fleetdir, jid)
            assert detail["artifacts"]["stub.dat"]["sha256"] == \
                hashlib.sha256(stub_bytes(detail["result"]["seed"])) \
                .hexdigest()
            assert detail["attempt_dir"] == "a%04d" % detail["epoch"]
        for jid in stranded:
            assert state["jobs"][jid]["redos"] == 1
        assert int(state["epoch"]) >= 1
        assert len(_result_files(fleetdir)) == 3
        assert _committed(a[0]) == 0
        rows = led.usage.rows()
        assert sorted(r["job_id"] for r in rows) == sorted(state["jobs"])
    finally:
        _stop(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_committed_counter_counts_before_the_ledger_is_terminal(
        tmp_path, tiny_beam, seed):
    """Two replicas over seeded job timings: when any reader first sees
    the ledger all terminal, the replicas' committed counters already sum
    to the job count (the JAX replica's race, not carried)."""
    rng = random.Random(seed)
    fleetdir = tmp_path / "fleet"
    led = JobLedger(str(fleetdir))
    n = 6
    for i in range(n):
        led.admit(_spec(tiny_beam, seed=i,
                        sleep_s=round(rng.uniform(0.0, 0.05), 3)))
    a = _member(tmp_path, "a", fleetdir)
    b = _member(tmp_path, "b", fleetdir)
    try:
        a[1].start()
        b[1].start()
        deadline = time.time() + 30.0
        while not led.all_terminal():
            assert time.time() < deadline
        assert _committed(a[0]) + _committed(b[0]) == n
    finally:
        _stop(a, b)


def test_zombie_commit_is_fenced_and_never_counted(tmp_path, tiny_beam):
    """A replica killed after it enqueued its job keeps running it as a
    zombie; the survivor commits; the zombie's late commit is rejected,
    the result lands once and the zombie counts no commit."""
    fleetdir = tmp_path / "fleet"
    led = JobLedger(str(fleetdir))
    led.admit(_spec(tiny_beam, seed=5, sleep_s=0.3))
    a = _member(tmp_path, "a", fleetdir)
    a[1].kill_on = "job-enqueued"
    b = _member(tmp_path, "b", fleetdir)
    try:
        a[1].start()
        assert _wait(lambda: a[1]._killed)
        (jid, (lease, job)), = dict(a[1]._inflight).items()
        b[1].start()
        assert _wait(led.all_terminal)
        assert _wait(lambda: job.status == "done")
        before = open(_result_files(fleetdir)[0], "rb").read()
        assert a[1]._commit(lease, job) is False
        assert open(_result_files(fleetdir)[0], "rb").read() == before
        assert _committed(a[0]) == 0 and _committed(b[0]) == 1
        assert a[0].obs.metrics.get("fleet_stale_results_total").value == 1
    finally:
        _stop(a, b)


def test_graceful_drain_commits_and_tombstones(tmp_path, tiny_beam):
    fleetdir = tmp_path / "fleet"
    led = JobLedger(str(fleetdir))
    led.admit(_spec(tiny_beam, seed=7, sleep_s=0.3))
    svc, rep = _member(tmp_path, "r1", fleetdir)
    try:
        rep.start()
        assert _wait(lambda: rep._inflight_size() == 1)
        assert svc.readyz()["lease"]["held"] == ["fjob-000001"]
        report = svc.shutdown(drain=True, timeout=20.0)
        assert report["drained"] is True
        assert led.view("fjob-000001")["state"] == DONE
        assert json.load(open(led.heartbeat_path("r1")))["tombstone"]
        assert "r1" in led.reap(heartbeat_ttl=1e9).dead_hosts
        snap = json.load(open(os.path.join(str(fleetdir), "obs",
                                           "r1.json")))
        assert snap["tombstone"] is True
    finally:
        rep.stop()


def test_idle_tune_runs_one_bounded_slice(tmp_path):
    """An idle replica runs one slice of the port's tune/ families on its
    device and merge-saves the fleet's tuning DB; off by default."""
    fleetdir = tmp_path / "fleet"
    svc, rep = _member(tmp_path, "r1", fleetdir, tune_in_idle=True,
                       idle_tune_families="plancache_bucket",
                       idle_tune_budget_s=10.0, idle_tune_interval=3600.0)
    off = _member(tmp_path, "r2", tmp_path / "fleet2")
    try:
        rep.start()
        off[1].start()
        assert _wait(lambda: svc.obs.metrics.get("fleet_idle_tune_total")
                     is not None and svc.obs.metrics.get(
                         "fleet_idle_tune_total").value >= 1)
        from presto_tpu_torch.tune import TuneDB
        assert TuneDB.load(os.path.join(str(fleetdir),
                                        "tune.json")).size()[1] >= 1
        assert any(e["kind"] == "fleet-idle-tune"
                   for e in svc.events.tail(100))
        assert not os.path.exists(os.path.join(str(tmp_path / "fleet2"),
                                               "tune.json"))
    finally:
        _stop((svc, rep), off)


# ----------------------------------------------------------------------
# stub discovery DAGs under a kill
# ----------------------------------------------------------------------

def _check_dag(led, fleetdir, out, triage):
    dv = led.dag_view(out["dag_id"])
    assert dv["state"] == DONE, dv
    fold_ids = sorted(j for j in dv["nodes"] if "-fold-" in j)
    assert fold_ids == ["%s-fold-001" % out["dag_id"],
                        "%s-fold-002" % out["dag_id"]]
    assert led.view(out["nodes"]["toa"])["blocked_on"] == fold_ids
    toa = _detail(fleetdir, out["nodes"]["toa"])
    want = b"".join(hashlib.sha256(stub_bytes("fold-%d" % (i + 1)))
                    .digest() for i in range(2))
    assert open(os.path.join(str(fleetdir), "jobs", out["nodes"]["toa"],
                             toa["attempt_dir"], "toas.dat"),
                "rb").read() == want
    if triage:
        assert _detail(fleetdir, out["nodes"]["sift"])["result"][
            "deferred_to_triage"]
    # every node done once: one result.json and one usage row a node
    assert len(_result_files(fleetdir)) == len(dv["nodes"])
    assert sorted(r["job_id"] for r in led.usage.rows()) == \
        sorted(dv["nodes"])


@pytest.mark.parametrize("point,triage", [
    ("fold-fanout", False), ("post-sift-commit", False),
    ("mid-fold", False), ("mid-triage", True), ("job-leased", True)])
def test_stub_dag_kill_one_exactly_once(tmp_path, tiny_beam, point, triage):
    fleetdir = tmp_path / "fleet"
    led = JobLedger(str(fleetdir))
    spec = {"rawfiles": [tiny_beam], "config": dict(TINY_CFG)}
    if triage:
        spec["triage"] = {"budget": 2}
    out = led.admit_dag(plan_dag(spec))
    a = _member(tmp_path, "a", fleetdir, max_inflight=2)
    a[1].kill_on = point
    b = _member(tmp_path, "b", fleetdir, max_inflight=2)
    try:
        a[1].start()
        assert _wait(lambda: a[1]._killed)
        b[1].start()
        assert _wait(led.all_terminal)
        _check_dag(led, fleetdir, out, triage)
        assert _committed(a[0]) + _committed(b[0]) == \
            len(led.dag_view(out["dag_id"])["nodes"])
        redos = [r["redos"] for r in led.read()["jobs"].values()]
        assert max(redos) <= 1
        if point == "post-sift-commit":
            assert sum(redos) == 0
        else:
            assert sum(redos) >= 1
    finally:
        _stop(a, b)


# ----------------------------------------------------------------------
# the router
# ----------------------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=10)


@pytest.fixture
def router_at(tmp_path):
    made = []

    def make(**kw):
        router = FleetRouter(RouterConfig(fleetdir=str(tmp_path / "fleet"),
                                          **kw))
        httpd = start_router_http(router)
        made.append((router, httpd))
        return router, "http://%s:%d" % httpd.server_address[:2]
    yield make
    for router, httpd in made:
        httpd.shutdown()
        router.stop()


def test_router_sheds_with_retry_after(router_at, tiny_beam):
    router, base = router_at(high_water=2, retry_after_s=3.0,
                             require_ready=False)
    for _ in range(2):
        assert _post(base + "/submit", _spec(tiny_beam)).status == 202
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/submit", _spec(tiny_beam))
    assert ei.value.code == 429
    assert ei.value.headers["Retry-After"] == "3"
    assert json.loads(ei.value.read())["error"] == "shed"
    assert router.obs.metrics.get("fleet_shed_total").value == 1
    assert any(e["kind"] == "shed" for e in router.events.tail(50))
    view = router.fleet_view()
    assert view["depth"] == 2 and view["high_water"] == 2


def test_router_tenant_quota_typed_rejection(router_at, tiny_beam):
    router, base = router_at(high_water=100, require_ready=False,
                             tenants=["vip:2:1", "bulk:1"])
    assert _post(base + "/submit",
                 _spec(tiny_beam, tenant="vip")).status == 202
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/submit", _spec(tiny_beam, tenant="vip"))
    assert ei.value.code == 429
    assert json.loads(ei.value.read()) == {
        "error": "quota-exceeded", "tenant": "vip", "quota": 1,
        "active": 1, "unit": "jobs"}
    assert router.obs.metrics.get("fleet_quota_rejections_total").labels(
        tenant="vip").value == 1
    assert _post(base + "/submit",
                 _spec(tiny_beam, tenant="bulk")).status == 202


def test_router_503_with_no_ready_replica(router_at, tiny_beam):
    _router, base = router_at(require_ready=True)
    for path, body in (("/submit", _spec(tiny_beam)),
                       ("/dag", {"rawfiles": [tiny_beam],
                                 "config": dict(TINY_CFG)})):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + path, body)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["error"] == "no-ready-replica"


def test_router_dag_to_replica_over_http(tmp_path, router_at, tiny_beam):
    """POST /dag lands the graph; a stub replica registered at its own
    HTTP address makes the router ready; GET /dag, /scale and
    /fleet/metrics answer, the aggregated commit counter equal to the
    nodes committed."""
    from presto_tpu_torch.serve.server import start_http
    router, base = router_at(require_ready=True, poll_s=0.1)
    fleetdir = tmp_path / "fleet"
    svc = StubService(str(tmp_path / "w"), device="cpu").start()
    httpd = start_http(svc)
    rep = FleetReplica(svc, FleetConfig(
        fleetdir=str(fleetdir), replica="r1", heartbeat_s=0.1,
        heartbeat_timeout=2.0, poll_s=0.02, prewarm=False,
        snapshot_s=0.1), addr="http://%s:%d" % httpd.server_address[:2])
    try:
        rep.start()
        router.start()
        assert _wait(lambda: len(router.ready_replicas()) >= 1)
        out = json.loads(_post(base + "/dag", {
            "rawfiles": [tiny_beam], "config": dict(TINY_CFG)}).read())
        dag = lambda: json.loads(urllib.request.urlopen(
            base + "/dag/" + out["dag_id"], timeout=10).read())
        ok = _wait(lambda: dag()["state"] == "done")
        assert ok, (dag(), svc.events.tail(30))
        n = len(dag()["nodes"])
        scale = json.loads(urllib.request.urlopen(base + "/scale",
                                                  timeout=10).read())
        assert scale["wanted_replicas"] >= 1
        rep._maybe_snapshot(force=True)
        agg = json.loads(urllib.request.urlopen(
            base + "/fleet/metrics", timeout=10).read())
        (series,) = agg["metrics"]["fleet_jobs_committed_total"]["series"]
        assert series["value"] == n
    finally:
        rep.stop()
        httpd.shutdown()
        svc.stop()


# ----------------------------------------------------------------------
# one real discovery DAG with triage, port against the JAX package
# ----------------------------------------------------------------------

DAG_CFG = {"lodm": 50.0, "hidm": 60.0, "nsub": 8, "zmax": 0,
           "numharm": 4, "singlepulse": False, "skip_rfifind": True}


@pytest.fixture(scope="module")
def three_pulsar_beam(tmp_path_factory):
    """tests/test_dag.py's strong beam (f 23 Hz, DM 55) with two weaker
    pulsars added (37.3 Hz at DM 52, 11.7 Hz at DM 58)."""
    import numpy as np
    from presto_tpu_torch.io.sigproc import (FilterbankHeader,
                                             write_filterbank)
    from presto_tpu_torch.models.synth import (FakeSignal,
                                               fake_filterbank_data)
    N, dt, nchan, lo, cw = 16384, 5e-4, 8, 400.0, 1.0
    data = fake_filterbank_data(
        N, dt, nchan, lo, cw, FakeSignal(f=23.0, dm=55.0, shape="gauss",
                                         width=0.08, amp=2.0),
        2.0, baseline=32.0, seed=101)
    for k, (f, dm, amp) in enumerate(((37.3, 52.0, 1.2),
                                      (11.7, 58.0, 1.0))):
        data = data + fake_filterbank_data(
            N, dt, nchan, lo, cw, FakeSignal(f=f, dm=dm, shape="gauss",
                                             width=0.08, amp=amp),
            0.0, baseline=0.0, seed=102 + k)
    path = os.path.join(str(tmp_path_factory.mktemp("three")), "beam.fil")
    write_filterbank(path, FilterbankHeader(
        source_name="FAKEPSR", machine_id=10, telescope_id=6,
        src_raj=53431.97, src_dej=220052.1, fch1=lo + (nchan - 1) * cw,
        foff=-cw, nchans=nchan, nbits=8, tstart=59000.0, tsamp=dt,
        nifs=1, rawdatafile="beam.fil"),
        np.clip(np.round(data * 4.0), 0, 255).astype(np.uint8))
    return path


def _run_dag(root, beam, weights, jax_side):
    """One DAG through one replica of either package; returns
    (ledger view, {node: committed attempt dir})."""
    fleetdir = root / "fleet"
    spec = {"rawfiles": [beam], "config": dict(DAG_CFG),
            "fold": {"fold_top": 3}, "toa": {"ntoa": 1},
            "triage": {"weights": weights, "budget": 2}}
    if jax_side:
        from presto_tpu.serve.dag import plan_dag as jplan
        from presto_tpu.serve.fleet import FleetConfig as JCfg
        from presto_tpu.serve.fleet import FleetReplica as JRep
        from presto_tpu.serve.jobledger import JobLedger as JLed
        from presto_tpu.serve.server import SearchService as JSvc
        led = JLed(str(fleetdir))
        out = led.admit_dag(jplan(spec))
        svc = JSvc(str(root / "w"), queue_depth=8).start()
        rep = JRep(svc, JCfg(fleetdir=str(fleetdir), replica="j",
                             prewarm=False, poll_s=0.02))
    else:
        led = JobLedger(str(fleetdir))
        out = led.admit_dag(plan_dag(spec))
        svc = SearchService(str(root / "w"), queue_depth=8,
                            device="cpu").start()
        rep = FleetReplica(svc, FleetConfig(fleetdir=str(fleetdir),
                                            replica="p", prewarm=False,
                                            poll_s=0.02))
    try:
        rep.start()
        assert _wait(led.all_terminal, timeout=400.0, poll=0.1)
    finally:
        rep.stop()
        svc.stop()
    dv = led.dag_view(out["dag_id"])
    dirs = {jid: os.path.join(str(fleetdir), "jobs", jid,
                              _detail(fleetdir, jid)["attempt_dir"])
            for jid in dv["nodes"]}
    rel = {jid[len(out["dag_id"]) + 1:]: d for jid, d in dirs.items()}
    return dv, rel


@pytest.fixture(scope="module")
def real_dags(tmp_path_factory, three_pulsar_beam):
    from presto_tpu.triage.calibrate import (synthetic_campaign,
                                             train_on_observations)
    from test_torch_survey_slice import _jax_tpu_path
    root = tmp_path_factory.mktemp("realdag")
    weights = str(root / "triage_weights.json")
    train_on_observations(synthetic_campaign(seed=3, n_obs=4, n_noise=80),
                          seed=3).save(weights)
    port = _run_dag(root / "port", three_pulsar_beam, weights, False)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        ref = _run_dag(root / "jax", three_pulsar_beam, weights, True)
    return port, ref


def _sifted_rows(path):
    rows = []
    for line in open(path):
        tok = line.split()
        if tok and not line.startswith("#") and ":" in tok[0]:
            rows.append((tok[0], float(tok[1]), int(tok[4]),
                         float(tok[8])))
    return rows


def test_real_triage_dag_matches_the_jax_package(real_dags):
    (dv, dirs), (jdv, jdirs) = real_dags
    assert dv["state"] == jdv["state"] == DONE
    assert sorted(dirs) == sorted(jdirs)
    # the search node: .dat bytes equal; the sifted lists agree
    for d in sorted(glob.glob(os.path.join(jdirs["search"], "*.dat"))):
        name = os.path.basename(d)
        assert open(os.path.join(dirs["search"], name), "rb").read() == \
            open(d, "rb").read(), name
    got = _sifted_rows(os.path.join(dirs["sift"], "cands_sifted.txt"))
    want = _sifted_rows(os.path.join(jdirs["sift"], "cands_sifted.txt"))
    assert got and [g[:3] for g in got] == [w[:3] for w in want]
    assert all(abs(g[3] - w[3]) <= 2e-3 for g, w in zip(got, want))
    # the triage node: the same mode, scores and selection
    sc = json.load(open(os.path.join(dirs["triage"], "triage_scores.json")))
    jsc = json.load(open(os.path.join(jdirs["triage"],
                                      "triage_scores.json")))
    assert sc["mode"] == jsc["mode"] == "triage"
    pick = [(c["filename"], c["candnum"]) for c in sc["candidates"]
            if c["selected"]]
    jpick = [(c["filename"], c["candnum"]) for c in jsc["candidates"]
             if c["selected"]]
    if pick != jpick:
        print("triage near-tie:", [(c["filename"], c["candnum"],
                                    c["score"]) for c in sc["candidates"]],
              [(c["filename"], c["candnum"], c["score"])
               for c in jsc["candidates"]])
    assert pick == jpick and len(pick) == 2
    assert len(sc["candidates"]) == len(jsc["candidates"]) == 3


def test_real_triage_dag_folds_and_toas(real_dags, tmp_path):
    """Each fold node's .pfd is byte-equal to the port's refold of the
    JAX package's candidate from the JAX package's .dat, and the .tim
    holds one TOA a fold."""
    from presto_tpu_torch.apps.prepfold import DatFoldSpec, fold_dat_cands
    (dv, dirs), (jdv, jdirs) = real_dags
    folds = sorted(k for k in dirs if k.startswith("fold-"))
    assert folds == sorted(k for k in jdirs if k.startswith("fold-"))
    assert len(folds) == 2
    for k in folds:
        (pfd,) = glob.glob(os.path.join(dirs[k], "*.pfd"))
        (jpfd,) = glob.glob(os.path.join(jdirs[k], "*.pfd"))
        assert os.path.basename(pfd) == os.path.basename(jpfd)
        jres = [c for c in json.load(open(os.path.join(
            jdirs["triage"], "triage_scores.json")))["candidates"]
            if c["selected"]]
        c = jres[folds.index(k)]
        base = c["filename"].split("_ACCEL_")[0]
        out = str(tmp_path / os.path.basename(pfd)[:-4])
        os.symlink(os.path.join(jdirs["search"], base + ".dat"),
                   str(tmp_path / (base + ".dat")))
        os.symlink(os.path.join(jdirs["search"], base + ".inf"),
                   str(tmp_path / (base + ".inf")))
        fold_dat_cands([DatFoldSpec(
            datfile=str(tmp_path / (base + ".dat")),
            accelfile=os.path.join(jdirs["search"],
                                   c["filename"] + ".cand"),
            candnum=c["candnum"], outbase=out, dm=c["dm"])], device="cpu")
        assert open(out + ".pfd", "rb").read() == open(jpfd, "rb").read()
        os.remove(str(tmp_path / (base + ".dat")))
        os.remove(str(tmp_path / (base + ".inf")))
    tim = [ln for ln in open(os.path.join(dirs["toa"], "toas.tim"))
           if ln.strip() and not ln.startswith("FORMAT")]
    assert len(tim) == len(folds)


def test_pipeline_cli_with_triage(three_pulsar_beam, tmp_path, capsys):
    """The one-command survey with -triage: the survey's cfg.triage
    policy cuts the heuristic's three folds to the budget of two, the
    ones TriagePolicy.select picks over the same sifted list."""
    from presto_tpu_torch.apps import pipeline
    from presto_tpu_torch.apps import triage as triage_cli
    from presto_tpu_torch.pipeline.sifting import (select_fold_candidates,
                                                   sift_candidates)
    from presto_tpu_torch.triage import TriagePolicy
    weights = str(tmp_path / "w.json")
    assert triage_cli.main(["train", "--synthetic", "-observations", "4",
                            "-o", weights], device="cpu") == 0
    work = str(tmp_path / "work")
    assert pipeline.main(["-lodm", "50", "-hidm", "60", "-nsub", "8",
                          "-zmax", "0", "-numharm", "4", "-nosp", "-norfi",
                          "-foldtop", "3", "-triage", "-triage-budget", "2",
                          "-triage-weights", weights, "-workdir", work,
                          three_pulsar_beam], device="cpu") == 0
    out = capsys.readouterr().out
    assert "triage triage: scored 3, folding 2 (1 avoided)" in out
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(work, "fold_cand*.pfd"))) == ["fold_cand1.pfd",
                                                   "fold_cand2.pfd"]
    cl = sift_candidates(sorted(glob.glob(os.path.join(work,
                                                       "*_ACCEL_0"))))
    heur = select_fold_candidates(cl, fold_top=3, pass_zmaxes=[0])
    want, _acct = TriagePolicy(weights_path=weights, budget=2,
                               device="cpu").select(heur)
    from presto_tpu_torch.io.pfd import read_pfd
    for i, c in enumerate(want):
        assert read_pfd(os.path.join(
            work, "fold_cand%d.pfd" % (i + 1))).filenm.endswith(
                c.filename.split("_ACCEL_")[0] + ".dat")
