"""Survey jobs on the port's SearchService: submit / POST /submit, the
stacked cross-job batch, the plan cache and store, against the JAX
package's SearchService and the port's own run_survey on the same beam.

The beam is tests/test_serve_stacked.py's (tools/serve_loadgen.make_beams
at 4096 samples x 8 channels, 6 DM trials, single pulse on).  Two
same-bucket jobs run as one stacked batch on the CPU: every artifact is
byte-equal to the port's independent run_survey; against the JAX
service's jobs (its TPU search engine run on the CPU, as
tests/test_torch_survey_slice.py runs it) the .dat files are byte-equal,
the .singlepulse files agree by search/singlepulse.agreement, the ACCEL
candidates by the polish tolerances and the sifted lists (also on the
beam at 2^15 samples, whose candidates are strong).  A fault inside
the stacked chain and a mixed-config batch degrade to per-job runs with
the same bytes; a device error evicts the device's plans before the
retry; a second service prewarms from the plan store and its job hits
the cache."""

import glob
import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from presto_tpu.serve.fleet import artifact_digests
from presto_tpu.serve.server import SearchService as JSearchService
from tools.serve_loadgen import make_beams
from test_torch_survey_slice import _jax_tpu_path

from presto_tpu_torch.apps.accelsearch import read_cand_file
from presto_tpu_torch.pipeline.survey import SurveyConfig, run_survey
from presto_tpu_torch.search.accel import AccelConfig
from presto_tpu_torch.serve.batchexec import (StackedBatchExecutor,
                                              StackIncompatible,
                                              plan_stack_sizes,
                                              stack_signature)
from presto_tpu_torch.serve.queue import Job
from presto_tpu_torch.serve.scheduler import SchedulerConfig
from presto_tpu_torch.serve.server import SearchService, start_http
from presto_tpu_torch.testing.chaos import TransientFaults

CFG = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0, "numharm": 2,
       "fold_top": 0, "singlepulse": True, "skip_rfifind": True,
       "durable_stages": True}
SP_THRESHOLD = 5.0


def _spec(beam, **extra):
    return {"rawfiles": [beam], "config": dict(CFG, **extra)}


def _run_arm(svc, specs, timeout=300.0):
    """Submit every spec before the scheduler starts (provable
    coalescing), wait for them, return the jobs."""
    ids = [svc.submit(s)["job_id"] for s in specs]
    svc.start()
    assert svc.wait(ids, timeout=timeout)
    return [svc.get_job(j) for j in ids]


def _kinds(svc):
    return [e["kind"] for e in svc.events.tail(100000)]


def _build_arms(root, nsamp):
    """The beam, the port's own run_survey, and two stacked jobs through
    the port's service and the JAX package's."""
    beam = make_beams(str(root), 1, nsamp=nsamp, nchan=8)[0]
    ref = str(root / "ref")
    run_survey([beam], SurveyConfig(**CFG), ref, device="cpu")
    svc = SearchService(str(root / "port"), stacked=True, device="cpu")
    jsvc = JSearchService(str(root / "jax"), stacked=True)
    try:
        jobs = _run_arm(svc, [_spec(beam), _spec(beam)])
        with pytest.MonkeyPatch.context() as mp:
            # the JAX package's TPU search engine, on the CPU
            _jax_tpu_path(mp)
            jjobs = _run_arm(jsvc, [_spec(beam), _spec(beam)])
        out = dict(beam=beam, ref=ref, refdig=artifact_digests(ref),
                   jobs=jobs, jjobs=jjobs, kinds=_kinds(svc),
                   stats=svc.scheduler.stats(), metrics=svc.metrics(),
                   scheds=[e for e in svc.events.tail(100000)
                           if e["kind"] == "schedule"],
                   jstats=jsvc.scheduler.stats())
    finally:
        svc.stop()
        jsvc.stop()
    assert out["refdig"], "the reference run wrote no artifacts"
    return out


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """test_serve_stacked.py's beam: 4096 samples, noise candidates."""
    return _build_arms(tmp_path_factory.mktemp("serve_survey"), 4096)


@pytest.fixture(scope="module")
def strong_arms(tmp_path_factory):
    """The same beam at 2^15 samples: strong candidates (sigma 19-36)
    and a sifted list."""
    return _build_arms(tmp_path_factory.mktemp("serve_strong"), 1 << 15)


def test_stacked_jobs_byte_equal_to_own_run_survey(arms):
    """One schedule event of occupancy 2, no degrade, both jobs through
    the stacked chain, every artifact byte-equal to run_survey's."""
    assert [j.status for j in arms["jobs"]] == ["done", "done"]
    assert len(arms["scheds"]) == 1 and arms["scheds"][0]["occupancy"] == 2
    assert "degrade" not in arms["kinds"]
    st = arms["stats"]
    assert st["stacked_jobs"] == 2 and st["stacked_batches"] == 1
    assert st["degrades"] == 0
    for job in arms["jobs"]:
        assert artifact_digests(job.workdir) == arms["refdig"]
        assert job.result["stacked"] == 2
        assert job.result["n_datfiles"] == 6
        assert json.dumps(job.result)
    # the stacked chain made one dispatch of each kind for both jobs
    costs = arms["metrics"]["kernel_costs"]["kinds"]
    assert costs["accel_search"]["dispatches"] == 1
    assert costs["rfft_batch"]["dispatches"] == 1
    assert costs["plane_build"]["dispatches"] == 12
    assert arms["metrics"]["plans"]["misses"] == 1


def _sifted_rows(path):
    """(file:candnum, DM, numharm, r) of each candidate line of a
    cands_sifted.txt."""
    rows = []
    for line in open(path):
        tok = line.split()
        if tok and not line.startswith("#") and ":" in tok[0]:
            rows.append((tok[0], float(tok[1]), int(tok[4]), float(tok[8])))
    return rows


@pytest.mark.parametrize("which", ["arms", "strong_arms"])
def test_stacked_jobs_match_the_jax_service(request, which):
    """Against the JAX service's stacked jobs on the same beam: the same
    artifact names; .dat byte-equal; .singlepulse by
    singlepulse.agreement; every ACCEL table the same candidate count and
    harmonics, its strong candidates (sigma above 5) within the polish
    tolerances, as tests/test_torch_survey_slice.py holds them; the
    sifted lists the same candidates, r within 2e-3 bins."""
    from presto_tpu_torch.search.singlepulse import file_agreement
    from test_torch_polish import assert_polish_agrees
    arms = request.getfixturevalue(which)
    assert arms["jstats"]["stacked_jobs"] == 2
    strong = 0
    for job, jjob in zip(arms["jobs"], arms["jjobs"]):
        assert jjob.status == "done"
        names = sorted(artifact_digests(job.workdir))
        assert names == sorted(artifact_digests(jjob.workdir))
        for n in names:
            a, b = (os.path.join(d, n) for d in (job.workdir,
                                                 jjob.workdir))
            if n.endswith(".dat"):
                assert open(a, "rb").read() == open(b, "rb").read(), n
            elif n.endswith(".singlepulse"):
                r = file_agreement(b, a, SP_THRESHOLD)
                assert r["ok"], (n, r)
            elif n.endswith(".cand"):
                want, got = read_cand_file(b), read_cand_file(a)
                assert [c.numharm for c in got] == \
                    [c.numharm for c in want], n
                want = [c for c in want if c.sigma > 5.0]
                got = [c for c in got if c.sigma > 5.0]
                assert_polish_agrees(want, got)
                strong += len(got)
            elif n == "cands_sifted.txt":
                want, got = _sifted_rows(b), _sifted_rows(a)
                assert [g[:3] for g in got] == [w[:3] for w in want]
                assert all(abs(g[3] - w[3]) <= 2e-3
                           for g, w in zip(got, want))
        assert job.result["n_cands"] == jjob.result["n_cands"]
        assert job.result["sp_events"] == jjob.result["sp_events"]
    if which == "strong_arms":
        assert strong >= 12 and arms["jobs"][0].result["n_cands"] >= 1


def test_post_submit_over_http(tmp_path, arms):
    """POST /submit twice, then GET the results: both done, the stacked
    occupancy in the payload, readyz's plan store, /metrics with the
    plan cache and the cost book (JSON and Prometheus)."""
    svc = SearchService(str(tmp_path / "svc"), stacked=True, device="cpu",
                        plan_store_dir=str(tmp_path / "store"))
    httpd = start_http(svc)
    base = "http://%s:%d" % httpd.server_address[:2]

    def call(path, payload=None):
        req = urllib.request.Request(
            base + path, method="GET" if payload is None else "POST",
            data=None if payload is None else json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
    try:
        codes = [call("/submit", _spec(arms["beam"])) for _ in range(2)]
        assert [c for c, _b in codes] == [202, 202]
        ids = [json.loads(b)["job_id"] for _c, b in codes]
        svc.start()
        assert svc.wait(ids, timeout=300)
        for j in ids:
            code, body = call("/jobs/%s/result" % j)
            view = json.loads(body)
            assert code == 200 and view["status"] == "done"
            assert view["result"]["stacked"] == 2
            assert artifact_digests(view["result"]["workdir"]) == \
                arms["refdig"]
        ready = json.loads(call("/readyz")[1])
        assert ready["plan_warm_fraction"] == 1.0
        assert ready["plan_store"]["known_plans"] == 1
        m = json.loads(call("/metrics")[1])
        assert m["plans"]["size"] == 1
        assert m["kernel_costs"]["kinds"]["stage_reduce"][
            "hbm_bytes_total"] > 0
        text = call("/metrics?format=prometheus")[1].decode()
        assert "kernel_flops_total" in text
        assert "serve_stacked_jobs_total 2" in text
    finally:
        httpd.shutdown()
        svc.stop()


def test_fault_in_stacked_chain_degrades_to_per_job(tmp_path, arms):
    """A fault raised at the fused-chunk point inside the merged chain
    aborts the stacked batch; the per-job redo writes the same bytes."""

    class _RaiseOnce:
        def __init__(self, at):
            self.at, self.fired = at, 0

        def point(self, name):
            if name == self.at and not self.fired:
                self.fired += 1
                raise RuntimeError("injected stacked-chain fault")

    injector = _RaiseOnce("fused-chunk")
    svc = SearchService(str(tmp_path / "svc"), stacked=True, device="cpu")
    try:
        jobs = [svc.build_job(_spec(arms["beam"])) for _ in range(2)]
        for job in jobs:
            job.cfg.fault_injector = injector
            svc.enqueue_job(job)
        svc.start()
        assert svc.wait([j.job_id for j in jobs], timeout=300)
        assert [j.status for j in jobs] == ["done", "done"]
        assert injector.fired == 1
        assert "degrade" in _kinds(svc)
        assert svc.scheduler.stats()["degrades"] == 1
        for j in jobs:
            assert artifact_digests(j.workdir) == arms["refdig"]
    finally:
        svc.stop()


def test_transient_fault_and_mixed_config_batches_degrade(tmp_path, arms):
    """A transient fault in the stacked attempt, and a same-bucket batch
    of two search configs: each degrades, every job done and correct."""
    faults = TransientFaults(fail_attempts=1)
    svc = SearchService(str(tmp_path / "t"), stacked=True, device="cpu",
                        scheduler_cfg=SchedulerConfig(
                            max_batch=8, poll_s=0.02, max_retries=2,
                            backoff_base_s=0.05, fault_injector=faults))
    try:
        jobs = _run_arm(svc, [_spec(arms["beam"]), _spec(arms["beam"])])
        assert [j.status for j in jobs] == ["done", "done"]
        assert "degrade" in _kinds(svc) and faults.calls >= 3
        for j in jobs:
            assert artifact_digests(j.workdir) == arms["refdig"]
    finally:
        svc.stop()
    svc = SearchService(str(tmp_path / "m"), stacked=True, device="cpu")
    try:
        jobs = _run_arm(svc, [_spec(arms["beam"]),
                              _spec(arms["beam"], sp_threshold=6.5)])
        assert [j.status for j in jobs] == ["done", "done"]
        scheds = [e for e in svc.events.tail(1000)
                  if e["kind"] == "schedule"]
        assert scheds[0]["occupancy"] == 2
        assert "degrade" in _kinds(svc)
        assert svc.scheduler.stats()["stacked_jobs"] == 0
        assert artifact_digests(jobs[0].workdir) == arms["refdig"]
    finally:
        svc.stop()


def test_check_stackable_and_stack_plans():
    cfg = SurveyConfig(**CFG)

    def job(i, c=cfg, bucket="b", run=None, kind="survey"):
        return Job(job_id="j%d" % i, rawfiles=[], cfg=c, workdir="/tmp",
                   bucket=bucket, run=run, kind=kind)
    StackedBatchExecutor.check_stackable([job(0), job(1)])
    other = SurveyConfig(**dict(CFG, sp_threshold=6.5))
    assert stack_signature(other) != stack_signature(cfg)
    for bad in ([job(0)], [job(0), job(1, run=lambda j: {})],
                [job(0), job(1, c=other)], [job(0), job(1, bucket="c")],
                [job(0, kind="fold"), job(1, kind="fold")],
                [job(0, c=SurveyConfig(**dict(CFG, elastic=True))),
                 job(1, c=SurveyConfig(**dict(CFG, elastic=True)))]):
        with pytest.raises(StackIncompatible):
            StackedBatchExecutor.check_stackable(bad)
    assert plan_stack_sizes(9, 4, "exact") == [4, 4, 1]
    assert plan_stack_sizes(7, 4, "pow2") == [4, 2, 1]


def test_device_error_evicts_the_devices_plans(tmp_path, arms):
    """A CUDA out-of-memory on a job's first attempt: the scheduler
    evicts the plans bound to the failing device (the CPU here) before
    the retry, which rebuilds them and writes the same bytes."""
    faults = TransientFaults(1, exc=torch.cuda.OutOfMemoryError)
    svc = SearchService(str(tmp_path / "svc"), stacked=False, device="cpu",
                        scheduler_cfg=SchedulerConfig(
                            backoff_base_s=0.01, fault_injector=faults))
    try:
        # a plan on this device, built before the failing job
        svc.provider.searcher(AccelConfig(zmax=0, numharm=2), 1.0, 2048)
        assert svc.plans.stats()["size"] == 1
        job = _run_arm(svc, [_spec(arms["beam"])])[0]
        assert job.status == "done" and job.attempts == 2
        evs = [e for e in svc.events.tail(1000) if e["kind"] == "plan-evict"]
        assert evs and any(e.get("evicted") == 1 for e in evs)
        fam = svc.obs.metrics.get("plancache_evictions_total")
        assert fam.labels(reason="device_error").value == 1
        assert svc.obs.metrics.get("serve_device_errors_total").value == 1
        assert artifact_digests(job.workdir) == arms["refdig"]
    finally:
        svc.stop()


def test_device_error_evicts_the_plans_of_the_service_device(tmp_path):
    """The eviction takes the device the service's plans are bound to,
    not the scheduler thread's current one: on a service on cuda:1 a
    device error evicts the cuda_1 plans and keeps a cuda_0 plan."""
    from presto_tpu_torch.serve.plancache import PlanKey
    svc = SearchService(str(tmp_path / "svc"), stacked=False,
                        device="cuda:1",
                        scheduler_cfg=SchedulerConfig(backoff_base_s=0.01))
    keys = {dev: PlanKey("accel", 0, n, "float32", (), 0, 2)
            for n, dev in ((2048, "cuda_0"), (4096, "cuda_1"))}
    for dev, key in keys.items():
        svc.plans.get(key, lambda: object(), device=dev)
    calls = []

    def tick(job):
        calls.append(job.attempts)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {}
    try:
        job = svc.submit_callable(tick)
        svc.start()
        deadline = time.time() + 30.0
        while job.status != "done" and time.time() < deadline:
            time.sleep(0.01)
        assert job.status == "done" and len(calls) == 2
        assert svc.plans.contains(keys["cuda_0"])
        assert not svc.plans.contains(keys["cuda_1"])
        fam = svc.obs.metrics.get("plancache_evictions_total")
        assert fam.labels(reason="device_error").value == 1
    finally:
        svc.stop()


@pytest.mark.parametrize("nshards", [2, 4])
def test_service_mesh_places_the_rows_over_its_devices(tmp_path, arms,
                                                       nshards):
    """A service with a mesh (logical CPU shards) places a stacked
    batch's merged fan-out, and a job alone, over the mesh by
    batch_sharding: every shard searches its rows (12 merged trials, 6
    alone), and every artifact is byte-equal to run_survey's."""
    from presto_tpu_torch.parallel import sharded
    from presto_tpu_torch.parallel.mesh import Mesh, batch_sharding
    mesh = Mesh((torch.device("cpu"),) * nshards)
    svc = SearchService(str(tmp_path / "svc"), stacked=True, device="cpu",
                        mesh=mesh)
    try:
        sharded.shard_launches.clear()
        jobs = _run_arm(svc, [_spec(arms["beam"]), _spec(arms["beam"])])
        stacked_shards = {k: v["trials"]
                          for k, v in sharded.shard_launches.items()}
        sharded.shard_launches.clear()
        jobs += _run_arm(svc, [_spec(arms["beam"])])
        alone_shards = {k: v["trials"]
                        for k, v in sharded.shard_launches.items()}
        kinds = _kinds(svc)
    finally:
        svc.stop()
    assert [j.status for j in jobs] == ["done"] * 3
    assert "degrade" not in kinds
    assert [j.result.get("stacked") for j in jobs] == [2, 2, None]
    for trials, got in ((12, stacked_shards), (6, alone_shards)):
        want = {k: hi - lo for k, (_d, (lo, hi))
                in enumerate(batch_sharding(mesh, trials)) if hi > lo}
        assert got == want and sum(got.values()) == trials
    for job in jobs:
        assert artifact_digests(job.workdir) == arms["refdig"]


def test_service_mesh_with_a_sharded_deposit(tmp_path, arms):
    """With two logical devices visible prepsubband deposits a DM-sharded
    block: a stacked pair refuses it (StackedSeamError) and degrades to
    per-job runs (which resume from the journal: the trials are on disk
    by then), and a job alone over the service's mesh keeps the block's
    shards as they are; every artifact byte-equal to run_survey's."""
    from presto_tpu_torch.parallel import sharded
    from presto_tpu_torch.parallel.mesh import Mesh, set_logical_devices
    cpu = torch.device("cpu")
    with set_logical_devices(2, "cpu"):
        svc = SearchService(str(tmp_path / "svc"), stacked=True,
                            device="cpu", mesh=Mesh((cpu,) * 2))
        try:
            jobs = _run_arm(svc, [_spec(arms["beam"]), _spec(arms["beam"])])
            kinds = _kinds(svc)
            sharded.shard_launches.clear()
            jobs += _run_arm(svc, [_spec(arms["beam"])])
            shards = {k: v["trials"]
                      for k, v in sharded.shard_launches.items()}
        finally:
            svc.stop()
    assert [j.status for j in jobs] == ["done"] * 3
    assert "degrade" in kinds
    assert shards == {0: 3, 1: 3}
    for job in jobs:
        assert artifact_digests(job.workdir) == arms["refdig"]


def test_prewarm_from_the_plan_store(tmp_path, arms):
    """A second service on the same store prewarms every recorded plan
    (warm fraction 0 -> 1) and its job hits the cache with no build."""
    store = str(tmp_path / "store")
    svc = SearchService(str(tmp_path / "a"), device="cpu",
                        plan_store_dir=store)
    try:
        _run_arm(svc, [_spec(arms["beam"])])
    finally:
        svc.stop()
    svc2 = SearchService(str(tmp_path / "b"), device="cpu",
                         plan_store_dir=store)
    try:
        assert svc2.warm_fraction() == 0.0
        assert svc2.readyz()["plan_warm_fraction"] == 0.0
        assert svc2.prewarm() == 1
        assert svc2.warm_fraction() == 1.0
        before = svc2.plans.stats()
        job = _run_arm(svc2, [_spec(arms["beam"])])[0]
        after = svc2.plans.stats()
        assert job.status == "done"
        assert after["hits"] == before["hits"] + 1
        assert after["misses"] == before["misses"] == 1
        assert artifact_digests(job.workdir) == arms["refdig"]
        assert svc2.readyz()["plan_store"]["known_plans"] == 1
    finally:
        svc2.stop()


def test_survey_config_hooks(tmp_path, arms):
    """SurveyConfig's plan_provider, obs and tune hooks on run_survey: a
    provider's plan is used, telemetry and tuned.json are written beside
    the artifacts, and the artifacts are the untouched run's."""
    from presto_tpu_torch.obs import Observability, ObsConfig
    from presto_tpu_torch.serve.plancache import PlanCache, SearcherProvider
    obs = Observability(ObsConfig(enabled=True))
    prov = SearcherProvider(PlanCache(obs=obs), device="cpu")
    work = str(tmp_path / "w")
    run_survey([arms["beam"]], SurveyConfig(plan_provider=prov, obs=obs,
                                            tune=True, **CFG),
               work, device="cpu")
    assert artifact_digests(work) == arms["refdig"]
    assert prov.cache.stats()["misses"] == 1
    assert os.path.exists(os.path.join(work, "tuned.json"))
    assert os.path.exists(os.path.join(work, "kernel_costs.json"))
    names = {s.name for s in obs.tracer.finished()}
    assert {"survey", "stage:realfft+accelsearch (fused)"} <= names
    assert glob.glob(os.path.join(work, "*.singlepulse"))
