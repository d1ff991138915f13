"""The port's serve core (presto_tpu_torch/{obs, serve}, utils/timing.
LatencyStats, io/quality.publish) against the JAX package's on the CPU.

  * MetricsRegistry: the same operations give the same Prometheus text,
    snapshot and export state as the JAX registry.
  * Tracer spans (nesting, cross-thread parents, the wire context) and
    the chrome trace; the flight recorder's dump; Observability.flush.
  * EventLog: since= resume exactly once, aged-out events counted,
    heartbeats.
  * Lanes: the deadline lane pops first, force-submit bypasses the
    depth bound, the retry budget ends a poisoned job.
  * The scheduler: submit_callable on the deadline lane, retries with
    backoff, device errors classified by is_device_error on the torch
    exceptions a CUDA failure raises.
  * SearchService over start_http: /healthz, /readyz, /metrics (JSON and
    Prometheus), /events?since=, /jobs; survey and DAG jobs and the
    item-2 constructor arguments refused with the ROADMAP item named.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu.io.quality import DataQualityReport as JReport
from presto_tpu.obs import Observability as JObservability
from presto_tpu.obs import ObsConfig as JObsConfig
from presto_tpu.obs.metrics import MetricsRegistry as JRegistry
from presto_tpu.obs.trace import Tracer as JTracer
from presto_tpu.obs.trace import chrome_trace as jchrome_trace
from presto_tpu.serve.events import EventLog as JEventLog
from presto_tpu.utils.timing import LatencyStats as JLatencyStats

from presto_tpu_torch import cuda_build
from presto_tpu_torch.io.quality import DataQualityReport
from presto_tpu_torch.obs import (NOOP_SPAN, Observability, ObsConfig,
                                  SpanContext, configure, find_dumps,
                                  get_obs, resolve_obs)
from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.obs.trace import Tracer, chrome_trace
from presto_tpu_torch.serve import (EventLog, Job, JobQueue, JobTimeout,
                                    QueueClosed, QueueFull, Scheduler,
                                    SchedulerConfig, SearchService,
                                    is_device_error, start_http)
from presto_tpu_torch.serve.queue import RetryBudgetExceeded
from presto_tpu_torch.serve.plancache import PlanCache
from presto_tpu_torch.testing.chaos import TransientFaults
from presto_tpu_torch.utils.timing import LatencyStats


# ----------------------------------------------------------------------
# Metrics registry
# ----------------------------------------------------------------------

def _exercise(reg):
    """The same sequence of registry operations on either package's
    registry."""
    c = reg.counter("jobs_total", "Jobs\nseen")
    c.inc()
    c.inc(2.5)
    lab = reg.counter("lane_total", "By lane", ("lane",))
    lab.labels(lane="deadline").inc(3)
    lab.labels(lane='thr"ough\\put').inc()
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.dec(2)
    g.set_max(4)
    g.set_max(11)
    h = reg.histogram("lat_seconds", "Latency", ("stream", "beam"),
                      buckets=(0.01, 0.1, 1.0, 10.0), window=3)
    for v in (0.005, 0.05, 0.5, 5.0, 50.0, 0.1):
        h.labels(stream="s", beam="-").observe(v)
    solo = reg.histogram("solo_seconds", "Solo")
    solo.observe(0.25)
    with pytest.raises(ValueError):
        reg.counter("depth")                 # kind mismatch
    if reg.enabled:                          # disabled: one branch, no check
        with pytest.raises(ValueError):
            c.inc(-1)
    with pytest.raises(ValueError):
        lab.labels(beam="x")
    return h


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["enabled", "disabled"])
def test_metrics_registry_matches_jax(enabled):
    """Prometheus text, snapshot, export state and percentiles of the
    same operations are equal to the JAX registry's; a disabled
    registry records nothing in both."""
    reg, jreg = MetricsRegistry(enabled=enabled), JRegistry(enabled=enabled)
    h, jh = _exercise(reg), _exercise(jreg)
    assert reg.render_prometheus() == jreg.render_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.export_state() == jreg.export_state()
    hs, jhs = (x.labels(stream="s", beam="-") for x in (h, jh))
    assert hs.percentiles((50, 90, 99)) == jhs.percentiles((50, 90, 99))
    assert hs.samples() == jhs.samples()
    assert reg.get("lane_total").total() == jreg.get("lane_total").total()
    if enabled:
        assert 'lane_total{lane="thr\\"ough\\\\put"} 1' in \
            reg.render_prometheus()
        assert hs.samples() == [5.0, 50.0, 0.1]      # window of 3
    else:
        assert reg.get("jobs_total").value == 0


def test_latency_stats_matches_jax():
    stats, jstats = LatencyStats(window=4), JLatencyStats(window=4)
    for i, v in enumerate((0.3, 0.1, 0.9, 0.2, 0.7, 0.05)):
        for s in (stats, jstats):
            s.record("job_exec" if i % 2 else "job_total", v)
    assert stats.snapshot() == jstats.snapshot()
    assert stats.percentiles("job_exec") == jstats.percentiles("job_exec")
    assert stats.registry.render_prometheus() == \
        jstats.registry.render_prometheus()


def test_quality_publish_matches_jax():
    """DataQualityReport.publish folds the same tallies into the
    registry as the JAX report does."""
    text = []
    for report_cls, reg in ((DataQualityReport, MetricsRegistry()),
                            (JReport, JRegistry())):
        rep = report_cls(path="x.fil", nchan=8)
        rep.add(0, 100, "zero-fill")
        rep.add(500, 520, "stall")
        rep.add(90, 150, "zero-fill")
        rep.scrubbed_samples = 17
        rep.publish(reg)
        report_cls(path="y.fil", nchan=8).publish(reg)   # clean report
        text.append(reg.render_prometheus())
    assert text[0] == text[1]
    assert 'ingest_quarantined_spectra_total{reason="zero-fill"} 150' \
        in text[0]
    assert "ingest_reports_total 2" in text[0]


# ----------------------------------------------------------------------
# Tracing, flight recorder, Observability
# ----------------------------------------------------------------------

def _trace_tree(tracer):
    root = tracer.span("root", job="j1")
    with tracer.span("child", step=1) as child:
        inner = tracer.span("inner")
        inner.finish()
    ctx = tracer.context()
    box = {}

    def worker():
        sp = tracer.span("worker", parent=ctx)
        box["tid"] = sp.thread
        sp.finish("error: Boom")

    t = threading.Thread(target=worker, name="w-thread")
    t.start()
    t.join(5.0)
    root.finish()
    return root, child, inner


def test_tracer_spans_and_chrome_trace_match_jax():
    """Nesting by context, explicit cross-thread parents and statuses
    give the same span tree in both packages; the chrome trace has the
    same events (names, phases, threads, args) but the category."""
    trees = []
    for cls, chrome in ((Tracer, chrome_trace), (JTracer, jchrome_trace)):
        tracer = cls(enabled=True)
        root, child, inner = _trace_tree(tracer)
        spans = tracer.finished()
        by = {s.name: s for s in spans}
        assert by["child"].parent_id == root.span_id
        assert by["inner"].parent_id == child.span_id
        assert by["worker"].parent_id == root.span_id
        assert len({s.trace_id for s in spans}) == 1
        assert tracer.open_spans() == [] and tracer.current() is None
        ev = chrome(spans)
        trees.append((
            [(s.name, s.status, s.thread, sorted(s.to_json())) for s in
             spans],
            [(e["name"], e["ph"], e["tid"],
              sorted(e["args"]) if e["ph"] == "X" else e["args"])
             for e in ev["traceEvents"]]))
    assert trees[0] == trees[1]
    assert trees[0][0][-1][1] == "ok"            # root
    assert ("worker", "error: Boom", "w-thread") == trees[0][0][2][:3]


def test_span_context_wire_form():
    ctx = SpanContext("a" * 32, "b" * 16)
    assert SpanContext.from_dict(ctx.to_dict()).span_id == "b" * 16
    assert SpanContext.from_dict(None) is None
    assert SpanContext.from_dict({"span_id": "x"}) is None
    tracer = Tracer(enabled=False)
    assert tracer.span("x") is NOOP_SPAN and NOOP_SPAN.context() is None


def test_flight_recorder_dump_and_flush(tmp_path):
    """An enabled handle's flight recorder keeps events and finished
    spans and dumps them with the open spans and a metrics snapshot;
    flush writes the chrome trace and spans.jsonl; a disabled handle
    writes nothing, as in the JAX package."""
    obs = Observability(ObsConfig(enabled=True, flightrec_capacity=3))
    jobs = JObservability(JObsConfig(enabled=True, flightrec_capacity=3))
    for o in (obs, jobs):
        o.metrics.counter("ticks_total").inc()
        o.event("chaos-point", name="beam-tick")
        with o.span("stage:a"):
            pass
        o.event("note", n=1)
        o.event("note", n=2)
    recs = [[r["kind"] for r in o.flightrec.records()] for o in (obs, jobs)]
    assert recs[0] == recs[1] == ["span", "note", "note"]
    assert obs.flightrec.last("span")["name"] == "stage:a"
    open_span = obs.span("dying")
    path = obs.dump_flight(str(tmp_path / "w"), "SimulatedCrash")
    dump = json.load(open(path))
    assert dump["reason"] == "SimulatedCrash"
    assert [s["name"] for s in dump["open_spans"]] == ["dying"]
    assert dump["metrics"]["ticks_total"]["series"][0]["value"] == 1.0
    assert find_dumps(str(tmp_path / "w")) == [path]
    open_span.finish()
    obs.flush(default_dir=str(tmp_path / "trace"))
    trace = json.load(open(tmp_path / "trace" / "trace.perfetto.json"))
    assert {e["name"] for e in trace["traceEvents"]} >= {"stage:a",
                                                         "dying"}
    assert len(open(tmp_path / "trace" / "spans.jsonl").readlines()) == 2
    off = Observability()
    assert off.span("x") is NOOP_SPAN
    off.event("x")
    assert off.dump_flight(str(tmp_path / "off"), "x") is None
    off.flush(default_dir=str(tmp_path / "off"))
    assert not (tmp_path / "off").exists()


def test_obs_process_default_and_resolve(monkeypatch):
    import presto_tpu_torch.obs as obs_mod
    monkeypatch.setattr(obs_mod, "_default", None)
    assert not get_obs().enabled          # disabled until configure()
    obs = configure(ObsConfig(enabled=True))
    assert obs.enabled and get_obs() is obs
    assert resolve_obs(None) is obs and resolve_obs(obs) is obs
    assert not resolve_obs(ObsConfig()).enabled
    with pytest.raises(TypeError):
        resolve_obs("on")
    configure(ObsConfig())


# ----------------------------------------------------------------------
# Event log
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cls", [EventLog, JEventLog], ids=["port", "jax"])
def test_event_log_since_resume_exactly_once(cls):
    log = cls(keep=100)
    for i in range(5):
        log.emit("enqueue", i=i)
    evs, lost, latest = log.since(0)
    assert [e["seq"] for e in evs] == [1, 2, 3, 4, 5]
    assert lost == 0 and latest == 5 and log.cursor() == 5
    evs2, lost2, _ = log.since(3)
    assert [e["seq"] for e in evs2] == [4, 5] and lost2 == 0
    assert log.since(5) == ([], 0, 5)
    evs3, _, latest3 = log.since(0, limit=2)
    assert [e["seq"] for e in evs3] == [1, 2] and latest3 == 5
    small = cls(keep=4)
    for i in range(10):
        small.emit("enqueue", i=i)
    evs, lost, latest = small.since(2)
    # the ring holds 7..10; events 3..6 aged out and are counted
    assert [e["seq"] for e in evs] == [7, 8, 9, 10]
    assert lost == 4 and latest == 10
    assert small.counts() == {"enqueue": 10}


def test_event_log_file_and_heartbeat(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path=path)
    log.emit("trigger", dm=20.0)
    log.start_heartbeat(0.05)
    time.sleep(0.3)
    log.close()
    assert log.counts().get("heartbeat", 0) >= 2
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["kind"] == "trigger" and lines[0]["seq"] == 1
    assert [x["seq"] for x in lines] == list(range(1, len(lines) + 1))


# ----------------------------------------------------------------------
# Lanes and the queue
# ----------------------------------------------------------------------

def _job(jid, **kw):
    return Job(job_id=jid, rawfiles=[], cfg=None, workdir=".", **kw)


def test_deadline_lane_pops_before_throughput():
    q = JobQueue(maxdepth=8)
    for i in range(3):
        q.submit(_job("t%d" % i, priority=0))
    q.submit(_job("d0", priority=99, lane="deadline"))
    # the deadline job beats every throughput job despite its worse
    # priority; coalescing never mixes lanes
    assert [j.job_id for j in q.pop_batch(max_batch=4)] == ["d0"]
    assert [j.job_id for j in q.pop_batch(max_batch=4)] == \
        ["t0", "t1", "t2"]
    assert q.pop_batch(max_batch=4, timeout=0.01) == []


def test_force_submit_bypasses_depth_and_retry_budget():
    q = JobQueue(maxdepth=1, max_retry_depth=1)
    q.submit(_job("a"))
    with pytest.raises(QueueFull):
        q.submit(_job("b"))
    with pytest.raises(QueueFull):
        q.submit(_job("b"), block=True, timeout=0.05)
    q.submit(_job("tick", lane="deadline"), force=True)
    assert len(q) == 2
    retry = _job("r")
    q.requeue(retry)
    with pytest.raises(RetryBudgetExceeded):
        q.requeue(retry)
    q.close()
    with pytest.raises(QueueClosed):
        q.submit(_job("late"))
    while len(q):
        q.pop_batch()
    with pytest.raises(QueueClosed):
        q.pop_batch(timeout=0.01)


# ----------------------------------------------------------------------
# Scheduler and device errors
# ----------------------------------------------------------------------

@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                 "allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("CUDA error: an illegal memory access was "
                  "encountered"), True),
    (RuntimeError("cuFFT error: CUFFT_INTERNAL_ERROR"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling "
                  "cublasSgemm"), True),
    (RuntimeError("boom"), False),
    (RuntimeError("presto_tpu_torch: no CUDA device is available; "
                  "pass device='cpu' to run the plain versions"), False),
    (ValueError("CUDA error: device-side assert triggered"), False),
    (JobTimeout("exceeded 1s job budget"), False),
], ids=["oom", "device_assert", "illegal_access", "cufft", "launch",
        "cublas", "plain", "no_device", "not_runtime", "timeout"])
def test_is_device_error_on_torch_exceptions(exc, want):
    assert is_device_error(exc) is want


def test_is_device_error_on_accelerator_error_and_entry_points():
    """torch's AcceleratorError (the type of a CUDA error since torch
    2.8) and the port's own C entry points' errors are device errors."""
    if hasattr(torch, "AcceleratorError"):
        assert is_device_error(torch.AcceleratorError("CUDA error"))
    with pytest.raises(RuntimeError) as ei:
        cuda_build.check(700, "plane_build")
    assert is_device_error(ei.value)


def test_scheduler_retries_counts_device_errors_and_gives_up():
    """A callable that fails with a CUDA device error twice then works
    is retried with backoff and counted on serve_device_errors_total; a
    poisoned job fails after its retries; plans= takes the plan cache
    whose device's plans a device error evicts."""
    q = JobQueue()
    calls = []

    def run(job):
        calls.append(job.attempts)
        return {"ok": True}

    sched = Scheduler(q, lambda job: job.run(job),
                      cfg=SchedulerConfig(max_retries=2,
                                          backoff_base_s=0.01,
                                          poll_s=0.01,
                                          fault_injector=TransientFaults(
                                              2, exc=torch.cuda.
                                              OutOfMemoryError,
                                              match=lambda j:
                                              j.job_id == "flaky")),
                      events=EventLog()).start()
    try:
        flaky = _job("flaky", run=run)
        dead = _job("dead", run=lambda job: 1 / 0)
        q.submit(flaky)
        q.submit(dead)
        deadline = time.time() + 10.0
        while time.time() < deadline and not (
                flaky.status == "done" and dead.status == "failed"):
            time.sleep(0.01)
        assert flaky.status == "done" and flaky.attempts == 3
        assert calls == [3] and flaky.result == {"ok": True}
        assert dead.status == "failed" and "ZeroDivisionError" in dead.error
        st = sched.stats()
        assert st["jobs_done"] == 1 and st["jobs_failed"] == 1
        assert st["retries"] == 4 and st["stacked_batches"] == 0
        dev = sched.obs.metrics.get("serve_device_errors_total")
        assert dev.value == 2
    finally:
        sched.stop()
    cache = PlanCache(capacity=2)
    assert Scheduler(JobQueue(), lambda j: None, plans=cache).plans is cache


def test_scheduler_job_timeout():
    q = JobQueue()
    sched = Scheduler(q, lambda job: time.sleep(1.0),
                      cfg=SchedulerConfig(job_timeout_s=0.05,
                                          max_retries=0, poll_s=0.01)
                      ).start()
    try:
        job = _job("slow")
        q.submit(job)
        deadline = time.time() + 10.0
        while job.status != "timeout" and time.time() < deadline:
            time.sleep(0.01)
        assert job.status == "timeout" and "JobTimeout" in job.error
    finally:
        sched.stop()


# ----------------------------------------------------------------------
# SearchService and its HTTP front end
# ----------------------------------------------------------------------

def _get(url, accept=None):
    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_submit_callable_runs_on_the_deadline_lane(tmp_path):
    svc = SearchService(str(tmp_path)).start()
    try:
        done = threading.Event()
        job = svc.submit_callable(
            lambda j: (done.set(), {"ran": True})[1])
        assert done.wait(10.0)
        deadline = time.time() + 10.0
        while job.status != "done" and time.time() < deadline:
            time.sleep(0.01)
        assert job.status == "done" and job.result == {"ran": True}
        assert job.lane == "deadline"
        lanes = svc.obs.metrics.get("serve_lane_batches_total")
        assert lanes.labels(lane="deadline").value >= 1
        assert svc.latency.snapshot()["job_exec"]["count"] == 1
    finally:
        svc.stop()


def test_http_front_end(tmp_path):
    """/healthz, /readyz, /metrics (JSON and Prometheus), /events with
    since=, /jobs over start_http; POST /submit of a survey whose file
    has no filterbank header answers 400, a DAG node job of an unknown
    kind 400 and a fold node job 202 (serve/dag runs it), a malformed
    one 400."""
    svc = SearchService(str(tmp_path), heartbeat_s=0.05,
                        device="cpu").start()
    httpd = start_http(svc)
    base = "http://%s:%d" % httpd.server_address[:2]
    try:
        code, _, body = _get(base + "/healthz")
        h = json.loads(body)
        assert code == 200 and h["ok"] and h["scheduler_alive"]
        code, _, body = _get(base + "/readyz")
        assert code == 200 and json.loads(body)["ready"]
        code, ctype, body = _get(base + "/metrics")
        assert code == 200 and ctype == "application/json"
        assert json.loads(body)["scheduler"]["alive"]
        code, ctype, body = _get(base + "/metrics", accept="text/plain")
        assert code == 200 and ctype.startswith("text/plain")
        text = body.decode()
        assert "# TYPE serve_jobs_done_total counter" in text
        assert 'serve_jobs{status="queued"} 0' in text
        assert "serve_uptime_seconds" in text
        code, _, body = _get(base + "/metrics?format=prometheus")
        assert body.decode().startswith("# HELP")
        time.sleep(0.3)
        code, _, body = _get(base + "/events")
        first = json.loads(body)
        assert code == 200 and first["cursor"] >= 2
        code, _, body = _get(base + "/events?since=%d" % first["cursor"])
        resumed = json.loads(body)
        assert resumed["lost"] == 0
        assert all(e["seq"] > first["cursor"] for e in resumed["events"])
        code, out = _post(base + "/submit",
                          json.dumps({"rawfiles": [__file__]}).encode())
        assert code == 400 and "observation header" in out["error"]
        code, out = _post(base + "/submit", json.dumps(
            {"kind": "bogus", "parents": []}).encode())
        assert code == 400 and "dag node kind" in out["error"]
        code, out = _post(base + "/submit", json.dumps(
            {"kind": "fold", "parents": []}).encode())
        assert code == 202 and out["job_id"].startswith("fold-")
        code, out = _post(base + "/submit", b"{not json")
        assert code == 400
        code, out = _post(base + "/submit", json.dumps(
            {"rawfiles": ["/no/such.fil"]}).encode())
        assert code == 400 and "not found" in out["error"]
        code, out = _post(base + "/nope", b"{}")
        assert code == 404
        assert _get(base + "/jobs/nope")[0] == 404
        assert _get(base + "/jobs/nope/result")[0] == 404
        assert _get(base + "/nowhere")[0] == 404
    finally:
        httpd.shutdown()
        svc.stop()
    assert svc.readyz()["ready"] is False


def test_survey_and_dag_jobs_and_item2_arguments_refused(tmp_path):
    """ROADMAP queue 1 item 2's arguments are taken (plan_store_dir,
    a mesh of the service's device type, stacked=True); a survey job or
    a DAG node job on a "cuda" service raises without a card (nothing
    falls back to the CPU); on a CPU service a DAG node job builds (item
    3 took the refusal away) and an unknown node kind is a bad
    request."""
    from presto_tpu_torch.serve.server import BadRequest
    svc = SearchService(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.submit({"rawfiles": [__file__], "config": {"lodm": 10}})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.build_job({"kind": "fold", "parents": []})
    cpu = SearchService(str(tmp_path), device="cpu")
    node = cpu.build_job({"kind": "fold", "parents": []})
    assert node.kind == "fold" and node.rawfiles == []
    with pytest.raises(BadRequest, match="dag node kind"):
        cpu.build_job({"kind": "bogus"})
    store = SearchService(str(tmp_path), plan_store_dir=str(tmp_path / "p"),
                          device="cpu")
    assert store.plan_store is not None and store.readyz()["plan_store"][
        "supported"] is True
    from presto_tpu_torch.parallel.mesh import Mesh
    cpu2 = Mesh((torch.device("cpu"),) * 2)
    assert SearchService(str(tmp_path), mesh=cpu2, device="cpu").mesh is cpu2
    # a mesh is a parallel/mesh.Mesh of the service's device type
    for bad, dev in ((("cpu", "cpu"), "cpu"), (cpu2, "cuda")):
        with pytest.raises(ValueError, match="mesh"):
            SearchService(str(tmp_path), mesh=bad, device=dev)
    assert SearchService(str(tmp_path), stacked=True).stacked is True
    assert SearchService(str(tmp_path), stacked=False).stacked is False


def test_metrics_and_readyz_keep_the_jax_shape(tmp_path):
    """metrics() and readyz() carry the JAX service's keys; the plan
    cache's block holds an empty cache's values and kernel_costs is
    empty, exactly what a fresh JAX service reports."""
    from presto_tpu.serve.server import SearchService as JSearchService
    svc = SearchService(str(tmp_path / "port"), plan_capacity=12)
    jsvc = JSearchService(str(tmp_path / "jax"), plan_capacity=12,
                          stacked=False)
    try:
        m, jm = svc.metrics(), jsvc.metrics()
        assert sorted(m) == sorted(jm)
        assert m["plans"] == jm["plans"]
        assert m["kernel_costs"] == jm["kernel_costs"] == {}
        assert sorted(m["scheduler"]) == sorted(jm["scheduler"])
        r, jr = svc.readyz(), jsvc.readyz()
        assert r == jr
        assert sorted(svc.healthz()) == sorted(jsvc.healthz())
        report = svc.shutdown(timeout=1.0)
        assert report == {"drained": True, "parked": 0, "released": 0}
    finally:
        jsvc.stop()


def test_queue_backpressure_on_the_service(tmp_path):
    """Throughput callables hit the depth bound (QueueFull); deadline
    ones are forced past it; a stopped service's queue is closed."""
    svc = SearchService(str(tmp_path), queue_depth=1)
    svc.submit_callable(lambda j: {}, lane="throughput")
    with pytest.raises(QueueFull):
        svc.submit_callable(lambda j: {}, lane="throughput")
    svc.submit_callable(lambda j: {}, lane="deadline")
    assert len(svc.queue) == 2
    svc.start()
    assert svc.scheduler.drain(timeout=10.0)
    svc.stop()
    with pytest.raises(QueueClosed):
        svc.submit_callable(lambda j: {})
    assert np.isfinite(svc.metrics()["uptime_s"])


def test_enqueued_callable_job_lookup_and_http(tmp_path):
    """A callable Job admitted with enqueue_job is registered for lookup:
    get_job/status/result/wait in-process and /jobs/<id>(/result) over
    HTTP (409 until the job is terminal)."""
    svc = SearchService(str(tmp_path)).start()
    httpd = start_http(svc)
    base = "http://%s:%d" % httpd.server_address[:2]
    gate = threading.Event()
    try:
        job = Job(job_id="cb-1", rawfiles=[], cfg=None,
                  workdir=str(tmp_path),
                  run=lambda j: (gate.wait(10.0), {"x": 1})[1])
        view = svc.enqueue_job(job)
        assert view["job_id"] == "cb-1" and view["lane"] == "throughput"
        assert svc.get_job("cb-1") is job
        code, _, body = _get(base + "/jobs/cb-1/result")
        assert code == 409
        assert not svc.wait("cb-1", timeout=0.1)
        gate.set()
        assert svc.wait(["cb-1"], timeout=10.0)
        assert svc.status("cb-1")["status"] == "done"
        assert svc.result("cb-1")["result"] == {"x": 1}
        code, _, body = _get(base + "/jobs/cb-1")
        assert code == 200 and json.loads(body)["status"] == "done"
        code, _, body = _get(base + "/jobs/cb-1/result")
        assert code == 200 and json.loads(body)["result"] == {"x": 1}
        assert svc.metrics()["jobs"] == {"done": 1}
        assert svc.status("nope") is None and svc.result("nope") is None
    finally:
        httpd.shutdown()
        svc.stop()
