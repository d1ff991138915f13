"""SearchService + threaded HTTP front end (serve layer).

PyTorch counterpart of ``presto_tpu/serve/server.py``: the composition
root owning the bounded queue, the plan cache (serve/plancache), the
event log, the latency accounting and the micro-batching scheduler.  A
survey job runs as one restartable ``pipeline.survey.run_survey`` on
the service's ``device`` (default "cuda"; a CPU service must be asked
for) in the job's own workdir, so every result is byte-identical to
what run_survey writes on its own; same-bucket jobs coalesced into one
batch run through the stacked executor (serve/batchexec,
``stacked=True``, the default) and degrade to per-job runs on any
failure.  A
``mesh`` (parallel/mesh.Mesh) places the rows of every survey job's
device middle over its devices (run_survey_stacked: a stacked batch's
merged fan-out, or one job's), each device running the FFT, the search
kernels and the single-pulse search of its rows.  A
``plan_store_dir`` (serve/plancache.PlanStore) records every plan built,
so a second service on the same store prewarms (``prewarm``, readyz's
``plan_warm_fraction``).
In-process callable jobs (the live stream's deadline-lane ticks) share
the scheduler.  A discovery-DAG node job (``kind`` sift, triage, fold
or toa) runs its serve/dag executor on the service's device; a
serve/fleet.FleetReplica wrapped around the service leases survey and
node jobs from a fleet's job ledger.

The wire protocol is plain HTTP + JSON over stdlib `http.server`
(ThreadingHTTPServer; one thread per connection, the scheduler thread
does the device work):

  POST /submit            {"rawfiles": [...], "config": {...},
                           "priority": int}      -> 202 {job_id, ...}
                          429 when the queue applies backpressure
  GET  /jobs/<id>         job status snapshot
  GET  /jobs/<id>/result  terminal result payload (409 until terminal)
  GET  /healthz           liveness: queue + scheduler state
  GET  /readyz            readiness: draining / scheduler alive / plan
                          warm fraction / fleet lease state
  GET  /metrics           queue/scheduler/latency snapshot (JSON), or
                          Prometheus text for `Accept: text/plain`
  GET  /events?n=100      tail of the structured event log
                          (?since=<cursor> resumes exactly once)
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import fields as dataclass_fields
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import urlparse, parse_qs

from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.plancache import (PlanCache, PlanStore,
                                              SearcherProvider, bucket_key)
from presto_tpu_torch.serve.queue import (Job, JobQueue, JobStatus,
                                          QueueClosed, QueueFull)
from presto_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig
from presto_tpu_torch.utils.timing import LatencyStats, StageTimer


class BadRequest(ValueError):
    """Malformed submission (HTTP 400)."""


def _allowed_config_fields():
    """SurveyConfig fields settable over the wire: everything except the
    object-valued hooks (plan_provider, sift_policy, fault_injector,
    obs: in-process only)."""
    from presto_tpu_torch.pipeline.survey import SurveyConfig
    blocked = {"plan_provider", "sift_policy", "fault_injector", "obs"}
    return {f.name for f in dataclass_fields(SurveyConfig)
            if f.name not in blocked}


def _checked_mesh(mesh, device):
    """``mesh`` when it is a parallel/mesh.Mesh of the service's device
    type (None passes); anything else raises ValueError."""
    import torch
    from presto_tpu_torch.parallel.mesh import Mesh
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise ValueError("SearchService: mesh must be a parallel/mesh.Mesh "
                         "(got %r)" % (mesh,))
    kind = torch.device(device).type
    if any(torch.device(d).type != kind for d in mesh.devices):
        raise ValueError("SearchService: a mesh over %s for a service on %s"
                         % ([str(d) for d in mesh.devices], device))
    return mesh


class SearchService:
    """The always-on search service (in-process API; server-agnostic).
    """

    def __init__(self, workroot: str, queue_depth: int = 64,
                 plan_capacity: int = 32,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 events_path: Optional[str] = None, mesh=None,
                 max_retry_depth: Optional[int] = 8, obs=None,
                 obs_config=None, heartbeat_s: float = 0.0,
                 plan_store_dir: Optional[str] = None,
                 stacked: Optional[bool] = None, device="cuda"):
        from presto_tpu_torch.obs import Observability, ObsConfig
        os.makedirs(workroot, exist_ok=True)
        self.workroot = os.path.abspath(workroot)
        #: the device survey jobs run on (resolved when one is admitted,
        #: so a service of callable jobs needs no card)
        self.device = device
        # a resident service is always observed (a server without
        # /metrics is blind); pass `obs`/`obs_config` to share or tune
        # the handle — e.g. a trace_dir for span export
        self.obs = obs or Observability(
            obs_config or ObsConfig(enabled=True,
                                    service="presto-serve"))
        self.events = EventLog(path=events_path)
        if heartbeat_s > 0:
            self.events.start_heartbeat(heartbeat_s)
        self.latency = LatencyStats(registry=self.obs.metrics)
        self.queue = JobQueue(maxdepth=queue_depth,
                              max_retry_depth=max_retry_depth)
        self.plans = PlanCache(capacity=plan_capacity, events=self.events,
                               obs=self.obs)
        # persistent plan tier: every plan built is recorded for a
        # later prewarm
        self.plan_store: Optional[PlanStore] = None
        if plan_store_dir:
            self.plan_store = PlanStore(plan_store_dir, obs=self.obs)
            self.plan_store.enable()
        #: the devices a survey job's rows are placed over (None: the
        #: service's device alone)
        self.mesh = _checked_mesh(mesh, device)
        self.provider = SearcherProvider(self.plans, store=self.plan_store,
                                         device=device)
        self.scheduler = Scheduler(self.queue, self._execute_job,
                                   cfg=scheduler_cfg,
                                   events=self.events,
                                   latency=self.latency,
                                   obs=self.obs, plans=self.plans,
                                   plan_device=device)
        # cross-job stacked execution (serve/batchexec.py), the default:
        # a coalesced same-bucket batch runs its device chain as one
        # stacked call set, degrading to per-job runs on any
        # incompatibility or failure; off with stacked=False, or when a
        # subclass overrides job execution
        if stacked is None:
            stacked = (type(self)._execute_job
                       is SearchService._execute_job)
        self.stacked = bool(stacked)
        if self.stacked:
            from presto_tpu_torch.serve.batchexec import \
                StackedBatchExecutor
            self.scheduler.batch_executor = StackedBatchExecutor(self)
        self._jobs: Dict[str, Job] = {}
        self._jobs_lock = threading.Lock()  # presto-lint: guards(_jobs)
        self._ids = itertools.count(1)
        self._t0 = time.time()
        self.draining = False
        #: set by serve/fleet.FleetReplica when this service is a
        #: fleet member (readiness then reports the lease state)
        self.fleet = None

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "SearchService":
        self.scheduler.start()
        return self

    def stop(self) -> None:
        self.queue.close()
        self.scheduler.stop()
        self.events.close()
        self.obs.flush()
        self.obs.tracer.close()

    def shutdown(self, drain: bool = True,
                 timeout: float = 60.0) -> dict:
        """Graceful termination (the SIGTERM path): flip readiness off,
        drain in-flight and queued jobs, hand the fleet leases back
        (drained jobs commit; undrained ones are released for another
        replica), then stop.  Returns a small shutdown report."""
        self.draining = True
        report = {"drained": True, "parked": 0, "released": 0}
        if self.fleet is not None:
            # the fleet drain owns the whole sequence: stop leasing,
            # wait out in-flight work, release leftovers, tombstone
            report.update(self.fleet.drain(timeout=timeout))
        elif drain:
            report["drained"] = self.scheduler.drain(timeout=timeout)
        self.stop()
        return report

    # ---- plan warm-up --------------------------------------------------

    def prewarm(self, limit: Optional[int] = None) -> int:
        """Rebuild the plan store's recorded plans into the in-memory
        cache (0 without a store)."""
        return self.provider.prewarm(limit=limit)

    def warm_fraction(self) -> float:
        """Persistently-known plans resident in memory (1.0 without a
        store: nothing to wait for)."""
        if self.plan_store is None:
            return 1.0
        return self.plan_store.warm_fraction(self.plans)

    # ---- job admission ------------------------------------------------

    def build_job(self, spec: dict, job_id: Optional[str] = None,
                  workdir: Optional[str] = None) -> Job:
        """Validate one submission spec into a Job (not yet queued).
        spec:

          rawfiles  [str, ...]  (required; must exist)
          config    {SurveyConfig field: value}   (optional)
          priority  int (optional; lower runs first)
          job_id    str (optional; must be unique)

        Raises BadRequest on malformed specs; a service on "cuda" with
        no card raises RuntimeError.  ``job_id``/``workdir`` override
        the spec (the fleet replica pins both to the ledger job id and
        its epoch-stamped attempt directory).

        Discovery-DAG node specs (``kind`` sift/triage/fold/toa) are
        validated by serve/dag.build_node_job instead: they carry no
        rawfiles; their inputs are the parents' committed attempt
        dirs."""
        from presto_tpu_torch.pipeline.survey import SurveyConfig
        from presto_tpu_torch.search.accel import resolve_device
        if not isinstance(spec, dict):
            raise BadRequest("spec must be a JSON object")
        if str(spec.get("kind", "survey") or "survey") != "survey":
            from presto_tpu_torch.serve.dag import build_node_job
            resolve_device(self.device)
            return build_node_job(self, spec, job_id=job_id,
                                  workdir=workdir)
        rawfiles = spec.get("rawfiles")
        if not rawfiles or not isinstance(rawfiles, (list, tuple)):
            raise BadRequest("spec.rawfiles must be a non-empty list")
        rawfiles = [os.path.abspath(str(f)) for f in rawfiles]
        missing = [f for f in rawfiles if not os.path.exists(f)]
        if missing:
            raise BadRequest("rawfiles not found: %s" % missing)
        cfg_dict = spec.get("config") or {}
        if not isinstance(cfg_dict, dict):
            raise BadRequest("spec.config must be a JSON object")
        unknown = set(cfg_dict) - _allowed_config_fields()
        if unknown:
            raise BadRequest("unknown config fields: %s" % sorted(unknown))
        resolve_device(self.device)
        cfg = SurveyConfig(**cfg_dict)
        cfg.plan_provider = self.provider
        cfg.obs = self.obs          # job telemetry -> service registry
        if "durable_stages" not in cfg_dict:
            # serve jobs default to the fused tier (no .dat/.fft round
            # trips); a retried job is flipped back to the durable tier
            # by the scheduler; clients may pin either
            cfg.durable_stages = False
        job_id = str(job_id or spec.get("job_id")
                     or "job-%06d" % next(self._ids))
        with self._jobs_lock:
            old = self._jobs.get(job_id)
            if old is not None and old.status not in JobStatus.SETTLED:
                raise BadRequest("duplicate job_id %r" % job_id)
        try:
            bucket = bucket_key(rawfiles, cfg)
        except Exception as e:
            raise BadRequest("unreadable observation header: %s" % e)
        return Job(job_id=job_id, rawfiles=rawfiles, cfg=cfg,
                   workdir=workdir or os.path.join(self.workroot, job_id),
                   priority=int(spec.get("priority", 10)),
                   bucket=bucket, spec=dict(spec))

    def enqueue_job(self, job: Job) -> dict:
        """Admit a built Job into the local queue (may raise
        QueueFull / QueueClosed) and register it for /jobs lookup."""
        self.queue.submit(job)
        with self._jobs_lock:
            self._jobs[job.job_id] = job
        self.events.emit("enqueue", job=job.job_id,
                         bucket=repr(job.bucket),
                         priority=job.priority,
                         depth=len(self.queue))
        return job.view()

    def submit(self, spec: dict) -> dict:
        """Admit one search job (build + enqueue).  Raises BadRequest
        on malformed specs, QueueFull under backpressure.  Returns
        the job's status view."""
        if self.draining:
            raise QueueClosed("service is draining")
        return self.enqueue_job(self.build_job(spec))

    def submit_callable(self, fn, job_id: Optional[str] = None,
                        lane: str = "deadline", priority: int = 0,
                        bucket=None) -> Job:
        """Admit an in-process callable job (the streaming tick):
        `fn(job)` runs on the scheduler thread in lane order.  Deadline
        -lane callables bypass the depth bound — they are self-bounded
        by their submitter (at most one outstanding tick per stream),
        and shedding them behind a throughput backlog is exactly the
        SLO inversion the lane exists to prevent."""
        job = Job(job_id=job_id or "call-%06d" % next(self._ids),
                  rawfiles=[], cfg=None, workdir=self.workroot,
                  priority=priority, bucket=bucket, lane=lane, run=fn)
        self.queue.submit(job, force=(lane == "deadline"))
        self.events.emit("enqueue", job=job.job_id, lane=lane,
                         bucket=repr(bucket), priority=priority,
                         depth=len(self.queue))
        return job

    # ---- job execution (scheduler thread) -----------------------------

    def _execute_job(self, job: Job) -> dict:
        """Run one job on the scheduler thread: an in-process callable,
        a DAG node (its serve/dag executor), or a restartable survey in
        the job's workdir feeding the shared per-stage latency
        percentiles (a stack of one over the service's mesh when it has
        one)."""
        if job.run is not None:
            return job.run(job) or {}
        if getattr(job, "kind", "survey") != "survey":
            from presto_tpu_torch.serve.dag import execute_node
            return execute_node(self, job)
        from presto_tpu_torch.pipeline.survey import (run_survey,
                                                      run_survey_stacked)
        timer = StageTimer(stats=self.latency, obs=self.obs)
        if self.mesh is not None:
            res = run_survey_stacked(
                [(job.rawfiles, job.cfg, job.workdir, timer)],
                device=self.device, mesh=self.mesh)[0]
        else:
            res = run_survey(job.rawfiles, job.cfg, workdir=job.workdir,
                             timer=timer, device=self.device)
        return {
            "workdir": res.workdir,
            "candfile": res.candfile,
            "n_datfiles": len(res.datfiles),
            "n_cands": (len(res.sifted) if res.sifted is not None
                        else 0),
            "folded": list(res.folded),
            "sp_events": res.sp_events,
            "stage_seconds": {k: round(v, 4)
                              for k, v in timer.stages.items()},
        }

    # ---- introspection ------------------------------------------------

    def get_job(self, job_id: str) -> Optional[Job]:
        with self._jobs_lock:
            return self._jobs.get(job_id)

    def status(self, job_id: str) -> Optional[dict]:
        job = self.get_job(job_id)
        return None if job is None else job.view()

    def result(self, job_id: str) -> Optional[dict]:
        job = self.get_job(job_id)
        if job is None:
            return None
        view = job.view()
        view["result"] = job.result
        return view

    def wait(self, job_ids, timeout: float = 300.0,
             poll: float = 0.05) -> bool:
        """Block until every listed job is terminal (True) or the
        timeout lapses (False).  In-process convenience for tests and
        the load generator."""
        if isinstance(job_ids, str):
            job_ids = [job_ids]
        deadline = time.time() + timeout
        while time.time() < deadline:
            jobs = [self.get_job(j) for j in job_ids]
            if all(j is not None and j.status in JobStatus.TERMINAL
                   for j in jobs):
                return True
            time.sleep(poll)
        return False

    def healthz(self) -> dict:
        """Liveness: is the process worth keeping alive?  True while
        the scheduler loop runs — even when draining or cold (those
        are *readiness* conditions; restarting a draining replica
        would lose the drain)."""
        return {
            "ok": bool(self.scheduler.alive),
            "uptime_s": round(time.time() - self._t0, 3),
            "queue_depth": len(self.queue),
            "scheduler_alive": self.scheduler.alive,
        }

    def readyz(self) -> dict:
        """Readiness: should a router send this replica work?  False
        while draining (shutdown in progress) or dead.  The JAX
        service's keys; ``plan_store`` describes the persistent tier
        (``xla_entries``: the plan libraries built for the current
        kernel sources), and ``lease`` the fleet lease state (None
        outside a fleet)."""
        ready = bool(self.scheduler.alive) and not self.draining
        return {
            "ready": ready,
            "draining": bool(self.draining),
            "scheduler_alive": bool(self.scheduler.alive),
            "plan_warm_fraction": round(self.warm_fraction(), 4),
            "plan_store": (None if self.plan_store is None else {
                "supported": self.plan_store.supported,
                "known_plans": len(self.plan_store.known()),
                "xla_entries": self.plan_store.xla_entries(),
            }),
            "queue_depth": len(self.queue),
            "queue_capacity": self.queue.maxdepth,
            "lease": (None if self.fleet is None
                      else self.fleet.lease_state()),
        }

    def metrics(self) -> dict:
        """The JAX service's JSON metrics shape, every number read off
        the shared registry: ``plans`` the plan cache, ``kernel_costs``
        the per-kind analytic cost book (obs/costmodel)."""
        with self._jobs_lock:
            by_status: Dict[str, int] = {}
            for job in self._jobs.values():
                by_status[job.status] = by_status.get(job.status, 0) + 1
        from presto_tpu_torch.obs import costmodel
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "queue": {"depth": len(self.queue),
                      "capacity": self.queue.maxdepth},
            "jobs": by_status,
            "scheduler": self.scheduler.stats(),
            "plans": self.plans.stats(),
            "latency": self.latency.snapshot(),
            "events": self.events.counts(),
            "kernel_costs": costmodel.snapshot(self.obs),
        }

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the shared registry (the
        `Accept: text/plain` answer of GET /metrics).  Scrape-time
        gauges (queue depth, uptime, jobs by status) are refreshed
        here so the pull model sees current values."""
        reg = self.obs.metrics
        reg.gauge("serve_uptime_seconds",
                  "Service uptime").set(time.time() - self._t0)
        reg.gauge("serve_queue_depth",
                  "Queued jobs").set(len(self.queue))
        reg.gauge("serve_queue_capacity",
                  "Queue depth bound").set(self.queue.maxdepth)
        jobs_g = reg.gauge("serve_jobs", "Jobs by lifecycle status",
                           ("status",))
        with self._jobs_lock:
            by_status: Dict[str, int] = {}
            for job in self._jobs.values():
                by_status[job.status] = by_status.get(job.status, 0) + 1
        for status in (JobStatus.QUEUED, JobStatus.SCHEDULED,
                       JobStatus.RUNNING, JobStatus.RETRY_WAIT,
                       JobStatus.PARKED, JobStatus.DONE,
                       JobStatus.FAILED, JobStatus.TIMEOUT):
            jobs_g.labels(status=status).set(by_status.get(status, 0))
        return reg.render_prometheus()


# ----------------------------------------------------------------------
# HTTP front end
# ----------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> SearchService:
        return self.server.service        # type: ignore[attr-defined]

    def log_message(self, fmt, *args):    # route access logs to events
        self.service.events.emit("http", line=fmt % args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload, sort_keys=True).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str,
              ctype: str = "text/plain; version=0.0.4") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _wants_prometheus(self, url) -> bool:
        """Content negotiation for /metrics: Prometheus scrapers send
        `Accept: text/plain` (or the openmetrics type); humans and the
        pre-obs JSON consumers get the JSON shape.  `?format=` forces
        either way."""
        fmt = parse_qs(url.query).get("format", [""])[0]
        if fmt in ("prometheus", "text"):
            return True
        if fmt == "json":
            return False
        accept = self.headers.get("Accept", "") or ""
        return ("text/plain" in accept
                or "openmetrics-text" in accept)

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/healthz":
                h = self.service.healthz()
                self._json(200 if h["ok"] else 503, h)
            elif url.path == "/readyz":
                r = self.service.readyz()
                self._json(200 if r["ready"] else 503, r)
            elif url.path == "/metrics":
                if self._wants_prometheus(url):
                    self._text(200, self.service.metrics_prometheus())
                else:
                    self._json(200, self.service.metrics())
            elif url.path == "/events":
                q = parse_qs(url.query)
                n = int(q.get("n", ["100"])[0])
                log = self.service.events
                if "since" in q:
                    # resume-from-cursor: a reconnecting trigger
                    # consumer passes its last seen seq and gets every
                    # later event exactly once; `lost` > 0 flags events
                    # that aged out of the ring while it was gone
                    evs, lost, latest = log.since(
                        int(q["since"][0]), limit=n)
                    self._json(200, {"events": evs, "lost": lost,
                                     "cursor": latest})
                else:
                    evs = log.tail(n)
                    self._json(200, {"events": evs,
                                     "cursor": log.cursor()})
            elif len(parts) == 2 and parts[0] == "jobs":
                view = self.service.status(parts[1])
                if view is None:
                    self._json(404, {"error": "no such job"})
                else:
                    self._json(200, view)
            elif (len(parts) == 3 and parts[0] == "jobs"
                  and parts[2] == "result"):
                view = self.service.result(parts[1])
                if view is None:
                    self._json(404, {"error": "no such job"})
                elif view["status"] not in JobStatus.TERMINAL:
                    self._json(409, {"error": "job not finished",
                                     "status": view["status"]})
                else:
                    self._json(200, view)
            else:
                self._json(404, {"error": "unknown endpoint"})
        except Exception as e:
            self._json(500, {"error": "%s: %s" % (type(e).__name__,
                                                  e)})

    def do_POST(self) -> None:
        if urlparse(self.path).path != "/submit":
            self._json(404, {"error": "unknown endpoint"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            spec = json.loads(self.rfile.read(length) or b"{}")
            self._json(202, self.service.submit(spec))
        except BadRequest as e:
            self._json(400, {"error": str(e)})
        except QueueFull as e:
            self._json(429, {"error": str(e)})
        except QueueClosed as e:
            self._json(503, {"error": str(e)})
        except json.JSONDecodeError as e:
            self._json(400, {"error": "bad JSON: %s" % e})
        except Exception as e:
            self._json(500, {"error": "%s: %s" % (type(e).__name__,
                                                  e)})


class ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, service: SearchService):
        super().__init__(addr, _Handler)
        self.service = service


def start_http(service: SearchService, host: str = "127.0.0.1",
               port: int = 0) -> ServeHTTPServer:
    """Bind + serve in a daemon thread; returns the server (its
    .server_address carries the bound port — port=0 picks a free one,
    the test/loadgen pattern)."""
    httpd = ServeHTTPServer((host, port), service)
    t = threading.Thread(target=httpd.serve_forever,
                         name="presto-serve-http", daemon=True)
    t.start()
    return httpd
