"""SearchService + threaded HTTP front end (serve layer).

Host copy of ``presto_tpu/serve/server.py`` for the PyTorch port: the
service's lifecycle, its bounded queue, event log, latency accounting
and scheduler, in-process callable jobs (the live stream's deadline-lane
ticks) and the HTTP front end.  What needs ROADMAP queue 1 item 2 is
refused, never accepted silently: a survey job (``build_job``/``submit``
and ``POST /submit``: NotImplementedError, HTTP 501) and the
constructor's ``plan_store_dir``, ``mesh`` and ``stacked=True``; a
discovery-DAG node job needs item 3.  ``metrics()`` and ``readyz()``
keep the JAX package's keys, with the values of an empty plan cache,
no plan store and no harvested kernel costs.

The wire protocol is plain HTTP + JSON over stdlib `http.server`
(ThreadingHTTPServer; one thread per connection, the scheduler thread
does the device work):

  POST /submit            {"rawfiles": [...], "config": {...}}
                          -> 501 until survey jobs are ported
  GET  /jobs/<id>         job status snapshot
  GET  /jobs/<id>/result  terminal result payload (409 until terminal)
  GET  /healthz           liveness: queue + scheduler state
  GET  /readyz            readiness: draining / scheduler alive
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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import urlparse, parse_qs

from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.queue import (Job, JobQueue, JobStatus,
                                          QueueClosed, QueueFull)
from presto_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig
from presto_tpu_torch.utils.timing import LatencyStats

#: what a survey job needs before the port's service can run one
SURVEY_JOBS_ITEM = ("survey jobs on the port's SearchService need the "
                    "compiled-plan cache, the survey's plan_provider/obs "
                    "hooks and serve/batchexec: ROADMAP queue 1 item 2")
DAG_JOBS_ITEM = ("discovery-DAG node jobs need serve/dag and the job "
                 "ledger: ROADMAP queue 1 item 3")


class BadRequest(ValueError):
    """Malformed submission (HTTP 400)."""


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
                 stacked: Optional[bool] = None):
        from presto_tpu_torch.obs import Observability, ObsConfig
        for what, given in (("plan_store_dir", plan_store_dir),
                            ("mesh", mesh), ("stacked=True", stacked)):
            if given:
                raise NotImplementedError(
                    "SearchService(%s): %s" % (what, SURVEY_JOBS_ITEM))
        os.makedirs(workroot, exist_ok=True)
        self.workroot = os.path.abspath(workroot)
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
        #: the plan cache's bound, reported by metrics() (no cache yet)
        self.plan_capacity = int(plan_capacity)
        self.scheduler = Scheduler(self.queue, self._execute_job,
                                   cfg=scheduler_cfg,
                                   events=self.events,
                                   latency=self.latency,
                                   obs=self.obs)
        #: no stacked cross-job executor until serve/batchexec is ported
        self.stacked = False
        self._jobs: Dict[str, Job] = {}
        self._jobs_lock = threading.Lock()  # presto-lint: guards(_jobs)
        self._ids = itertools.count(1)
        self._t0 = time.time()
        self.draining = False

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
        drain in-flight and queued jobs, then stop.  Returns a small
        shutdown report."""
        self.draining = True
        report = {"drained": True, "parked": 0, "released": 0}
        if drain:
            report["drained"] = self.scheduler.drain(timeout=timeout)
        self.stop()
        return report

    def warm_fraction(self) -> float:
        """Persistently-known plans resident in memory: 1.0, as the
        JAX service answers without a plan store."""
        return 1.0

    # ---- job admission ------------------------------------------------

    def build_job(self, spec: dict, job_id: Optional[str] = None,
                  workdir: Optional[str] = None) -> Job:
        """Validate one survey submission spec into a Job: refused in
        the port (NotImplementedError naming the ROADMAP item) after the
        checks that need no survey (a JSON object; rawfiles a non-empty
        list of existing files), which stay BadRequest."""
        if not isinstance(spec, dict):
            raise BadRequest("spec must be a JSON object")
        if str(spec.get("kind", "survey") or "survey") != "survey":
            raise NotImplementedError(DAG_JOBS_ITEM)
        rawfiles = spec.get("rawfiles")
        if not rawfiles or not isinstance(rawfiles, (list, tuple)):
            raise BadRequest("spec.rawfiles must be a non-empty list")
        missing = [f for f in rawfiles
                   if not os.path.exists(os.path.abspath(str(f)))]
        if missing:
            raise BadRequest("rawfiles not found: %s" % missing)
        raise NotImplementedError(SURVEY_JOBS_ITEM)

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
        """Run one job on the scheduler thread: an in-process callable
        (the only kind the port admits)."""
        if job.run is None:
            raise NotImplementedError(SURVEY_JOBS_ITEM)
        return job.run(job) or {}

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
        service's keys: no plan store (``plan_store`` None, warm
        fraction 1.0) and no fleet lease (``lease`` None) in the port."""
        ready = bool(self.scheduler.alive) and not self.draining
        return {
            "ready": ready,
            "draining": bool(self.draining),
            "scheduler_alive": bool(self.scheduler.alive),
            "plan_warm_fraction": round(self.warm_fraction(), 4),
            "plan_store": None,
            "queue_depth": len(self.queue),
            "queue_capacity": self.queue.maxdepth,
            "lease": None,
        }

    def metrics(self) -> dict:
        """The JAX service's JSON metrics shape, every number read off
        the shared registry; ``plans`` holds an empty cache's values and
        ``kernel_costs`` is empty (no plan cache, no cost book: ROADMAP
        queue 1 item 2)."""
        with self._jobs_lock:
            by_status: Dict[str, int] = {}
            for job in self._jobs.values():
                by_status[job.status] = by_status.get(job.status, 0) + 1
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "queue": {"depth": len(self.queue),
                      "capacity": self.queue.maxdepth},
            "jobs": by_status,
            "scheduler": self.scheduler.stats(),
            "plans": {"size": 0, "capacity": self.plan_capacity,
                      "hits": 0, "misses": 0, "evictions": 0,
                      "compile_s": 0.0, "hit_rate": 0.0},
            "latency": self.latency.snapshot(),
            "events": self.events.counts(),
            "kernel_costs": {},
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
        except NotImplementedError as e:
            self._json(501, {"error": str(e)})
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
