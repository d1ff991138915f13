"""Bounded priority job queue with backpressure (serve layer).

Host copy of ``presto_tpu/serve/queue.py`` for the PyTorch port.  The
port's service admits in-process callables (the live stream's ticks);
survey jobs come with ROADMAP queue 1 item 2.

A job is one observation + one SurveyConfig-like spec.  The queue is
a heap ordered by (priority, arrival); depth is bounded so a burst of
submissions turns into explicit backpressure (QueueFull / HTTP 429)
instead of unbounded memory growth — the admission-control half of
continuous batching.  `pop_batch` is the other half: it hands the
scheduler the head job plus every queued job sharing its plan bucket,
so same-shaped beams ride one compiled executable.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


class QueueFull(RuntimeError):
    """Submission rejected: the queue is at its bounded depth."""


class QueueClosed(RuntimeError):
    """The queue has been closed; no further pops/submissions."""


class RetryBudgetExceeded(RuntimeError):
    """A job was re-admitted more than max_retry_depth times: a
    poisoned job must terminate, not cycle the queue forever."""


class Lanes:
    """Scheduler lanes: two SLO classes sharing one process/device.

    DEADLINE jobs (the live-telescope trigger path) sort ahead of
    every THROUGHPUT job regardless of priority — a batch survey and a
    live feed share the scheduler without the feed waiting behind a
    queue of surveys.  There is no preemption: a deadline job still
    waits out the currently-executing job, so the deadline lane's SLO
    floor is the longest single throughput execution.
    """
    DEADLINE = "deadline"
    THROUGHPUT = "throughput"

    ORDER = {DEADLINE: 0, THROUGHPUT: 1}


class JobStatus:
    """Job lifecycle states (plain strings; JSON-friendly)."""
    QUEUED = "queued"
    SCHEDULED = "scheduled"
    RUNNING = "running"
    RETRY_WAIT = "retry-wait"
    PARKED = "parked"
    DONE = "done"
    FAILED = "failed"
    TIMEOUT = "timeout"

    TERMINAL = (DONE, FAILED, TIMEOUT)
    #: locally finished: terminal, or handed back to a fleet ledger
    #: for another replica to re-admit (the shutdown-park path)
    SETTLED = TERMINAL + (PARKED,)


@dataclass
class Job:
    """One search request: observation path(s) + survey spec."""
    job_id: str
    rawfiles: List[str]
    cfg: Any                       # pipeline.survey.SurveyConfig
    workdir: str
    priority: int = 10             # lower sorts first (within a lane)
    bucket: Any = None             # coalescing key (jobs sharing it batch)
    spec: dict = field(default_factory=dict)   # raw submitted spec
    lane: str = Lanes.THROUGHPUT   # deadline | throughput (Lanes)
    #: job kind: "survey" (the ordinary search job) or a discovery-DAG
    #: node type ("sift" | "fold" | "toa", the JAX package's
    #: serve/dag.py) — the service dispatches execution on it
    kind: str = "survey"
    #: in-process callable jobs (the streaming tick): when set, the
    #: service executes run(job) instead of a survey
    run: Optional[Callable] = None
    #: remote trace context (SpanContext wire dict) stamped by the
    #: router through the job ledger; the scheduler resumes it as the
    #: explicit parent of this job's `serve-job` span so one fleet
    #: submission renders as ONE cross-process trace
    trace: Optional[dict] = None
    #: this job's own span identity once execution started (set by
    #: the scheduler) — DAG fan-out children inherit it as THEIR
    #: trace parent, giving folds correct parenting under the sift
    span_ctx: Optional[dict] = None
    #: ledger lease-grant timestamp (fleet jobs; the admit->lease
    #: wait half of job_e2e_seconds)
    leased_at: float = 0.0
    status: str = JobStatus.QUEUED
    attempts: int = 0
    requeues: int = 0              # retry re-admissions so far
    error: str = ""
    submitted: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    result: Optional[dict] = None

    def view(self) -> dict:
        """JSON-safe status snapshot (the /jobs/<id> payload)."""
        return {
            "job_id": self.job_id,
            "status": self.status,
            "lane": self.lane,
            "kind": self.kind,
            "priority": self.priority,
            "bucket": repr(self.bucket),
            "attempts": self.attempts,
            "requeues": self.requeues,
            "error": self.error,
            "submitted": self.submitted,
            "started": self.started,
            "finished": self.finished,
            "workdir": self.workdir,
        }


class JobQueue:
    """Thread-safe bounded priority queue with bucket coalescing."""

    def __init__(self, maxdepth: int = 64,
                 max_retry_depth: Optional[int] = 8):
        if maxdepth < 1:
            raise ValueError("maxdepth must be >= 1")
        self.maxdepth = maxdepth
        # retry re-admissions allowed per job (None = unbounded, the
        # pre-fix behavior); see requeue()
        self.max_retry_depth = max_retry_depth
        self._heap: List[Tuple[int, int, Job]] = []
        self._count = itertools.count()
        self._lock = threading.Lock()  # presto-lint: guards(_heap, _closed)
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    depth = __len__

    def _key(self, job: Job) -> Tuple[int, int, int]:
        """Heap key: lane beats priority beats arrival — deadline-lane
        jobs always pop before throughput jobs."""
        return (Lanes.ORDER.get(job.lane, 1), job.priority,
                next(self._count))

    def submit(self, job: Job, block: bool = False,
               timeout: Optional[float] = None,
               force: bool = False) -> None:
        """Enqueue `job`.  Non-blocking by default: raises QueueFull at
        the depth bound (the server maps this to HTTP 429).  With
        block=True, waits up to `timeout` seconds for a slot.
        force=True bypasses the depth bound — reserved for the
        deadline lane's (self-bounded) stream ticks, which must not be
        shed behind a backlog of throughput submissions."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                if self._closed:
                    raise QueueClosed("queue is closed")
                if force or len(self._heap) < self.maxdepth:
                    break
                if not block:
                    raise QueueFull(
                        "queue depth %d reached" % self.maxdepth)
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    raise QueueFull(
                        "queue depth %d reached (timed out after "
                        "%.3gs)" % (self.maxdepth, timeout))
                self._not_full.wait(remaining)
            job.status = JobStatus.QUEUED
            if not job.submitted:
                job.submitted = time.time()
            heapq.heappush(self._heap, self._key(job) + (job,))
            self._not_empty.notify()

    def requeue(self, job: Job) -> None:
        """Re-admit a retrying job.  Retries bypass the depth bound —
        the job already held a slot when first admitted; bouncing it
        now would turn a transient failure into a drop.  They count
        against max_retry_depth instead: a job that keeps failing its
        way back in (poisoned input, permanently broken executor)
        raises RetryBudgetExceeded so the scheduler can terminate it
        with a final `fail` event rather than cycle it forever."""
        with self._lock:
            if self._closed:
                raise QueueClosed("queue is closed")
            if (self.max_retry_depth is not None
                    and job.requeues >= self.max_retry_depth):
                raise RetryBudgetExceeded(
                    "job %s re-admitted %d times (max_retry_depth=%d)"
                    % (job.job_id, job.requeues,
                       self.max_retry_depth))
            job.requeues += 1
            job.status = JobStatus.QUEUED
            heapq.heappush(self._heap, self._key(job) + (job,))
            self._not_empty.notify()

    def pop_batch(self, max_batch: int = 8,
                  timeout: Optional[float] = None) -> List[Job]:
        """Pop the head job plus up to max_batch-1 queued jobs sharing
        its bucket (arrival order preserved within the batch).  Jobs in
        other buckets keep their heap positions.  Returns [] on
        timeout, raises QueueClosed once closed and drained."""
        with self._lock:
            if not self._heap:
                if self._closed:
                    raise QueueClosed("queue is closed")
                self._not_empty.wait(timeout)
            if not self._heap:
                if self._closed:
                    raise QueueClosed("queue is closed")
                return []
            head = heapq.heappop(self._heap)[-1]
            batch = [head]
            if max_batch > 1:
                keep, take = [], []
                for entry in sorted(self._heap):
                    if (len(batch) + len(take) < max_batch
                            and entry[-1].bucket == head.bucket
                            and entry[-1].lane == head.lane):
                        take.append(entry)
                    else:
                        keep.append(entry)
                batch += [e[-1] for e in take]
                self._heap = keep
                heapq.heapify(self._heap)
            for j in batch:
                j.status = JobStatus.SCHEDULED
            self._not_full.notify(len(batch))
            return batch

    def close(self) -> None:
        """Close the queue: submitters fail fast, poppers drain then
        get QueueClosed."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
