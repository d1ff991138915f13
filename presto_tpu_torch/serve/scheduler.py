"""Continuous micro-batching scheduler (serve layer).

Host copy of ``presto_tpu/serve/scheduler.py`` for the PyTorch port.
Its device-error rule names what a CUDA failure raises in torch (see
``is_device_error``); on such an error the plans bound to the device
the jobs run on (``plan_device``, the service's) are evicted from the
plan cache (``plans``, serve/plancache) before the retry.

One daemon thread runs the serving loop:

  drain due retries -> pop a same-bucket batch -> execute

Execution semantics:

  * batch path — when a cross-job batch executor is configured it gets
    the whole batch (one stacked device call); any batch-level failure
    *degrades gracefully* to the single-job path instead of failing
    the batch's jobs wholesale.
  * single-job path — each job runs under a per-job wall-clock
    timeout; failures retry with exponential backoff up to
    max_retries, then surface as a failed/timeout job status.  A job
    failing never stops the loop.

The coalesced batch shares one bucket, so the batch executor
(serve/batchexec.StackedBatchExecutor) runs it as one stacked chain.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from presto_tpu_torch.serve.queue import (Job, JobQueue, JobStatus,
                                    QueueClosed, RetryBudgetExceeded)


class JobTimeout(RuntimeError):
    """A job exceeded its per-job wall-clock budget."""


#: substrings that mark a RuntimeError as a device failure in torch:
#: the CUDA runtime's own error strings ("CUDA error: ...", a device-side
#: assert, an illegal address, a launch failure), the allocator's "out
#: of memory", the CUDA libraries' status errors, and the port's own
#: C entry points (cuda_build.check: "<entry>: CUDA error <code>").
#: Retrying into the same device state cannot be trusted to succeed.
_DEVICE_ERROR_MARKERS = ("cuda error", "device-side assert",
                         "illegal memory access", "illegal address",
                         "unspecified launch failure", "out of memory",
                         "cublas_status", "cufft_", "cudnn_status",
                         "nccl error", "ecc error")

#: the torch exception types of a device failure (AcceleratorError,
#: which torch raises for a CUDA error since 2.8, where it exists)
_DEVICE_ERROR_TYPES = tuple(
    t for t in (torch.cuda.OutOfMemoryError,
                getattr(torch, "AcceleratorError", None)) if t is not None)


def is_device_error(exc: BaseException) -> bool:
    """True for a CUDA device failure: torch's out-of-memory and
    accelerator errors by type, any other RuntimeError by the markers
    above (never a JobTimeout)."""
    if not isinstance(exc, RuntimeError) or isinstance(exc, JobTimeout):
        return False
    if isinstance(exc, _DEVICE_ERROR_TYPES):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_ERROR_MARKERS)


def _trace_parent(job: Job):
    """The job's remote trace context (stamped by the router through
    the ledger) as an explicit span parent — None for local jobs,
    which keep the ordinary contextvar parenting."""
    from presto_tpu_torch.obs.trace import SpanContext
    return SpanContext.from_dict(getattr(job, "trace", None))


@dataclass
class SchedulerConfig:
    max_batch: int = 8             # coalescing bound per iteration
    job_timeout_s: Optional[float] = None
    max_retries: int = 2           # retries after the first attempt
    backoff_base_s: float = 0.5    # delay = base * 2**(attempt-1)
    backoff_max_s: float = 30.0
    poll_s: float = 0.25           # loop tick while idle
    # Test seam (the injectpsr of the serving layer): called as
    # fault_injector(job, attempt) right before execution; anything it
    # raises is handled exactly like a stage failure.
    fault_injector: Optional[Callable] = None


class Scheduler:
    """Owns the serving loop thread; executes jobs via `executor`
    (callable(job) -> result dict) with optional cross-job
    `batch_executor` (callable(jobs) -> list of result dicts)."""

    def __init__(self, queue: JobQueue, executor: Callable,
                 cfg: Optional[SchedulerConfig] = None, events=None,
                 latency=None, batch_executor: Optional[Callable] = None,
                 obs=None, plans=None, park: Optional[Callable] = None,
                 plan_device=None):
        if obs is None:
            from presto_tpu_torch.obs import Observability, ObsConfig
            obs = Observability(ObsConfig(enabled=True))
        self.queue = queue
        self.executor = executor
        self.batch_executor = batch_executor
        self.cfg = cfg or SchedulerConfig()
        self.events = events
        self.latency = latency
        self.obs = obs
        self.plans = plans          # PlanCache, for device-error evict
        #: the device the plans are bound to, whose plans a device
        #: error evicts (None: the scheduler thread's current device)
        self.plan_device = plan_device
        # fleet seam: park(job) -> bool re-admits a retrying job into
        # the shared job ledger when the local queue is closed
        # (shutdown), so a scheduler retry during drain is handed to
        # another replica instead of stranded as a local failure
        self.park = park
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._retry_heap: list = []
        self._retry_seq = itertools.count()
        self._retry_lock = threading.Lock()  # presto-lint: guards(_retry_heap)
        self._pool: Optional[ThreadPoolExecutor] = None
        # lifecycle accounting lives on the metrics registry — the
        # stats() JSON block and the serve_* Prometheus series read
        # the same counters (one source of truth)
        reg = obs.metrics
        self._c_done = reg.counter("serve_jobs_done_total",
                                   "Jobs completed successfully")
        self._c_failed = reg.counter(
            "serve_jobs_failed_total",
            "Jobs terminally failed (incl. timeouts)")
        self._c_retried = reg.counter("serve_job_retries_total",
                                      "Job retry attempts scheduled")
        self._c_batches = reg.counter("serve_batches_total",
                                      "Micro-batches executed")
        self._c_batched = reg.counter("serve_batched_jobs_total",
                                      "Jobs executed inside batches")
        self._c_degrades = reg.counter(
            "serve_batch_degrades_total",
            "Batch failures degraded to single-job execution")
        self._c_deverr = reg.counter(
            "serve_device_errors_total",
            "Job failures classified as device/executable errors")
        self._c_lanes = reg.counter(
            "serve_lane_batches_total",
            "Micro-batches executed per scheduler lane", ("lane",))
        self._c_parked = reg.counter(
            "serve_jobs_parked_total",
            "Retrying jobs parked back into the fleet ledger at "
            "shutdown")
        self._g_retrywait = reg.gauge(
            "serve_retry_waiting", "Jobs on the retry backoff shelf")

    # ---- lifecycle ----------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Scheduler":
        if self.alive:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="presto-serve-scheduler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._settle_retry_shelf()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def drain(self, timeout: float = 60.0, poll: float = 0.05) -> bool:
        """Wait until the queue and retry shelf are empty (for tests /
        shutdown).  Returns False on timeout."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._retry_lock:
                pending_retries = len(self._retry_heap)
            if (len(self.queue) == 0 and pending_retries == 0
                    and not self._busy):
                return True
            time.sleep(poll)
        return False

    # ---- the loop -----------------------------------------------------

    _busy = False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._admit_due_retries()
            try:
                batch = self.queue.pop_batch(self.cfg.max_batch,
                                             timeout=self.cfg.poll_s)
            except QueueClosed:
                break
            if not batch:
                continue
            self._busy = True
            try:
                self._run_batch(batch)
            except Exception:
                # belt-and-braces: _run_batch handles per-job errors;
                # anything escaping is a scheduler bug, but it must
                # not kill the always-on loop.
                if self.events is not None:
                    self.events.emit(
                        "scheduler-error",
                        error=traceback.format_exc(limit=5))
            finally:
                self._busy = False

    def _admit_due_retries(self) -> None:
        now = time.time()
        due: List[Job] = []
        with self._retry_lock:
            while self._retry_heap and self._retry_heap[0][0] <= now:
                _, _, job = heapq.heappop(self._retry_heap)
                due.append(job)
        with self._retry_lock:
            self._g_retrywait.set(len(self._retry_heap))
        for job in due:
            try:
                self.queue.requeue(job)
            except QueueClosed:
                self._park_or_fail(job, "queue closed during "
                                        "retry wait")
            except RetryBudgetExceeded as e:
                # poisoned job: terminate with the LAST execution
                # error preserved (the budget note rides along), and
                # emit the terminal `fail` event observers wait on.
                job.status = JobStatus.FAILED
                job.error = "%s [%s]" % (job.error or "retry", e)
                job.finished = time.time()
                self._c_failed.inc()
                if self.events is not None:
                    self.events.emit("fail", job=job.job_id,
                                     attempts=job.attempts,
                                     error=job.error, timeout=False,
                                     retry_depth_exceeded=True)

    # ---- shutdown parking ---------------------------------------------

    def _park_or_fail(self, job: Job, why: str) -> None:
        """A retry that can no longer re-enter the local queue
        (shutdown): hand it back to the fleet ledger when a park seam
        is wired (another replica re-admits it — the requeueable
        contract), else surface the old terminal failure rather than
        strand it silently in retry-wait."""
        if self.park is not None:
            try:
                parked = bool(self.park(job))
            except Exception:
                parked = False
            if parked:
                job.status = JobStatus.PARKED
                job.finished = time.time()
                self._c_parked.inc()
                if self.events is not None:
                    self.events.emit("park", job=job.job_id,
                                     attempts=job.attempts, why=why)
                return
        job.status = JobStatus.FAILED
        job.error = job.error or why
        job.finished = time.time()
        self._c_failed.inc()
        if self.events is not None:
            self.events.emit("fail", job=job.job_id,
                             attempts=job.attempts, error=why,
                             timeout=False)

    def _settle_retry_shelf(self) -> None:
        """Drain the backoff shelf at shutdown: every job still
        waiting out a retry delay is parked (fleet) or terminally
        failed (standalone) — never left in retry-wait forever."""
        with self._retry_lock:
            shelf = [job for _, _, job in self._retry_heap]
            self._retry_heap = []
            self._g_retrywait.set(0)
        for job in shelf:
            self._park_or_fail(job, "scheduler stopped during "
                                    "retry wait")

    # ---- batch execution ----------------------------------------------

    def _run_batch(self, batch: List[Job]) -> None:
        self._c_batches.inc()
        self._c_batched.inc(len(batch))
        self._c_lanes.labels(lane=batch[0].lane).inc()
        if self.events is not None:
            self.events.emit("schedule", jobs=[j.job_id for j in batch],
                             occupancy=len(batch),
                             lane=batch[0].lane,
                             bucket=repr(batch[0].bucket))
        if (self.batch_executor is not None and len(batch) > 1
                and all(j.run is None for j in batch)):
            # traced fleet jobs keep per-job spans even through the
            # stacked path (non-current siblings: they must not nest
            # into each other), so a stacked DAG fold still lands in
            # its DAG's cross-process trace
            spans = []
            if self.obs.enabled:
                for job in batch:
                    parent = _trace_parent(job)
                    if parent is None:
                        continue
                    sp = self.obs.tracer.span(
                        "serve-job", parent=parent, current=False,
                        job=job.job_id, stacked=True,
                        bucket=repr(job.bucket))
                    job.span_ctx = sp.context().to_dict()
                    spans.append(sp)
            try:
                results = self._with_timeout(
                    lambda: self.batch_executor(batch))
                for sp in spans:
                    sp.finish()
                for job, result in zip(batch, results):
                    self._finish_ok(job, result)
                return
            except Exception as e:
                for sp in spans:
                    sp.finish("error: %s" % type(e).__name__)
                # graceful degradation: the batch path failing means
                # each job gets an individual shot (and its own
                # retry/backoff budget), not a collective failure.
                self._c_degrades.inc()
                if self.events is not None:
                    self.events.emit(
                        "degrade", jobs=[j.job_id for j in batch],
                        error="%s: %s" % (type(e).__name__, e))
        for job in batch:
            self._run_single(job)

    def _run_single(self, job: Job) -> None:
        job.attempts += 1
        if job.attempts > 1 and \
                getattr(job.cfg, "durable_stages", None) is False:
            # a retry is by definition resume-critical: flip the
            # survey from the fused tier to durable stage artifacts so
            # THIS attempt journals its boundaries and a further
            # failure resumes from the last stage instead of the top
            job.cfg.durable_stages = True
        job.status = JobStatus.RUNNING
        if not job.started:
            job.started = time.time()
        if self.events is not None:
            self.events.emit("execute", job=job.job_id,
                             attempt=job.attempts)
        # a fleet job resumes the trace the router started at /submit
        # (explicit SpanContext across the process hop); survey/DAG
        # spans opened during execution nest under this via the
        # ordinary contextvar propagation
        span = self.obs.span("serve-job", parent=_trace_parent(job),
                             job=job.job_id,
                             attempt=job.attempts,
                             bucket=repr(job.bucket))
        ctx = span.context()
        if ctx is not None:
            job.span_ctx = ctx.to_dict()
        t0 = time.time()
        try:
            if self.cfg.fault_injector is not None:
                self.cfg.fault_injector(job, job.attempts)
            result = self._with_timeout(lambda: self.executor(job))
        except Exception as e:
            span.finish("error: %s" % type(e).__name__)
            self._handle_failure(job, e)
            return
        span.finish()
        if self.latency is not None:
            self.latency.record("job_exec", time.time() - t0)
        self._finish_ok(job, result)

    def _finish_ok(self, job: Job, result: Optional[dict]) -> None:
        job.result = result
        job.status = JobStatus.DONE
        job.error = ""
        job.finished = time.time()
        self._c_done.inc()
        if self.latency is not None and job.submitted:
            self.latency.record("job_total",
                                job.finished - job.submitted)
        if self.events is not None:
            self.events.emit("complete", job=job.job_id,
                             attempts=job.attempts,
                             seconds=round(job.finished
                                           - job.submitted, 3))

    def _handle_failure(self, job: Job, exc: Exception) -> None:
        timed_out = isinstance(exc, JobTimeout)
        job.error = "%s: %s" % (type(exc).__name__, exc)
        if is_device_error(exc):
            # a CUDA failure may leave the plans bound to that device
            # (their banks and maps on the card) unusable: flush them
            # before the retry, which rebuilds fresh ones
            # (plancache_evictions_total{reason="device_error"})
            self._c_deverr.inc()
            if self.plans is not None:
                from presto_tpu_torch.obs import devtel
                n = self.plans.evict_bucket(
                    device=devtel.device_id(self.plan_device),
                    reason="device_error")
                if self.events is not None:
                    self.events.emit("plan-evict", job=job.job_id,
                                     evicted=n, error=job.error)
        if job.attempts <= self.cfg.max_retries:
            delay = min(
                self.cfg.backoff_base_s * 2.0 ** (job.attempts - 1),
                self.cfg.backoff_max_s)
            job.status = JobStatus.RETRY_WAIT
            self._c_retried.inc()
            with self._retry_lock:
                heapq.heappush(
                    self._retry_heap,
                    (time.time() + delay, next(self._retry_seq), job))
                self._g_retrywait.set(len(self._retry_heap))
            if self.events is not None:
                self.events.emit("retry", job=job.job_id,
                                 attempt=job.attempts,
                                 delay_s=round(delay, 4),
                                 error=job.error)
            return
        job.status = (JobStatus.TIMEOUT if timed_out
                      else JobStatus.FAILED)
        job.finished = time.time()
        self._c_failed.inc()
        if self.events is not None:
            self.events.emit("fail", job=job.job_id,
                             attempts=job.attempts, error=job.error,
                             timeout=timed_out)

    # ---- timeout plumbing ---------------------------------------------

    def _with_timeout(self, fn: Callable):
        """Run fn() under the per-job wall-clock budget.  On timeout
        the worker thread is abandoned (Python offers no safe
        preemption) and a fresh worker serves subsequent jobs — the
        stuck thread ends with its work discarded."""
        if not self.cfg.job_timeout_s:
            return fn()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="presto-serve-job")
        fut = self._pool.submit(fn)
        try:
            return fut.result(timeout=self.cfg.job_timeout_s)
        except FutureTimeout:
            stuck = self._pool
            self._pool = None          # zombie pool: never reused
            stuck.shutdown(wait=False)
            raise JobTimeout("exceeded %.3gs job budget"
                             % self.cfg.job_timeout_s) from None

    # ---- metrics ------------------------------------------------------

    def stats(self) -> dict:
        """The /metrics `scheduler` JSON block — read straight off the
        registry counters the Prometheus exposition also serves."""
        with self._retry_lock:
            waiting = len(self._retry_heap)
        batches = self._c_batches.value

        def _reg(name):
            fam = self.obs.metrics.get(name)
            return int(fam.value) if fam is not None else 0

        return {
            "alive": self.alive,
            "jobs_done": int(self._c_done.value),
            "jobs_failed": int(self._c_failed.value),
            "retries": int(self._c_retried.value),
            "retry_waiting": waiting,
            "batches": int(batches),
            "degrades": int(self._c_degrades.value),
            "batch_occupancy": (self._c_batched.value / batches
                                if batches else 0.0),
            # stacked cross-job execution (serve/batchexec.py
            # registers these on the same registry; 0 when the
            # executor is off)
            "stacked_batches": _reg("serve_stacked_batches_total"),
            "stacked_jobs": _reg("serve_stacked_jobs_total"),
        }
