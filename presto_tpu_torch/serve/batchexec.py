"""Stacked cross-job batch execution (serve layer).

PyTorch counterpart of ``presto_tpu/serve/batchexec.py``.  The
micro-batching scheduler coalesces same-bucket jobs; this executor runs
such a batch of survey jobs with its device-bound middle (single pulse
on the seam, rFFT, accelsearch through the plane_build and stage_reduce
kernels) as one stacked chain: the jobs' DM fan-outs concatenated on
the batch axis (pipeline/survey.run_survey_stacked).

Contracts:

  * **Byte-identity**: stacking only widens the batch axis of calls
    whose per-trial math is independent, so every artifact a stacked
    batch writes is byte-identical to N independent per-job runs.
  * **Degradation**: ``StackIncompatible`` (mixed configs, callable or
    elastic jobs) and any mid-chain failure propagate to the scheduler,
    whose degrade path redoes the batch per job.
  * **Geometry is tuned**: the sub-stack plan comes from the tuning
    DB's ``serve_batch_geometry`` entry (max stack x scheme), clamped by
    the card's free memory so a deep stack cannot run it out.

Fold-batch stacking (the JAX package's discovery-DAG fold arm) comes
with serve/dag, ROADMAP queue 1 item 3: a fold batch is refused here
and runs per job.  There is no environment switch: a service turns the
executor off with ``SearchService(stacked=False)``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from presto_tpu_torch.serve.queue import Job, JobStatus

#: SurveyConfig fields that shape the stacked device chain or the
#: artifacts it writes: two jobs share one chain only when all match
STACK_FIELDS = (
    "lodm", "hidm", "nsub", "rfi_time", "zmax", "numharm", "sigma",
    "flo", "zaplist", "accel_passes", "min_dm_hits", "low_dm_cutoff",
    "fold_top", "fold_sigma", "max_folds", "max_folds_per_pass",
    "sp_threshold", "sp_maxwidth", "singlepulse", "skip_rfifind",
    "bary", "verify_resume", "elastic", "tune", "durable_stages",
    "inflight_depth",
)

#: the share of the card's free memory (torch.cuda.mem_get_info, read
#: when a batch is planned) that a stacked chain may hold: the merged
#: fan-out, its spectra and the search's planes
STACK_MEMORY_FRACTION = 0.25

DEFAULT_MAX_STACK = 8
DEFAULT_SCHEME = "exact"


class StackIncompatible(RuntimeError):
    """This batch cannot run as one stacked chain; the scheduler's
    degradation path gives each job an individual shot."""


def stack_signature(cfg) -> tuple:
    """The stack-compatibility identity of a SurveyConfig."""
    return tuple(repr(getattr(cfg, f, None)) for f in STACK_FIELDS)


def plan_stack_sizes(n: int, max_stack: int = DEFAULT_MAX_STACK,
                     scheme: str = DEFAULT_SCHEME) -> List[int]:
    """Split an n-job batch into sub-stack sizes: ``exact`` takes the
    largest allowed bite each time, ``pow2`` bites at powers of two.
    Sizes sum to n and never exceed max_stack."""
    n = max(int(n), 0)
    max_stack = max(int(max_stack), 1)
    sizes: List[int] = []
    left = n
    while left > 0:
        take = min(left, max_stack)
        if scheme == "pow2" and take > 1:
            take = 1 << (take.bit_length() - 1)
        sizes.append(take)
        left -= take
    return sizes


def stack_memory_budget(device) -> Optional[int]:
    """Bytes a stacked chain may hold on ``device``: STACK_MEMORY_FRACTION
    of the card's free memory (torch.cuda.mem_get_info); None for the
    CPU, which has no device budget to clamp to."""
    d = torch.device(device)
    if d.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(d)
    return int(free * STACK_MEMORY_FRACTION)


def resolve_stack_geometry(per_job_bytes: Optional[List[int]] = None,
                           obs=None, budget: Optional[int] = None
                           ) -> tuple:
    """(max_stack, scheme) for the next stacked batch: the tuning DB's
    ``serve_batch_geometry`` entry when tuning is active, else the
    defaults; then the memory clamp (``budget`` over the heaviest job's
    chain bytes), so a deep stack takes more sub-stacks instead of
    running the card out of memory."""
    max_stack, scheme = DEFAULT_MAX_STACK, DEFAULT_SCHEME
    from presto_tpu_torch import tune
    if tune.enabled():
        cfg = tune.best("serve_batch_geometry", tune.GLOBAL_KEY, obs=obs)
        if cfg:
            max_stack = int(cfg.get("max_stack", max_stack))
            scheme = str(cfg.get("scheme", scheme))
    if per_job_bytes and budget is not None:
        heaviest = max(int(b) for b in per_job_bytes)
        if heaviest > 0:
            max_stack = min(max_stack, max(1, int(budget // heaviest)))
    return max(1, max_stack), scheme


class StackedBatchExecutor:
    """The scheduler's cross-job ``batch_executor``: callable(jobs) ->
    per-job result dicts, the whole same-bucket batch through one
    stacked device chain on the service's device (its rows over the
    service's mesh when it has one)."""

    def __init__(self, service):
        self.service = service
        reg = service.obs.metrics
        self._c_batches = reg.counter(
            "serve_stacked_batches_total",
            "Cross-job stacked device batches executed")
        self._c_jobs = reg.counter(
            "serve_stacked_jobs_total",
            "Jobs executed through the stacked cross-job chain")
        self._h_occupancy = reg.histogram(
            "serve_batch_occupancy",
            "Jobs per executed micro-batch (stacked path)",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 32))
        self._last_sizes: List[int] = []

    def _plan(self, per_job_bytes: List[int]) -> List[int]:
        max_stack, scheme = resolve_stack_geometry(
            per_job_bytes, obs=self.service.obs,
            budget=stack_memory_budget(self.service.device))
        self._last_sizes = plan_stack_sizes(len(per_job_bytes), max_stack,
                                            scheme)
        return self._last_sizes

    @staticmethod
    def check_stackable(jobs: List[Job]) -> None:
        """Raise StackIncompatible unless this batch may share one
        stacked chain: two or more same-bucket survey jobs with one
        search signature, none callable or elastic."""
        if len(jobs) < 2:
            raise StackIncompatible("nothing to stack")
        kinds = {getattr(job, "kind", "survey") or "survey" for job in jobs}
        if kinds != {"survey"}:
            raise StackIncompatible("only survey batches stack in the port "
                                    "(got %s)" % sorted(kinds))
        for job in jobs:
            if job.run is not None or job.cfg is None:
                raise StackIncompatible("callable jobs cannot be stacked")
            if getattr(job.cfg, "elastic", None):
                raise StackIncompatible(
                    "elastic surveys keep the staged/ledger contract")
        sig0 = stack_signature(jobs[0].cfg)
        for job in jobs[1:]:
            if job.bucket != jobs[0].bucket:
                raise StackIncompatible("mixed plan buckets")
            if stack_signature(job.cfg) != sig0:
                raise StackIncompatible(
                    "same bucket but different search configs")

    def __call__(self, jobs: List[Job]) -> List[dict]:
        from presto_tpu_torch.pipeline.survey import run_survey_stacked
        from presto_tpu_torch.utils.timing import StageTimer
        self.check_stackable(jobs)
        injector = self.service.scheduler.cfg.fault_injector
        timers = []
        for job in jobs:
            job.status = JobStatus.RUNNING
            if not job.started:
                job.started = time.time()
            self.service.events.emit("execute", job=job.job_id,
                                     attempt=job.attempts + 1,
                                     stacked=True)
            if injector is not None:
                injector(job, job.attempts + 1)
            timers.append(StageTimer(stats=self.service.latency,
                                     obs=self.service.obs))
        span = self.service.obs.span("serve:stacked-batch",
                                     jobs=len(jobs),
                                     bucket=repr(jobs[0].bucket))
        self._h_occupancy.observe(len(jobs))
        t0 = time.time()
        try:
            results = run_survey_stacked(
                [(job.rawfiles, job.cfg, job.workdir, timer)
                 for job, timer in zip(jobs, timers)],
                stack_planner=self._plan, device=self.service.device,
                mesh=self.service.mesh)
        except Exception as e:
            span.finish("error: %s" % type(e).__name__)
            raise
        span.finish()
        self._c_batches.inc(len(self._last_sizes or [jobs]))
        self._c_jobs.inc(len(jobs))
        if self.service.latency is not None:
            self.service.latency.record("job_exec", time.time() - t0)
        out = []
        for job, res, timer in zip(jobs, results, timers):
            job.attempts += 1
            out.append({
                "workdir": res.workdir,
                "candfile": res.candfile,
                "n_datfiles": len(res.datfiles),
                "n_cands": (len(res.sifted)
                            if res.sifted is not None else 0),
                "folded": list(res.folded),
                "sp_events": res.sp_events,
                "stacked": len(jobs),
                "stage_seconds": {k: round(v, 4)
                                  for k, v in timer.stages.items()},
            })
        return out
