"""Fleet replica: one presto-serve process leasing jobs from the
shared job ledger.

Host copy of ``presto_tpu/serve/fleet.py`` for the PyTorch port, around
the port's SearchService (its jobs run on the service's device).  The
fleet directory's files (``jobs.json``, ``jobs/<id>/a<epoch>/``,
``result.json``, ``usage.jsonl``, ``obs/``) are the JAX package's.  One
ordering differs from the JAX replica: ``fleet_jobs_committed_total``
counts a commit inside the ledger's commit transaction
(``JobLedger.complete(on_commit=)``), so it already counts the commit
when any reader sees the job terminal, and a fenced-off commit counts
nothing.

Topology::

    clients ──▶ router.py ──admit──▶ jobs.json (serve/jobledger)
                                        ▲  lease / commit / redo
                   ┌────────────────────┼────────────────────┐
              replica A            replica B            replica C
           (SearchService +     (SearchService +     (SearchService +
            FleetReplica)        FleetReplica)        FleetReplica)

Each replica runs the standard single-process service (queue, plan
cache, micro-batching scheduler) and this pump around it:

  * **lease** — claim pending jobs from the ledger (tenant-WRR order)
    up to `max_inflight`, build them into local queue jobs whose
    workdir is the job's *epoch-stamped attempt directory*
    (`<fleetdir>/jobs/<id>/a<epoch>`), so a zombie incarnation and
    its successor never write into the same tree;
  * **commit** — when the local job completes, stage `result.json`
    (result summary + artifact digests) and commit it through the
    ledger's fence-checked staged path: a replica the fleet declared
    dead gets `StaleResultError` and its late result is discarded —
    never landed twice;
  * **renew / reap** — heartbeat its own liveness, renew held leases
    at half-TTL, and run the (idempotent) reaper so any replica can
    re-admit a dead peer's leases;
  * **drain** — on SIGTERM: stop leasing, let in-flight work finish
    and commit, release what never started, park scheduler retries
    back into the ledger (`Scheduler.park` seam), and write a
    heartbeat *tombstone* so the reaper re-admits instantly instead
    of waiting out the TTL.

`kill()` is the chaos seam: it drops the replica exactly the way
SIGKILL does (heartbeats stop, leases stay claimed, any running
survey keeps running as a zombie); ``kill_on`` fires it at a named
chaos point (testing/chaos.FLEET_KILL_POINTS).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import socket
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from presto_tpu_torch.obs import fleetagg
from presto_tpu_torch.serve.jobledger import JobLedger
from presto_tpu_torch.serve.queue import (Job, JobStatus, QueueClosed,
                                          QueueFull)
from presto_tpu_torch.testing.chaos import FLEET_KILL_POINTS


def default_replica_name() -> str:
    return "%s-%d" % (socket.gethostname(), os.getpid())


#: attempt-dir artifact patterns whose bytes are deterministic given
#: the job spec (no embedded timings/paths) — the byte-equality
#: surface the chaos trials compare against a never-failed run
ARTIFACT_PATTERNS = ("*.dat", "*.fft", "*.singlepulse", "*_ACCEL_*",
                     "cands_sifted*")


def artifact_digests(workdir: str) -> Dict[str, dict]:
    """{relative artifact: {size, sha256}} for one attempt dir."""
    out: Dict[str, dict] = {}
    for pat in ARTIFACT_PATTERNS:
        for p in sorted(glob.glob(os.path.join(workdir, "**", pat),
                                  recursive=True)):
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            rel = os.path.relpath(p, workdir)
            out[rel] = {"size": os.path.getsize(p),
                        "sha256": h.hexdigest()}
    return out


@dataclass
class FleetConfig:
    """Fleet-membership knobs for one replica."""
    fleetdir: str
    replica: str = ""              # default: <hostname>-<pid>
    lease_ttl: float = 30.0
    heartbeat_s: float = 1.0
    heartbeat_timeout: float = 10.0
    poll_s: float = 0.1
    max_inflight: int = 2          # leased jobs held at once
    prewarm: bool = True           # warm the plan cache before leasing
    #: same-bucket jobs leased per ledger transaction
    #: (JobLedger.lease_batch): a whole batch lands in the local
    #: queue together, coalesces into one micro-batch, and executes
    #: through the stacked executor as one device call.  Capped by
    #: the free max_inflight slots; 1 = classic single leasing.
    lease_batch: int = 4
    #: idle-capacity tuning: when the ledger is empty and nothing is
    #: in flight, run ONE bounded tuning slice of the port's tune/
    #: families on the service's device and merge-save into the
    #: fleet's shared tuning DB.  Off by default.
    tune_in_idle: bool = False
    idle_tune_families: str = "plancache_bucket"
    idle_tune_budget_s: float = 20.0
    idle_tune_interval: float = 300.0
    idle_tune_db: str = ""         # default <fleetdir>/tune.json
    #: fleet-observability snapshot cadence: the heartbeat loop
    #: publishes this replica's full metrics state into
    #: `<fleet>/obs/<replica>.json` every this many seconds (atomic,
    #: tombstoned on drain), feeding the router's `GET /fleet/metrics`
    #: aggregation (obs/fleetagg.py).  0 disables publishing.
    snapshot_s: float = 2.0


class FleetReplica:
    """The lease-and-execute pump wrapping one SearchService."""

    def __init__(self, service, cfg: FleetConfig,
                 addr: Optional[str] = None):
        self.service = service
        self.cfg = cfg
        self.replica = cfg.replica or default_replica_name()
        self.addr = addr
        os.makedirs(cfg.fleetdir, exist_ok=True)
        self.ledger = JobLedger(cfg.fleetdir, obs=service.obs)
        self.jobroot = os.path.join(os.path.abspath(cfg.fleetdir),
                                    "jobs")
        os.makedirs(self.jobroot, exist_ok=True)
        # fleet observability: this replica's spans stream into the
        # shared obs dir (one JSONL per process, joined by trace id
        # in obs/fleetagg), and the heartbeat loop publishes metric
        # snapshots next to them
        self.obsdir = fleetagg.obs_dir(cfg.fleetdir)
        os.makedirs(self.obsdir, exist_ok=True)
        if service.obs.enabled:
            service.obs.tracer.attach_jsonl(
                fleetagg.span_stream_path(cfg.fleetdir,
                                          self.replica))
        self.epoch = 0
        self.draining = False
        self._killed = False
        self._stop = threading.Event()
        self._pump_t: Optional[threading.Thread] = None
        self._hb_t: Optional[threading.Thread] = None
        self._warmed = threading.Event()
        #: job_id -> (lease, local Job); shared between the pump
        #: thread, drain(), and the HTTP readiness handler
        self._inflight: Dict[str, Tuple[object, Job]] = {}
        self._inflight_lock = threading.Lock()  # presto-lint: guards(_inflight)
        #: chaos seam: kill the replica when the pump reaches this
        #: point ("job-leased" | "job-enqueued")
        self.kill_on: Optional[str] = None
        service.fleet = self
        service.scheduler.park = self._park
        reg = service.obs.metrics
        self._c_leased = reg.counter(
            "fleet_jobs_leased_total",
            "Jobs this replica leased from the fleet ledger")
        self._c_committed = reg.counter(
            "fleet_jobs_committed_total",
            "Job results committed through the ledger fence")
        self._c_redone = reg.counter(
            "fleet_jobs_redone_total",
            "Leased jobs handed back for another replica")
        self._c_failed = reg.counter(
            "fleet_jobs_failed_total",
            "Jobs terminally failed in the ledger by this replica")
        self._c_stale = reg.counter(
            "fleet_stale_results_total",
            "Late results the ledger fence rejected (zombie commits)")
        self._c_batchlease = reg.counter(
            "fleet_batch_leases_total",
            "Multi-job same-bucket batch leases claimed in one "
            "ledger transaction")
        self._c_idletune = reg.counter(
            "fleet_idle_tune_total",
            "Bounded tuning slices run in fleet idle capacity")
        self._c_snapshots = reg.counter(
            "fleet_obs_snapshots_total",
            "Metric snapshots published into the fleet obs dir")
        self._c_launches = reg.counter(
            "cuda_kernel_launches_total",
            "Hand-written CUDA kernel launches in this replica process "
            "(the kernel wrappers' own counts, booked at each snapshot)",
            ("kernel",))
        self._launches_booked: Dict[str, int] = {}
        self._g_inflight = reg.gauge(
            "fleet_inflight", "Leased jobs currently held")
        self._g_epoch = reg.gauge(
            "fleet_epoch", "Fleet epoch this replica last observed")
        self._h_e2e = reg.histogram(
            "job_e2e_seconds",
            "End-to-end fleet job decomposition from ledger/event "
            "timestamps: admit->lease wait, device execute, commit, "
            "and total, per plan bucket", ("phase", "bucket"))

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "FleetReplica":
        self.epoch = self.ledger.join(self.replica, addr=self.addr)
        # a fresh incarnation cannot have in-flight work: anything
        # leased under this name is a dead predecessor's
        redone = self.ledger.readmit_owned(self.replica)
        if redone:
            self._c_redone.inc(len(redone))
        self.epoch = self.ledger.epoch
        self._g_epoch.set(self.epoch)
        self.ledger.heartbeat(self.replica, self.epoch)
        self._maybe_snapshot(force=True)
        self.service.events.emit("fleet-join", replica=self.replica,
                                 epoch=self.epoch,
                                 readmitted=len(redone))
        self._stop.clear()
        self._hb_t = threading.Thread(
            target=self._heartbeat_loop,
            name="presto-fleet-heartbeat", daemon=True)
        self._hb_t.start()
        self._pump_t = threading.Thread(
            target=self._pump, name="presto-fleet-pump", daemon=True)
        self._pump_t.start()
        return self

    def kill(self) -> None:
        """Chaos seam: die the way SIGKILL dies — heartbeats stop,
        leases stay claimed (the reaper must recover them), any
        running survey keeps running as a zombie whose late commit
        the fence must reject.  Like every real survey death, the
        flight recorder dumps first: the ring (whose last record is
        the `fleet-chaos-point` stamped BEFORE the kill fired) lands
        in `<fleet>/obs/<replica>/flightrec-*.json`, where the fleet
        report picks it up via the ledger's tombstone/reap records
        after the fleet declares this replica dead."""
        self.service.obs.dump_flight(
            fleetagg.replica_dump_dir(self.cfg.fleetdir,
                                      self.replica),
            reason="replica-killed")
        self._killed = True
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        for t in (self._pump_t, self._hb_t):
            if t is not None:
                t.join(timeout=10.0)

    def drain(self, timeout: float = 60.0) -> dict:
        """Graceful departure: stop leasing, finish + commit in-flight
        work, hand back whatever never ran, tombstone the heartbeat.
        Returns {drained, released, parked} for the shutdown report."""
        self.draining = True
        self.service.draining = True
        self.service.events.emit("fleet-drain", replica=self.replica,
                                 inflight=self._inflight_size())
        deadline = time.time() + timeout
        drained = True
        while time.time() < deadline:
            if self._inflight_size() == 0:
                break
            time.sleep(self.cfg.poll_s)
        else:
            drained = False
        released = 0
        with self._inflight_lock:
            leftovers = dict(self._inflight)
            self._inflight.clear()
            self._g_inflight.set(0)
        for job_id, (lease, _job) in leftovers.items():
            # never finished here: back to pending for a live replica
            self.ledger.fail(lease, self.replica)
            self._c_redone.inc()
            released += 1
        self.stop()
        self.ledger.tombstone(self.replica)
        # final metric snapshot, tombstoned exactly like the
        # heartbeat: the aggregation keeps this replica's counters
        # (its work happened) but drops its point-in-time gauges
        self._maybe_snapshot(force=True, tombstone=True)
        self.service.events.emit("fleet-tombstone",
                                 replica=self.replica)
        parked = int(self.service.obs.metrics.get(
            "serve_jobs_parked_total").value) \
            if self.service.obs.metrics.get(
                "serve_jobs_parked_total") else 0
        return {"drained": drained, "released": released,
                "parked": parked}

    # ---- readiness ----------------------------------------------------

    def lease_state(self) -> dict:
        with self._inflight_lock:
            held = sorted(self._inflight)
        return {"replica": self.replica, "epoch": self.epoch,
                "held": held, "draining": bool(self.draining),
                "warmed": bool(self._warmed.is_set())}

    # ---- the pump -----------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.cfg.heartbeat_s):
            if self._killed or self.draining:
                return
            self.ledger.heartbeat(self.replica, self.epoch)
            self._maybe_snapshot()

    # ---- fleet-observability snapshots --------------------------------

    _last_snapshot = 0.0

    def _maybe_snapshot(self, force: bool = False,
                        tombstone: bool = False) -> None:
        """Publish this replica's full metrics state atomically into
        `<fleet>/obs/<replica>.json` (paced by snapshot_s; a failure
        is an event, never a dead heartbeat loop)."""
        if self.cfg.snapshot_s <= 0 or not self.service.obs.enabled:
            return
        now = time.time()
        if not force and now - self._last_snapshot \
                < self.cfg.snapshot_s:
            return
        self._last_snapshot = now
        try:
            self._book_launches()
            fleetagg.publish_snapshot(self.cfg.fleetdir,
                                      self.replica,
                                      self.service.obs,
                                      tombstone=tombstone,
                                      interval=self.cfg.snapshot_s)
            self._c_snapshots.inc()
            self.service.obs.event("fleet-obs-snapshot",
                                   replica=self.replica,
                                   tombstone=tombstone)
        except Exception:
            self.service.obs.event("fleet-pump-error")

    def _book_launches(self) -> None:
        """Move the kernel wrappers' process-wide launch counts
        (search/build_cuda, search/accel_cuda) into
        ``cuda_kernel_launches_total{kernel}``, so the snapshots (and the
        router's fleet aggregation) carry each replica's launches."""
        from presto_tpu_torch.search import accel_cuda, build_cuda
        now = {"plane_build": build_cuda.launches,
               "stage_reduce": accel_cuda.launches,
               "stage_reduce_planes": accel_cuda.planes_launches}
        for kernel, n in now.items():
            delta = n - self._launches_booked.get(kernel, 0)
            if delta > 0:
                self._c_launches.labels(kernel=kernel).inc(delta)
            self._launches_booked[kernel] = n

    def _chaos(self, point: str) -> bool:
        assert point in FLEET_KILL_POINTS, point
        if self.kill_on == point:
            # recorded BEFORE the kill fires — the survey chaos
            # guarantee extended to the fleet seams (incl.
            # batch-leased and fold-fanout): the dump's last record
            # names the kill point
            self.service.obs.event("fleet-chaos-point", point=point)
            self.kill()
            return True
        return False

    def _pump(self) -> None:
        if self.cfg.prewarm:
            try:
                self.service.prewarm()
            finally:
                self._warmed.set()
        else:
            self._warmed.set()
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:
                # a pump error must not kill the replica; the obs
                # flight recorder carries the traceback
                self.service.obs.event("fleet-pump-error")
            self._stop.wait(self.cfg.poll_s)

    _last_reap = 0.0

    def _tick(self) -> None:
        self._check_inflight()
        # the reaper is idempotent and any replica may run it, but it
        # is a ledger transaction — pace it well under the heartbeat
        # timeout instead of every poll
        now = time.time()
        if now - self._last_reap >= min(1.0,
                                        self.cfg.heartbeat_timeout
                                        / 4.0):
            self._last_reap = now
            report = self.ledger.reap(self.cfg.heartbeat_timeout)
            self.epoch = report.epoch
            self._g_epoch.set(self.epoch)
        leased_any = False
        while (not self.draining and not self._stop.is_set()
               and self._inflight_size() < self.cfg.max_inflight):
            want = min(max(int(self.cfg.lease_batch), 1),
                       self.cfg.max_inflight - self._inflight_size())
            if want > 1:
                # one fenced transaction claims a whole same-bucket
                # batch: the jobs coalesce into one local micro-batch
                # and execute through the stacked executor as one
                # device call (serve/batchexec.py)
                leases = self.ledger.lease_batch(
                    self.replica, self.cfg.lease_ttl, want)
            else:
                lease = self.ledger.lease(self.replica,
                                          self.cfg.lease_ttl)
                leases = [] if lease is None else [lease]
            if not leases:
                break
            leased_any = True
            self._c_leased.inc(len(leases))
            if len(leases) > 1:
                self._c_batchlease.inc()
            for lease in leases:
                self.service.events.emit("job-lease",
                                         job=lease.item_id,
                                         replica=self.replica,
                                         epoch=lease.epoch,
                                         batch=len(leases))
            if self._chaos("job-leased"):
                return
            if len(leases) > 1 and self._chaos("batch-leased"):
                # chaos seam: die holding a whole leased batch — the
                # reaper must re-admit every member exactly once
                return
            admitted = True
            for lease in leases:
                if not self._admit_local(lease):
                    admitted = False
            if not admitted:
                break
        if (not leased_any and self._inflight_size() == 0
                and self.cfg.tune_in_idle and not self.draining
                and not self._stop.is_set()):
            self._idle_tune()

    # ---- idle-capacity tuning ------------------------------------------

    _last_idle_tune = 0.0

    def _idle_tune(self) -> None:
        """One bounded tuning slice in idle capacity: the configured
        families of the port's tune/ (smoke shapes, on the service's
        device) sweep until the budget is spent, and the winners
        merge-save into the fleet's shared tuning DB, so every
        replica's idle time compounds into better execution geometry
        for all of them.  Paced by idle_tune_interval; a failure is an
        event, never a dead pump."""
        now = time.time()
        if now - self._last_idle_tune < self.cfg.idle_tune_interval:
            return
        self._last_idle_tune = now
        try:
            summary = self._run_idle_sweeps(now)
            self._c_idletune.inc()
            self.service.events.emit(
                "fleet-idle-tune", replica=self.replica,
                db_records=summary["db_records"],
                elapsed_s=summary["elapsed_s"],
                budget_exhausted=summary["budget_exhausted"])
        except Exception:
            self.service.obs.event("fleet-pump-error")

    def _run_idle_sweeps(self, t0: float) -> dict:
        from presto_tpu_torch.tune import TuneDB
        from presto_tpu_torch.tune.runner import TuneRunner
        from presto_tpu_torch.tune.space import resolve, tune_family
        names = [f.strip()
                 for f in self.cfg.idle_tune_families.split(",")
                 if f.strip()]
        db_path = self.cfg.idle_tune_db or os.path.join(
            os.path.abspath(self.cfg.fleetdir), "tune.json")
        runner = TuneRunner(k=1, warmup=1, timeout_s=10.0,
                            obs=self.service.obs,
                            device=self.service.device)
        db = TuneDB()
        exhausted = False
        for fam in resolve(names or None):
            if time.time() - t0 > self.cfg.idle_tune_budget_s:
                exhausted = True
                break
            tune_family(fam, runner, smoke=True, db=db)
        db.save(db_path)                 # merge-save: keep-the-best
        return {"db_records": TuneDB.load(db_path).size()[1],
                "elapsed_s": round(time.time() - t0, 3),
                "budget_exhausted": exhausted}

    def _attempt_dir(self, job_id: str, epoch: int) -> str:
        return os.path.join(self.jobroot, job_id, "a%04d" % epoch)

    def _committed_dir(self, job_id: str) -> str:
        """Absolute path of a DONE parent's committed attempt dir —
        resolved from the fence-landed result.json summary, so a
        child node only ever reads the winning epoch's tree, never a
        zombie's."""
        view = self.ledger.view(job_id)
        if (view is None or view["state"] != "done"
                or not view.get("result")):
            raise RuntimeError("dag parent %s is not committed"
                               % job_id)
        att = view["result"].get("attempt_dir") or "."
        return os.path.join(self.jobroot, job_id, att)

    def _resolve_parents(self, spec: dict) -> Dict[str, object]:
        """spec.parents ({role: job_id | [job_ids]}) resolved to the
        parents' committed attempt dirs (same shape)."""
        out: Dict[str, object] = {}
        for role, val in (spec.get("parents") or {}).items():
            if isinstance(val, (list, tuple)):
                out[role] = [self._committed_dir(v) for v in val]
            else:
                out[role] = self._committed_dir(val)
        return out

    def _admit_local(self, lease) -> bool:
        """Build the leased job into the local queue.  False when the
        local queue refused it (job handed back)."""
        job_id = lease.item_id
        spec = dict(lease.data.get("spec") or {})
        kind = str(spec.get("kind", "survey") or "survey")
        workdir = self._attempt_dir(job_id, lease.epoch)
        try:
            if kind != "survey":
                # DAG node: hand the executor its parents' committed
                # attempt dirs and the ledger row's stack bucket (so
                # same-geometry folds coalesce locally too)
                spec["parent_dirs"] = self._resolve_parents(spec)
                if lease.data.get("bucket"):
                    spec["bucket"] = lease.data["bucket"]
            job = self.service.build_job(spec, job_id=job_id,
                                         workdir=workdir)
            job.priority = int(lease.data.get("priority", 10))
            # resume the submission's trace (stamped at /submit by
            # the router, or at a parent's expand) and carry the
            # lease-grant timestamp for the job_e2e decomposition
            if lease.data.get("trace"):
                job.trace = dict(lease.data["trace"])
            job.leased_at = float(lease.data.get("leased_at")
                                  or 0.0)
            self.service.enqueue_job(job)
        except (QueueFull, QueueClosed):
            self.ledger.fail(lease, self.replica)
            self._c_redone.inc()
            return False
        except Exception as e:
            # unexecutable spec: terminal, not a redo loop
            self.ledger.fail_terminal(lease, self.replica,
                                      "%s: %s" % (type(e).__name__,
                                                  e))
            self._c_failed.inc()
            return True
        with self._inflight_lock:
            self._inflight[job_id] = (lease, job)
            self._g_inflight.set(len(self._inflight))
        self._chaos("job-enqueued")
        if kind == "fold":
            # chaos seam: die holding a leased fold mid-DAG
            self._chaos("mid-fold")
        if kind == "triage":
            # chaos seam: die holding a leased triage node mid-score
            # (the fan-out is never computed; a survivor re-leases
            # the node and scores identically — seeded model)
            self._chaos("mid-triage")
        return True

    def _check_inflight(self) -> None:
        now = time.time()
        with self._inflight_lock:
            items = list(self._inflight.items())
        for job_id, (lease, job) in items:
            if job.status == JobStatus.DONE:
                self._commit(lease, job)
                self._drop(job_id)
            elif job.status in (JobStatus.FAILED, JobStatus.TIMEOUT):
                try:
                    self.ledger.fail_terminal(
                        lease, self.replica, job.error,
                        usage={"phases": self._phases(lease, job,
                                                      now),
                               "replica": self.replica})
                    self._c_failed.inc()
                except self.ledger.STALE:
                    self._c_stale.inc()
                self._drop(job_id)
            elif job.status == JobStatus.PARKED:
                self._drop(job_id)      # _park already re-admitted it
            elif lease.expires - now < self.cfg.lease_ttl / 2.0:
                if self.ledger.renew(lease, self.replica,
                                     self.cfg.lease_ttl):
                    lease.expires = now + self.cfg.lease_ttl
                # a failed renew means the fleet fenced us off; keep
                # running — the commit fence settles it exactly once

    def _drop(self, job_id: str) -> None:
        with self._inflight_lock:
            self._inflight.pop(job_id, None)
            self._g_inflight.set(len(self._inflight))

    def _inflight_size(self) -> int:
        """Locked read of the in-flight count (the pump's lease
        budget and drain's progress test both race the executor's
        _drop without it)."""
        with self._inflight_lock:
            return len(self._inflight)

    # ---- commit -------------------------------------------------------

    def _commit(self, lease, job: Job) -> bool:
        """Stage result.json and land it through the ledger fence.
        Returns False when the fence rejected us (zombie commit).

        A DAG node whose result carries a dynamic fan-out
        (``dag_children`` / ``dag_retarget`` — the sift node) commits
        through `JobLedger.complete_and_expand`: the result and the
        child rows land in ONE fenced transaction, so a zombie sift
        expands nothing and a crash can never strand a committed
        sift without its folds."""
        job_dir = os.path.join(self.jobroot, job.job_id)
        os.makedirs(job_dir, exist_ok=True)
        phases = self._phases(lease, job, time.time())
        result = {
            "job_id": job.job_id,
            "replica": self.replica,
            "epoch": int(lease.epoch),
            "attempt_dir": os.path.relpath(job.workdir, job_dir),
            "result": job.result,
            "artifacts": artifact_digests(job.workdir),
        }
        # staged, NOT atomic_open: result.json may only land through
        # the ledger fence (complete/complete_and_expand renames it
        # under the ledger lock after the epoch check) — but the
        # staged bytes are fsync'd here so the fenced rename promotes
        # a durable file, mirroring io/atomic's write discipline
        fd, tmp = tempfile.mkstemp(prefix=".result-", dir=job_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(job_dir, "result.json")
        summary = {"n_artifacts": len(result["artifacts"]),
                   "attempt_dir": result["attempt_dir"],
                   "replica": self.replica}
        children = retarget = None
        if isinstance(job.result, dict):
            children = job.result.get("dag_children")
            retarget = job.result.get("dag_retarget")
        if children or retarget:
            # inherit the graph's tenant/priority onto the fan-out,
            # and the DAG's trace: children parent under THIS node's
            # own span (the sift's folds nest under the sift) or,
            # failing that, the incoming trace context — either way
            # the whole expanded subtree stays in the DAG's one trace
            child_trace = (getattr(job, "span_ctx", None)
                           or lease.data.get("trace"))
            for _cid, fields in children or ():
                fields.setdefault("tenant",
                                  lease.data.get("tenant",
                                                 "default"))
                fields.setdefault("priority",
                                  int(lease.data.get("priority",
                                                     10)))
                if child_trace:
                    fields.setdefault("trace", dict(child_trace))
            if self._chaos("fold-fanout"):
                # chaos seam: die AFTER computing the fan-out but
                # BEFORE the commit transaction — the fan-out is
                # lost with the attempt; a successor redoes the sift
                # and expands identically (idempotence)
                return False
        usage = {"phases": phases,
                 "kind": str((lease.data.get("spec") or {})
                             .get("kind", "survey") or "survey"),
                 "replica": self.replica}
        # the committed counter moves inside the commit transaction,
        # after the fence check and before the state file lands: no
        # reader sees the job terminal before it is counted, and a
        # fenced-off commit is never counted
        try:
            if children or retarget:
                self.ledger.complete_and_expand(
                    lease, self.replica, {final: tmp},
                    extra={"result": summary}, children=children,
                    retarget=retarget, usage=usage,
                    on_commit=self._c_committed.inc)
            else:
                self.ledger.complete(lease, self.replica,
                                     {final: tmp},
                                     extra={"result": summary},
                                     usage=usage,
                                     on_commit=self._c_committed.inc)
        except self.ledger.STALE:
            self._c_stale.inc()
            self.service.events.emit("stale-result-rejected",
                                     job=job.job_id,
                                     replica=self.replica,
                                     epoch=int(lease.epoch))
            return False
        self._observe_e2e(lease, phases)
        self.service.events.emit("job-done", job=job.job_id,
                                 replica=self.replica,
                                 epoch=int(lease.epoch))
        if children or retarget:
            self.service.events.emit("dag-expand", job=job.job_id,
                                     children=len(children or ()),
                                     replica=self.replica)
            # chaos seam: die right after the fan-out transaction
            # landed — the children exist; survivors lease them
            self._chaos("post-sift-commit")
        return True

    @staticmethod
    def _phases(lease, job: Job, now: float) -> Dict[str, float]:
        """One committed job's life decomposed from ledger/event
        timestamps: admit->lease wait, device execute, commit-prep,
        and total, in seconds — the per-bucket cost model the
        control-plane signals (predictive admission, drain-time
        Retry-After, the /scale advisory) consume.  Computed ONCE per
        commit and fed verbatim to both the usage ledger row and the
        `job_e2e_seconds` histogram, so per-tenant device-seconds
        sums reconcile exactly against the fleet metric aggregation.
        """
        sub = float(lease.data.get("submitted") or 0.0)
        leased = float(getattr(job, "leased_at", 0.0) or 0.0)
        phases: Dict[str, float] = {}
        if sub and leased:
            phases["lease_wait"] = max(leased - sub, 0.0)
        if job.started and job.finished:
            phases["execute"] = max(job.finished - job.started, 0.0)
        if job.finished:
            phases["commit"] = max(now - job.finished, 0.0)
        if sub:
            phases["total"] = max(now - sub, 0.0)
        return phases

    def _observe_e2e(self, lease, phases: Dict[str, float]) -> None:
        """Publish the phase decomposition into the
        `job_e2e_seconds{phase,bucket}` histogram (the snapshot/
        aggregation path to `GET /fleet/metrics`)."""
        bucket = str(lease.data.get("bucket") or "")
        for phase, seconds in phases.items():
            self._h_e2e.labels(phase=phase,
                               bucket=bucket).observe(seconds)

    # ---- shutdown parking ---------------------------------------------

    def _park(self, job: Job) -> bool:
        """Scheduler park seam: a retry that met the closed local
        queue goes back to the ledger as pending — requeueable by any
        replica — instead of stranding as a local failure."""
        with self._inflight_lock:
            entry = self._inflight.get(job.job_id)
        if entry is None:
            return False
        lease, _ = entry
        self.ledger.fail(lease, self.replica)
        self._c_redone.inc()
        self._drop(job.job_id)
        return True
