"""Elastic multi-process execution of the DM-sharded prepsubband.

PyTorch-side copy of ``presto_tpu/parallel/elastic.py`` (host code).
mpiprepsubband partitions the DM axis statically over MPI ranks; one
lost rank stalls the run and loses its DM rows.  Here the partition is
**leased shards** from a filesystem ledger (pipeline/shardledger.py), so
a ``prepsubband -elastic`` cluster keeps going when members die:

  * every process runs the same loop: lease a pending DM shard, compute
    it on its **local** device (no collective on the compute path: the
    ledger is the only coordination), stage the outputs and commit them
    under the ledger's epoch fence;
  * processes heartbeat through the shared workdir (one small atomic
    file each); a missed heartbeat or an expired lease triggers a reap:
    survivors bump the cluster epoch and re-admit the dead member's
    unverified shards;
  * every collective that *is* issued (the join, the final barrier) runs
    under a **barrier timeout** (:func:`timed_call`) instead of stalling;
  * by default ``join()`` is a *ledger rendezvous* (wait for the
    expected process count under the barrier timeout) and never touches
    ``torch.distributed``; ``ElasticConfig.global_mesh=True`` joins the
    gloo process group through parallel/mesh.init_distributed, and after
    an epoch bump ``_reform`` destroys and re-creates it over the
    survivors, best effort, falling back to per-process runs whenever a
    step times out or fails.

The invariant the tests hold: a run that lost a member writes artifacts
byte-equal to a run that never failed, because any process computes any
shard with the same deterministic program.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch.obs import get_obs
from presto_tpu_torch.pipeline.shardledger import (Lease, ShardLedger,
                                                   ShardLedgerError,
                                                   StaleEpochError)

#: staged-output prefix; a host sweeps ITS OWN leftovers at join (a
#: peer's staged files are never touched — they may be mid-commit)
STAGE_PREFIX = ".shard-stage."

#: env seam for runs in subprocesses:
#:   PRESTO_TORCH_ELASTIC_KILL="<point>[:<nth>[:<mode>[:<stall_s>]]]"
#: mode is exit|raise|stall (testing/chaos.FaultInjector modes)
KILL_ENV = "PRESTO_TORCH_ELASTIC_KILL"


class BarrierTimeout(RuntimeError):
    """A cross-host collective exceeded its configured timeout."""

    def __init__(self, name: str, timeout: float):
        self.name = name
        self.timeout = timeout
        super().__init__("collective %r stalled past %.1fs barrier "
                         "timeout" % (name, timeout))


def timed_call(fn: Callable, timeout: float, name: str = "barrier"):
    """Run `fn` (a possibly-stalling collective) in a worker thread
    and give up after `timeout` seconds.  The caller's thread never
    blocks unboundedly; a stalled collective is abandoned to its
    daemon thread and BarrierTimeout raised so the survivors can
    reform instead of hanging the whole cluster."""
    box: dict = {}
    done = threading.Event()

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:      # noqa: BLE001 — re-raised
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="timed-%s" % name)
    t.start()
    if not done.wait(timeout):
        raise BarrierTimeout(name, timeout)
    if "error" in box:
        raise box["error"]
    return box.get("value")


@dataclass
class ElasticConfig:
    """Knobs for the elastic shard loop (wire-safe plain values)."""
    #: upper bound on any cross-host collective (join, sync, shutdown)
    barrier_timeout: float = 60.0
    #: a shard lease not completed/renewed within this window is
    #: re-admitted — the stalled-worker bound
    lease_ttl: float = 120.0
    #: heartbeat write cadence
    heartbeat_interval: float = 2.0
    #: a host silent for this long is declared dead (default: 4x the
    #: heartbeat interval)
    heartbeat_timeout: Optional[float] = None
    #: DM rows per shard; 0 = auto (aim for ~2 shards per host)
    shard_rows: int = 0
    #: sleep while every pending shard is leased elsewhere
    idle_poll: float = 0.25
    #: join the gloo process group (parallel/mesh.init_distributed).
    #: Off by default: the ledger rendezvous needs no communicator, and
    #: a process group whose member died cannot finish its collectives;
    #: with it on, an epoch bump re-forms the group over the survivors.
    global_mesh: bool = False

    @property
    def hb_timeout(self) -> float:
        return (self.heartbeat_timeout
                if self.heartbeat_timeout is not None
                else 4.0 * self.heartbeat_interval)


def default_host_id(procid: Optional[int] = None) -> str:
    """Stable-ish identity for the ledger: explicit process id when a
    cluster grid was given, else host+pid."""
    if procid is not None:
        return "proc%d" % int(procid)
    return "%s-%d" % (socket.gethostname(), os.getpid())


def stage_path(final: str, host: str, epoch: int) -> str:
    """Per-epoch staged name for an artifact a worker is computing —
    committed onto `final` only if the ledger accepts the lease."""
    d, b = os.path.split(os.path.abspath(final))
    return os.path.join(d, "%s%s.%s.e%d" % (STAGE_PREFIX, b, host,
                                            int(epoch)))


def sweep_stale_stage(workdir: str, host: str) -> int:
    """Remove THIS host's leftover staged files (a previous
    incarnation died mid-compute).  Peers' staged files are left
    alone — they may be one ledger-lock away from committing."""
    n = 0
    pat = os.path.join(workdir, STAGE_PREFIX + "*.%s.e*" % host)
    for p in glob.glob(pat):
        with contextlib.suppress(OSError):
            os.remove(p)
            n += 1
    return n


# ----------------------------------------------------------------------
# process-level seams (CLI entry points can't take objects via argv)
# ----------------------------------------------------------------------

_process_injector = None


def set_process_injector(injector) -> None:
    """Thread a chaos FaultInjector into elastic runs started through
    a CLI main() in this process (the survey uses this)."""
    global _process_injector
    _process_injector = injector


def _injector_from_env():
    """Build a FaultInjector from the KILL_ENV spec: the seam a run in
    subprocesses uses to kill or stall one real cluster member at a
    named point."""
    spec = os.environ.get(KILL_ENV, "")
    if not spec:
        return None
    from presto_tpu_torch.testing.chaos import FaultInjector
    parts = spec.split(":")
    point = parts[0]
    nth = int(parts[1]) if len(parts) > 1 and parts[1] else 1
    mode = parts[2] if len(parts) > 2 and parts[2] else "exit"
    stall = float(parts[3]) if len(parts) > 3 and parts[3] else 3600.0
    return FaultInjector(kill_at=point, kill_after=nth, mode=mode,
                         stall_seconds=stall)


def process_injector():
    """The active injector: explicit seam first, then the env spec."""
    return (_process_injector if _process_injector is not None
            else _injector_from_env())


# ----------------------------------------------------------------------
# the cluster
# ----------------------------------------------------------------------

class ElasticCluster:
    """One process's membership in an elastic DM-shard run.

    Lifecycle::

        cluster = ElasticCluster(workdir, host, cfg)
        cluster.join(coordinator, nproc, procid)   # timed, may degrade
        done = cluster.run(shard_specs, compute_fn)
        cluster.close()

    ``stats`` counts what the run saw: heartbeats, shards done, redos,
    epoch bumps, barrier timeouts and fenced (stale) commits.  ``obs``
    (default: the process's, obs.get_obs) receives, when enabled, the
    flight-recorder events of obs/taxonomy.CLUSTER_EVENTS: the ledger's,
    and the cluster's own chaos points, joins, barrier timeouts and
    reforms.
    """

    def __init__(self, workdir: str, host: str,
                 cfg: Optional[ElasticConfig] = None, fault_injector=None,
                 ledger_name: Optional[str] = None, obs=None):
        self.workdir = os.path.abspath(workdir)
        self.host = host
        self.cfg = cfg or ElasticConfig()
        self.fault_injector = (fault_injector
                               if fault_injector is not None
                               else process_injector())
        os.makedirs(self.workdir, exist_ok=True)
        self.obs = obs if obs is not None else get_obs()
        kw = {} if ledger_name is None else {"name": ledger_name}
        self.ledger = ShardLedger(self.workdir, obs=self.obs, **kw)
        self.epoch = 0
        self.distributed = False
        self.coordinator: Optional[str] = None
        self.stats: collections.Counter = collections.Counter()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._last_reap = 0.0

    def _point(self, name: str) -> None:
        """Chaos kill point: flight-recorded first, so a kill here names
        itself in the dump."""
        self.obs.event("chaos-point", point=name, host=self.host)
        if self.fault_injector is not None:
            self.fault_injector.point(name)

    # -- membership ---------------------------------------------------
    def join(self, coordinator: Optional[str] = None,
             nproc: Optional[int] = None,
             procid: Optional[int] = None) -> int:
        """Join the cluster: ledger registration, heartbeat thread and a
        bounded rendezvous.  Never stalls: by default
        (cfg.global_mesh=False) the rendezvous is a ledger poll for the
        expected process count; with global_mesh=True the gloo process
        group is joined under the barrier timeout.  A timeout degrades
        to an independent per-process run: the compute path only uses
        the local device, so that loses nothing.  Returns the epoch
        joined under."""
        sweep_stale_stage(self.workdir, self.host)
        self.coordinator = coordinator
        if self.cfg.global_mesh and coordinator and nproc is not None:
            from presto_tpu_torch.parallel.mesh import init_distributed
            try:
                timed_call(lambda: init_distributed(coordinator, nproc,
                                                    procid),
                           self.cfg.barrier_timeout, "init-distributed")
                self.distributed = True
            except BarrierTimeout:
                self.stats["barrier_timeouts"] += 1
                self.obs.event("barrier-timeout", name="init-distributed",
                               timeout=self.cfg.barrier_timeout)
                print("elastic: cluster join timed out after %.1fs — "
                      "continuing on the local device"
                      % self.cfg.barrier_timeout)
            except Exception as e:
                print("elastic: cluster join failed (%s: %s) — "
                      "continuing on the local device"
                      % (type(e).__name__, e))
        self.epoch = self.ledger.join(self.host, addr=coordinator)
        self._readmit_own_leases()
        self.ledger.heartbeat(self.host, self.epoch)
        self.stats["heartbeats"] += 1
        self.obs.event("cluster-join", host=self.host, epoch=self.epoch,
                       distributed=self.distributed)
        self._hb_thread = threading.Thread(
            target=self._hb_loop, daemon=True,
            name="elastic-hb-%s" % self.host)
        self._hb_thread.start()
        if not self.distributed and nproc is not None and nproc > 1:
            self._rendezvous(int(nproc))
        return self.epoch

    def _rendezvous(self, expected: int) -> bool:
        """Ledger join barrier: wait (bounded by the barrier timeout)
        until ``expected`` processes heartbeat, so a run starts with its
        whole cluster when everyone shows up, and a member that never
        arrives costs only the timeout."""
        deadline = time.time() + self.cfg.barrier_timeout
        while time.time() < deadline:
            alive = self.ledger.alive_hosts(ttl=self.cfg.hb_timeout)
            if len(alive) >= expected:
                return True
            time.sleep(min(0.05, self.cfg.idle_poll))
        self.stats["barrier_timeouts"] += 1
        self.obs.event("barrier-timeout", name="join-rendezvous",
                       timeout=self.cfg.barrier_timeout, expected=expected)
        print("elastic: join rendezvous timed out (%d process(es) "
              "expected) — proceeding with the survivors" % expected)
        return False

    def _readmit_own_leases(self) -> None:
        """A restarting process has no work in flight: any lease the
        ledger still shows under its name belongs to a dead incarnation.
        Expire it now rather than waiting out the TTL."""
        redone = self.ledger.readmit_owned(self.host)
        if redone:
            self.epoch = self.ledger.epoch
            self.stats["epoch_bumps"] += 1
            self.stats["redos"] += len(redone)

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.cfg.heartbeat_interval):
            try:
                self.ledger.heartbeat(self.host, self.epoch)
                self.stats["heartbeats"] += 1
            except OSError:
                pass                       # workdir vanished: dying

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)

    # -- failure detection + reform -----------------------------------
    def maybe_reap(self, now: Optional[float] = None) -> bool:
        """Periodic failure detection; True when membership changed
        (epoch bumped) and a reform was attempted."""
        now = time.time() if now is None else now
        if now - self._last_reap < self.cfg.heartbeat_interval:
            return False
        self._last_reap = now
        report = self.ledger.reap(self.cfg.hb_timeout, now=now)
        alive = self.ledger.alive_hosts(now=now, ttl=self.cfg.hb_timeout)
        if not report.bumped:
            self.epoch = max(self.epoch, report.epoch)   # a peer bumped it
            return False
        self.epoch = report.epoch
        self.stats["epoch_bumps"] += 1
        self.stats["redos"] += len(report.redone)
        self._reform(alive)
        self._point("post-epoch-bump")
        return True

    def _reform(self, alive: List[str]) -> None:
        """Re-form the process group over the survivors, best effort:
        destroy the stalled group under the barrier timeout and join a
        fresh one agreed through the ledger (rank = index among the
        sorted survivors, coordinator port offset by the epoch).  When a
        step fails, carry on per process; the compute path is local
        either way."""
        if not self.distributed:
            return
        import torch.distributed as dist
        with contextlib.suppress(BaseException):
            timed_call(dist.destroy_process_group, self.cfg.barrier_timeout,
                       "destroy-process-group")
        ok = False
        coord = self._reform_coordinator(alive)
        if coord is not None and self.host in alive:
            from presto_tpu_torch.parallel.mesh import init_distributed
            try:
                ok = timed_call(
                    lambda: init_distributed(
                        coord, len(alive), sorted(alive).index(self.host)),
                    self.cfg.barrier_timeout, "reform") == len(alive)
            except BarrierTimeout:
                self.stats["barrier_timeouts"] += 1
                self.obs.event("barrier-timeout", name="reform",
                               timeout=self.cfg.barrier_timeout)
            except Exception:
                ok = False
        self.distributed = ok
        self.obs.event("mesh-reform", mode="cluster" if ok else "local",
                       survivors=sorted(alive), epoch=self.epoch)
        print("elastic: epoch %d — %s over %d survivor(s)"
              % (self.epoch, "process group re-formed" if ok
                 else "per-process", max(len(alive), 1)))

    def _reform_coordinator(self, alive: List[str]) -> Optional[str]:
        if not alive or self.coordinator is None:
            return None
        host, _, port = self.coordinator.rpartition(":")
        try:
            return "%s:%d" % (host, int(port) + self.epoch)
        except ValueError:
            return None

    def barrier(self, name: str = "sync") -> bool:
        """Timed barrier of the process group; False (never a stall) on
        a timeout or a failure."""
        if not self.distributed:
            return True
        import torch.distributed as dist
        try:
            timed_call(dist.barrier, self.cfg.barrier_timeout, name)
            return True
        except BarrierTimeout:
            self.stats["barrier_timeouts"] += 1
            self.obs.event("barrier-timeout", name=name,
                           timeout=self.cfg.barrier_timeout)
            return False
        except Exception:
            return False

    # -- the shard loop -----------------------------------------------
    def run(self, specs: Sequence[Tuple[str, int, int]],
            compute_fn: Callable[[Lease], Dict[str, str]],
            meta: Optional[dict] = None) -> int:
        """Drive the elastic loop until every shard is done.
        ``compute_fn(lease)`` computes the lease's DM rows and returns
        {final_path: staged_path}; this loop owns the lease, the commit
        and its fence, and failure detection.  Returns the number of
        shards THIS process committed."""
        self.ledger.ensure_shards(specs, meta=meta)
        self.ledger.verify_done()
        committed = 0
        while True:
            self.maybe_reap()
            if self.ledger.all_done():
                break
            lease = self.ledger.lease(self.host, self.cfg.lease_ttl)
            if lease is None:
                # every pending shard is leased elsewhere: wait for a
                # peer's commit, or for a reap to re-admit a lost lease
                time.sleep(self.cfg.idle_poll)
                continue
            self.epoch = max(self.epoch, lease.epoch)
            self._point("shard-leased")
            try:
                staged = compute_fn(lease)
            except Exception:
                # a compute error here: release the lease so a peer can
                # try, then surface the error (a bug, not a membership
                # event)
                self.ledger.fail(lease, self.host)
                raise
            self._point("shard-computed")
            self._point("pre-shard-commit")
            try:
                self.ledger.complete(lease, self.host, staged)
                committed += 1
                self.stats["shards_done"] += 1
            except StaleEpochError:
                # fenced: the lease was re-admitted while we computed
                # (presumed dead, or the lease expired); the staged files
                # are gone and the shard is whoever re-leased it's
                self.stats["stale_writes"] += 1
                continue
            except ShardLedgerError as e:
                print("elastic: commit of %s failed (%s) — shard "
                      "re-admitted" % (lease.shard_id, e))
                continue
            self._point("post-shard-commit")
        self.barrier("elastic-done")
        return committed


def run_elastic(workdir: str, host: str,
                specs: Sequence[Tuple[str, int, int]],
                compute_fn: Callable[[Lease], Dict[str, str]],
                cfg: Optional[ElasticConfig] = None,
                coordinator: Optional[str] = None,
                nproc: Optional[int] = None,
                procid: Optional[int] = None, fault_injector=None,
                meta: Optional[dict] = None, obs=None) -> int:
    """One call: join, run every shard, leave.  Returns the number of
    shards this process committed."""
    cluster = ElasticCluster(workdir, host, cfg,
                             fault_injector=fault_injector, obs=obs)
    cluster.join(coordinator, nproc, procid)
    try:
        return cluster.run(specs, compute_fn, meta=meta)
    finally:
        cluster.close()
