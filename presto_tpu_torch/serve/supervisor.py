"""Fleet supervisor: the actuator that closes the control loop.

Host copy of ``presto_tpu/serve/supervisor.py`` for the PyTorch port.
The router derives the decision signals (the durable per-tenant
device-seconds ledger, multi-window burn-rate alerts, the advisory
`GET /scale` wanted-replica count); this module acts on them: a control
loop that polls the router's `/scale` advisory and spawns and drains
real ``python -m presto_tpu_torch.apps.serve`` replica processes.

Design points:

  * **Hysteresis + cooldown.**  The advisory recomputes every router
    poll and flaps with the backlog; the supervisor only actuates
    after `scale_up_after` (resp. `scale_down_after`) *consecutive*
    polls agree, and never twice within `cooldown_s`.  Replacing a
    dead replica is repair, not scaling — it bypasses both gates.
  * **Cheap spin-up.**  Spawned replicas point at the fleet's
    persistent `PlanStore` (`<fleet>/planstore`), so a cold process
    serves a known bucket without rebuilding its plans; the kernel
    libraries are shared through cuda_build's build directory.
  * **Drain is the existing graceful path.**  Scale-down sends
    SIGTERM: the replica stops leasing (503 on /readyz), finishes
    in-flight work, releases leftovers, and writes its heartbeat
    tombstone — the supervisor merely waits, escalating to SIGKILL
    only past `drain_timeout_s` (the lease reaper makes even that
    escalation lossless).
  * **Dead-replica replacement.**  A supervised replica that dies
    (process gone) or goes silent (ledger heartbeat stale while the
    process lives — the wedged case) is replaced immediately; the
    ledger's epoch fence guarantees the replacement and the zombie
    cannot double-commit.
  * **Crash-only supervision.**  The replica registry persists as
    `<fleet>/supervisor.json` (atomic writes) BEFORE each spawn, so a
    supervisor crash at any instant leaves no orphan: a restarted
    supervisor adopts every still-live registered replica (and
    recovers even a mid-spawn child by its `-replica` name on the
    process table, matching only the port's replica module) instead
    of leaking it and spawning anew.  With no supervisor running at
    all, the fleet degrades to the advisory-only behavior — replicas
    keep leasing, nothing is lost.
  * **No device of its own.**  The supervisor never touches CUDA: it
    spawns with `subprocess.Popen` (fork + exec, never a
    `multiprocessing` fork), and each replica's `-device`
    (`SupervisorConfig.device`, "cuda" by default) is its own.

Every decision (spawn / drain / hold / replace, with the advisory
inputs that drove it) is emitted on a durable event stream
(`<fleet>/supervisor_events.jsonl`) and wrapped in a `supervisor:*`
span, so a whole scaling episode is reconstructable from telemetry
alone — `presto-report -fleet` renders the timeline.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from presto_tpu_torch.io.atomic import atomic_write_text
from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.jobledger import JobLedger

REGISTRY_NAME = "supervisor.json"
EVENTS_NAME = "supervisor_events.jsonl"
LOG_DIR = "supervisor_logs"

REGISTRY_VERSION = 1

#: the replica module spawned (and the only one adopted)
SERVE_MODULE = "presto_tpu_torch.apps.serve"

#: replica registry states
SPAWNING = "spawning"
UP = "up"
DRAINING = "draining"


@dataclass
class SupervisorConfig:
    """Knobs of the scaling control loop."""
    fleetdir: str
    router_url: str                   # the /scale advisory source
    poll_s: float = 1.0               # advisory poll cadence
    #: consecutive polls that must agree before actuating (hysteresis
    #: — the advisory recomputes per router poll and flaps with the
    #: backlog; asymmetric defaults scale up eagerly, down lazily)
    scale_up_after: int = 2
    scale_down_after: int = 4
    cooldown_s: float = 5.0           # min seconds between actuations
    min_replicas: int = 1
    max_replicas: int = 8
    drain_timeout_s: float = 30.0     # SIGTERM -> SIGKILL escalation
    spawn_timeout_s: float = 60.0     # first heartbeat deadline
    #: ledger-heartbeat staleness that marks a live process wedged
    heartbeat_timeout: float = 10.0
    replica_prefix: str = "sup"
    workdir: str = ""                 # default <fleet>/supervised
    #: heartbeat knobs handed to spawned replicas
    hb_interval: float = 0.5
    hb_timeout: float = 5.0
    #: extra presto-serve argv appended verbatim to every spawn
    replica_args: List[str] = field(default_factory=list)
    #: each spawned replica's ``-device`` (the supervisor itself runs
    #: no device work)
    device: str = "cuda"
    #: spot capacity as steady state: every `preempt_interval_s`, kill
    #: and replace this fraction of the replicas currently holding
    #: campaign-tenant leases (at least one while any holds one).
    #: 0.0 disables.  Deliberate SIGKILL — the lease reaper and epoch
    #: fence make the loss a latency cost, never a correctness one,
    #: and running it continuously keeps that path exercised rather
    #: than special
    preempt_fraction: float = 0.0
    preempt_interval_s: float = 10.0
    #: the backfill tenant whose lease-holders are preemptable
    preempt_tenant: str = "campaign"


def check_replica_device(device: str) -> None:
    """Refuse a cuda replica device on a machine without a card, before
    anything is spawned (``torch.cuda.is_available`` makes no CUDA
    context in this process)."""
    import torch
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("presto_tpu_torch: no CUDA device is available "
                           "for the replicas; pass device 'cpu' to "
                           "supervise CPU replicas")


def registry_path(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), REGISTRY_NAME)


def events_path(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), EVENTS_NAME)


def load_registry(fleetdir: str) -> dict:
    """The persisted replica registry ({} of replicas when absent or
    unreadable — a supervisor over a fresh fleet starts empty, never
    fails)."""
    try:
        with open(registry_path(fleetdir)) as f:
            doc = json.load(f)
        if int(doc.get("version", -1)) != REGISTRY_VERSION:
            return {"version": REGISTRY_VERSION, "seq": 0,
                    "replicas": {}}
        doc.setdefault("replicas", {})
        doc.setdefault("seq", 0)
        return doc
    except (OSError, ValueError):
        return {"version": REGISTRY_VERSION, "seq": 0, "replicas": {}}


class FleetSupervisor:
    """Spawn/drain actuator over one fleet directory.

    Process-table seams (`_popen`, `_alive`, `_signal`) are instance
    methods so tests drive the full decision machine against a fake
    process table; the real implementations spawn
    ``python -m presto_tpu_torch.apps.serve`` subprocesses.
    """

    def __init__(self, cfg: SupervisorConfig, obs=None):
        from presto_tpu_torch.obs import Observability, ObsConfig
        self.cfg = cfg
        self.obs = obs or Observability(
            ObsConfig(enabled=True, service="presto-supervise"))
        os.makedirs(cfg.fleetdir, exist_ok=True)
        if not cfg.workdir:
            cfg.workdir = os.path.join(cfg.fleetdir, "supervised")
        self.ledger = JobLedger(cfg.fleetdir, obs=self.obs)
        self.events = EventLog(path=events_path(cfg.fleetdir))
        self._reg = load_registry(cfg.fleetdir)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._stop = threading.Event()
        self._loop_t: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # presto-lint: guards(_reg, _procs, _up_streak, _down_streak, _last_actuation, _last_preempt)
        self._up_streak = 0
        self._down_streak = 0
        self._last_actuation = None  # no cooldown before 1st action
        self.last_decision: Optional[dict] = None
        reg = self.obs.metrics
        self._g_replicas = reg.gauge(
            "supervisor_replicas",
            "Replicas currently supervised (spawning + up; draining "
            "ones are already leaving)")
        self._c_spawns = reg.counter(
            "supervisor_spawns_total",
            "Replica processes spawned by the scaling control loop")
        self._c_drains = reg.counter(
            "supervisor_drains_total",
            "Replica drains initiated by the scaling control loop "
            "(SIGTERM graceful path)")
        self._c_replacements = reg.counter(
            "supervisor_replacements_total",
            "Dead or heartbeat-silent replicas replaced outside the "
            "hysteresis/cooldown gates")
        self._c_holds = reg.counter(
            "supervisor_holds_total",
            "Actuations withheld by hysteresis or cooldown while the "
            "advisory disagreed with the current fleet size")
        self._c_preemptions = reg.counter(
            "campaign_preemptions_total",
            "Campaign-leased replicas deliberately killed and "
            "replaced by the supervisor's preempt-fraction pacing "
            "(spot capacity as steady state)")
        self._last_preempt: Optional[float] = None

    # ---- process-table seams (overridden by the fake-table tests) ----

    def _popen(self, name: str, argv: List[str]) -> int:  # presto-lint: holds(_lock)
        """Spawn one replica process; returns its pid.  stdout/stderr
        land in <fleet>/supervisor_logs/<name>.log so a failed spawn
        is diagnosable."""
        logdir = os.path.join(self.cfg.fleetdir, LOG_DIR)
        os.makedirs(logdir, exist_ok=True)
        # children must import presto_tpu even when the package is
        # run from a source tree rather than installed: carry the
        # package root on PYTHONPATH (cwd is the fleet dir)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = (pkg_root + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(
                                 os.pathsep)
        log = open(os.path.join(logdir, name + ".log"), "ab")
        try:
            proc = subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                cwd=self.cfg.fleetdir, env=env)
        finally:
            log.close()
        self._procs[name] = proc
        return proc.pid

    def _alive(self, name: str, pid: Optional[int]) -> bool:  # presto-lint: holds(_lock)
        proc = self._procs.get(name)
        if proc is not None:
            return proc.poll() is None
        if pid is None:
            return False
        try:
            os.kill(int(pid), 0)
            return True
        except (OSError, ValueError):
            return False

    # presto-lint: holds(_lock)
    def _signal(self, name: str, pid: Optional[int],
                sig: int) -> None:
        proc = self._procs.get(name)
        try:
            if proc is not None:
                proc.send_signal(sig)
            elif pid is not None:
                os.kill(int(pid), sig)
        except (OSError, ValueError):
            pass

    def _reap(self, name: str) -> None:  # presto-lint: holds(_lock)
        """Collect the exit status of an owned child (adopted pids
        have no Popen handle; init reaps them)."""
        proc = self._procs.pop(name, None)
        if proc is not None:
            try:
                proc.wait(timeout=0.1)
            except Exception:
                pass

    @staticmethod
    def find_pid_by_replica(name: str) -> Optional[int]:
        """Best-effort /proc sweep for a port replica process
        (``-m presto_tpu_torch.apps.serve``) whose argv names this
        replica — the recovery path for a spawn the previous supervisor
        registered but crashed before recording the pid of.  The
        module must be an argv token of its own, so a JAX package
        replica is never adopted."""
        try:
            pids = [p for p in os.listdir("/proc") if p.isdigit()]
        except OSError:
            return None
        for pid in pids:
            try:
                with open("/proc/%s/cmdline" % pid, "rb") as f:
                    argv = f.read().split(b"\0")
            except OSError:
                continue
            if (SERVE_MODULE.encode() in argv
                    and b"-replica" in argv and name.encode() in argv):
                return int(pid)
        return None

    # ---- registry persistence ----------------------------------------

    def _save_registry(self) -> None:  # presto-lint: holds(_lock)
        atomic_write_text(
            registry_path(self.cfg.fleetdir),
            json.dumps(self._reg, indent=1, sort_keys=True) + "\n")

    def replicas(self) -> Dict[str, dict]:
        with self._lock:
            return {n: dict(r)
                    for n, r in self._reg["replicas"].items()}

    def _count_serving(self) -> int:  # presto-lint: holds(_lock)
        """Replicas that count toward the fleet size the advisory is
        compared against: spawning + up.  Draining ones are already
        leaving — counting them would mask the need to spawn."""
        return sum(1 for r in self._reg["replicas"].values()
                   if r["state"] in (SPAWNING, UP))

    # ---- advisory ----------------------------------------------------

    def _fetch_advice(self) -> Optional[dict]:
        """GET /scale from the router (None when unreachable — the
        loop holds rather than acting on a dead signal)."""
        url = self.cfg.router_url.rstrip("/") + "/scale"
        try:
            with urllib.request.urlopen(url, timeout=5.0) as r:
                return json.loads(r.read())
        except Exception:
            return None

    # ---- actuation ---------------------------------------------------

    def _spawn_argv(self, name: str) -> List[str]:
        return ([sys.executable, "-m", SERVE_MODULE,
                 "-fleet", self.cfg.fleetdir,
                 "-replica", name,
                 "-workdir", os.path.join(self.cfg.workdir, name),
                 "-port", "0",
                 "-hb-interval", str(self.cfg.hb_interval),
                 "-hb-timeout", str(self.cfg.hb_timeout),
                 "-device", str(self.cfg.device)]
                + list(self.cfg.replica_args))

    # presto-lint: holds(_lock)
    def _spawn_one(self, now: float, why: str,
                   advice: Optional[dict]) -> Optional[str]:
        """Register-then-spawn one replica (the registry row lands on
        disk BEFORE the fork, so a crash in between strands a *named*
        row the next supervisor can match to the process table — never
        an anonymous orphan)."""
        self._reg["seq"] = int(self._reg["seq"]) + 1
        name = "%s-%04d" % (self.cfg.replica_prefix, self._reg["seq"])
        self._reg["replicas"][name] = {
            "state": SPAWNING, "pid": None, "spawned": now,
            "deadline": now + self.cfg.spawn_timeout_s, "why": why,
        }
        self._save_registry()
        with self.obs.span("supervisor:spawn", replica=name) as span:
            try:
                pid = self._popen(name, self._spawn_argv(name))
            except Exception as e:
                del self._reg["replicas"][name]
                self._save_registry()
                span.set_attr("error", str(e))
                self.events.emit("supervisor-spawn-failed",
                                 replica=name, why=str(e))
                self.obs.event("supervisor-spawn-failed",
                               replica=name)
                return None
            self._reg["replicas"][name]["pid"] = pid
            self._save_registry()
            span.set_attr("pid", pid)
        self._c_spawns.inc()
        self.events.emit("supervisor-spawn", replica=name, pid=pid,
                         why=why, **self._advice_fields(advice))
        self.obs.event("supervisor-spawn", replica=name)
        return name

    # presto-lint: holds(_lock)
    def _drain_one(self, now: float, why: str,
                   advice: Optional[dict]) -> Optional[str]:
        """SIGTERM the youngest up replica: stop leasing, finish
        in-flight, tombstone — the existing graceful path."""
        up = [(r["spawned"], n)
              for n, r in self._reg["replicas"].items()
              if r["state"] == UP]
        if not up:
            return None
        name = max(up)[1]
        row = self._reg["replicas"][name]
        row["state"] = DRAINING
        row["drain_deadline"] = now + self.cfg.drain_timeout_s
        self._save_registry()
        with self.obs.span("supervisor:drain", replica=name):
            self._signal(name, row["pid"], signal.SIGTERM)
        self._c_drains.inc()
        self.events.emit("supervisor-drain", replica=name,
                         pid=row["pid"], why=why,
                         **self._advice_fields(advice))
        self.obs.event("supervisor-drain", replica=name)
        return name

    @staticmethod
    def _advice_fields(advice: Optional[dict]) -> dict:
        """The advisory inputs that drove a decision, flattened into
        the event payload so a scaling episode replays from the event
        stream alone."""
        if not advice:
            return {"wanted": None, "advice_reason": "unreachable"}
        return {"wanted": advice.get("wanted_replicas"),
                "advice_reason": advice.get("reason"),
                "inputs": advice.get("inputs", {})}

    # ---- lifecycle reconciliation ------------------------------------

    def _reconcile(self, now: float) -> None:  # presto-lint: holds(_lock)
        """One pass over the registry: confirm spawns (first ledger
        heartbeat), finish drains (process exit; SIGKILL past the
        deadline), and replace dead or heartbeat-silent replicas
        (repair bypasses hysteresis and cooldown)."""
        dirty = False
        for name in sorted(self._reg["replicas"]):
            row = self._reg["replicas"][name]
            alive = self._alive(name, row.get("pid"))
            hb = self.ledger.last_heartbeat(name)
            if row["state"] == SPAWNING:
                if hb is not None and hb >= row["spawned"]:
                    row["state"] = UP
                    dirty = True
                    self.events.emit("supervisor-up", replica=name,
                                     pid=row["pid"],
                                     warmup_s=round(now
                                                    - row["spawned"],
                                                    3))
                    self.obs.event("supervisor-up", replica=name)
                elif not alive or now > row["deadline"]:
                    if alive:
                        self._signal(name, row.get("pid"),
                                     signal.SIGKILL)
                    self._reap(name)
                    del self._reg["replicas"][name]
                    dirty = True
                    self.events.emit("supervisor-spawn-failed",
                                     replica=name, pid=row.get("pid"),
                                     why=("no heartbeat within %gs"
                                          % self.cfg.spawn_timeout_s
                                          if alive
                                          else "process exited"))
                    self.obs.event("supervisor-spawn-failed",
                                   replica=name)
            elif row["state"] == UP:
                stale = (hb is not None
                         and now - hb > self.cfg.heartbeat_timeout)
                if not alive or stale:
                    why = ("process died" if not alive
                           else "heartbeat stale %.1fs"
                           % (now - hb))
                    if alive:    # wedged: escalate straight to KILL
                        self._signal(name, row.get("pid"),
                                     signal.SIGKILL)
                    self._reap(name)
                    del self._reg["replicas"][name]
                    dirty = True
                    with self.obs.span("supervisor:replace",
                                       replica=name) as span:
                        span.set_attr("why", why)
                        new = self._spawn_one(now,
                                              "replace %s (%s)"
                                              % (name, why), None)
                    self._c_replacements.inc()
                    self.events.emit("supervisor-replace",
                                     replica=name,
                                     replacement=new, why=why)
                    self.obs.event("supervisor-replace",
                                   replica=name)
            elif row["state"] == DRAINING:
                if not alive:
                    self._reap(name)
                    del self._reg["replicas"][name]
                    dirty = True
                    self.events.emit("supervisor-drained",
                                     replica=name, pid=row.get("pid"))
                    self.obs.event("supervisor-drained",
                                   replica=name)
                elif now > row.get("drain_deadline", now):
                    self._signal(name, row.get("pid"),
                                 signal.SIGKILL)
                    row["drain_deadline"] = now + 5.0
                    dirty = True
                    self.events.emit("supervisor-drain-timeout",
                                     replica=name, pid=row.get("pid"))
                    self.obs.event("supervisor-drain-timeout",
                                   replica=name)
        if dirty:
            self._save_registry()

    def adopt(self, now: Optional[float] = None) -> List[str]:
        """Reconcile a restarted supervisor against the persisted
        registry: adopt every registered replica whose process still
        runs (matching a pid-less mid-spawn row to the process table
        by its `-replica` name), drop the rest — so a supervisor
        crash leaves no orphan and its restart spawns nothing it
        already owns."""
        now = time.time() if now is None else now
        adopted: List[str] = []
        with self._lock:
            for name in sorted(self._reg["replicas"]):
                row = self._reg["replicas"][name]
                pid = row.get("pid")
                if pid is None:
                    pid = self.find_pid_by_replica(name)
                    row["pid"] = pid
                if pid is not None and self._alive(name, pid):
                    if row["state"] == SPAWNING:
                        row["deadline"] = (now
                                           + self.cfg.spawn_timeout_s)
                    adopted.append(name)
                    self.events.emit("supervisor-adopt", replica=name,
                                     pid=pid, state=row["state"])
                    self.obs.event("supervisor-adopt", replica=name)
                else:
                    del self._reg["replicas"][name]
            self._save_registry()
        return adopted

    # ---- the decision step -------------------------------------------

    def step(self, now: Optional[float] = None) -> dict:
        """One control iteration: reconcile replica lifecycles, fetch
        the advisory, apply hysteresis + cooldown, actuate.  Returns
        the decision dict (also kept as `last_decision`)."""
        now = time.time() if now is None else now
        with self._lock:
            self._reconcile(now)
            self._preempt(now)
            advice = self._fetch_advice()
            current = self._count_serving()
            decision = self._decide(now, advice, current)
            self._g_replicas.set(self._count_serving())
        self.last_decision = decision
        return decision

    # presto-lint: holds(_lock)
    def _preempt(self, now: float) -> List[str]:
        """The preempt-fraction pacer: every `preempt_interval_s`,
        SIGKILL-and-replace a paced number of UP replicas currently
        holding campaign-tenant leases — spot capacity as a normal
        operating mode, not a chaos-test special case.  Deliberately
        the rudest path (no drain): the leases are reaped, the epoch
        fence rejects the dead replica's late commits, and the
        replacement rides the ordinary spawn path — exactly the
        machinery FLEET_CHAOS.json proves lossless.  Interactive
        tenants are untouched: only holders of `preempt_tenant`
        leases qualify."""
        cfg = self.cfg
        if cfg.preempt_fraction <= 0.0:
            return []
        if (self._last_preempt is not None
                and now - self._last_preempt < cfg.preempt_interval_s):
            return []
        try:
            owners = self.ledger.lease_owners(cfg.preempt_tenant)
        except Exception:
            return []
        holders = sorted(
            (n for n, r in self._reg["replicas"].items()
             if r["state"] == UP and owners.get(n)),
            key=lambda n: -owners[n])
        if not holders:
            return []
        n_kill = min(len(holders),
                     max(1, int(round(cfg.preempt_fraction
                                      * len(holders)))))
        preempted: List[str] = []
        self._last_preempt = now
        for name in holders[:n_kill]:
            row = self._reg["replicas"][name]
            with self.obs.span("campaign:preempt",
                               replica=name) as span:
                span.set_attr("leases", owners.get(name, 0))
                self._signal(name, row.get("pid"), signal.SIGKILL)
                self._reap(name)
                del self._reg["replicas"][name]
                new = self._spawn_one(
                    now, "preempt %s (campaign lane)" % name, None)
                span.set_attr("replacement", new)
            self._c_preemptions.inc()
            self.events.emit("campaign-preempt", replica=name,
                             replacement=new,
                             leases=owners.get(name, 0),
                             tenant=cfg.preempt_tenant)
            self.obs.event("campaign-preempt", replica=name)
            preempted.append(name)
        return preempted

    # presto-lint: holds(_lock)
    def _decide(self, now: float, advice: Optional[dict],
                current: int) -> dict:
        base = {"ts": now, "current": current,
                **self._advice_fields(advice)}
        if advice is None:
            self._up_streak = self._down_streak = 0
            return dict(base, action="hold", why="advisory-unreachable")
        wanted = min(max(int(advice.get("wanted_replicas", current)),
                         self.cfg.min_replicas),
                     self.cfg.max_replicas)
        base["wanted"] = wanted
        if wanted > current:
            self._up_streak += 1
            self._down_streak = 0
        elif wanted < current:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
            return dict(base, action="steady")
        cooldown_left = (0.0 if self._last_actuation is None
                         else (self._last_actuation
                               + self.cfg.cooldown_s) - now)
        if wanted > current and self._up_streak \
                >= self.cfg.scale_up_after and cooldown_left <= 0:
            with self.obs.span("supervisor:decide",
                               action="spawn") as span:
                span.set_attr("wanted", wanted)
                span.set_attr("current", current)
                names = [self._spawn_one(now, "scale-up", advice)
                         for _ in range(wanted - current)]
            self._last_actuation = now
            self._up_streak = 0
            return dict(base, action="spawn",
                        replicas=[n for n in names if n])
        if wanted < current and self._down_streak \
                >= self.cfg.scale_down_after and cooldown_left <= 0:
            with self.obs.span("supervisor:decide",
                               action="drain") as span:
                span.set_attr("wanted", wanted)
                span.set_attr("current", current)
                names = [self._drain_one(now, "scale-down", advice)
                         for _ in range(current - wanted)]
            self._last_actuation = now
            self._down_streak = 0
            return dict(base, action="drain",
                        replicas=[n for n in names if n])
        # hysteresis is the outer gate: a hold only blames the
        # cooldown once the streak would otherwise have actuated
        streak_met = (self._up_streak >= self.cfg.scale_up_after
                      if wanted > current
                      else self._down_streak
                      >= self.cfg.scale_down_after)
        why = ("cooldown %.1fs" % cooldown_left if streak_met
               else "hysteresis %d/%d"
               % (self._up_streak or self._down_streak,
                  self.cfg.scale_up_after if wanted > current
                  else self.cfg.scale_down_after))
        self._c_holds.inc()
        with self.obs.span("supervisor:decide", action="hold") as span:
            span.set_attr("wanted", wanted)
            span.set_attr("current", current)
            span.set_attr("why", why)
        out = dict(base, action="hold", why=why)
        self.events.emit("supervisor-hold", **out)
        self.obs.event("supervisor-hold")
        return out

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "FleetSupervisor":
        adopted = self.adopt()
        self.events.emit("supervisor-start", adopted=adopted,
                         min_replicas=self.cfg.min_replicas,
                         max_replicas=self.cfg.max_replicas,
                         cooldown_s=self.cfg.cooldown_s,
                         scale_up_after=self.cfg.scale_up_after,
                         scale_down_after=self.cfg.scale_down_after)
        self.obs.event("supervisor-start")
        self._stop.clear()
        self._loop_t = threading.Thread(
            target=self._loop, name="presto-supervisor",
            daemon=True)
        self._loop_t.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                self.obs.event("supervisor-step-error")
            self._stop.wait(self.cfg.poll_s)

    def stop(self) -> None:
        """Stop supervising, leave replicas RUNNING: supervisor death
        degrades the fleet to the advisory-only behavior, and the
        persisted registry lets the next supervisor adopt everything
        — stopping must never be the event that loses work."""
        self._stop.set()
        if self._loop_t is not None:
            self._loop_t.join(timeout=10.0)
        with self._lock:
            left = sorted(self._reg["replicas"])
        self.events.emit("supervisor-stop", replicas=left)
        self.obs.event("supervisor-stop")
        self.events.close()

    def drain_all(self, timeout: Optional[float] = None) -> None:
        """Tear the supervised fleet down (tool/test teardown — NOT
        the normal stop path): SIGTERM everything, SIGKILL past the
        deadline, clear the registry."""
        deadline = time.time() + (timeout
                                  or self.cfg.drain_timeout_s)
        with self._lock:
            rows = dict(self._reg["replicas"])
            for name, row in rows.items():
                self._signal(name, row.get("pid"), signal.SIGTERM)
            while time.time() < deadline and any(
                    self._alive(n, r.get("pid"))
                    for n, r in rows.items()):
                time.sleep(0.1)
            for name, row in rows.items():
                if self._alive(name, row.get("pid")):
                    self._signal(name, row.get("pid"),
                                 signal.SIGKILL)
                self._reap(name)
            self._reg["replicas"] = {}
            self._save_registry()
