"""Federation: many independent fleets behind one front door.

Host copy of ``presto_tpu/serve/federation.py`` for the PyTorch port
(``python -m presto_tpu_torch.serve.federation`` is `presto-fed`).  One
`FederationRouter` fronts N fleets — each its own fleet directory,
router, supervisor, and card fingerprint — and treats **whole-fleet
death as replica death one level up**:

  * **Fleet liveness ledger** (`FedLedger`): the `LeaseLedger` core
    re-bound a third time, after DM shards (`pipeline/shardledger.py`)
    and fleet jobs (`serve/jobledger.py`) — now the *hosts* are whole
    fleets and the *items* are federated placements.  The federation
    driver heartbeats each member fleet for as long as its router
    answers `/healthz`; a fleet that stops answering (dead or
    partitioned — the ledger cannot and need not distinguish) times
    out, is reaped, and its placements are re-admitted.  The epoch
    bump fences the dead fleet's incarnation: a **zombie fleet's late
    commit is rejected** by the same `_fence_why` discipline that
    rejects a zombie replica's, so nothing is lost and nothing lands
    twice at the federated level.
  * **Priced placement**: each admitted job/DAG is priced in expected
    device-seconds per fleet — the fleet's own per-bucket usage cost
    model first (`obs/slo.bucket_cost_model`), its fleet-median bucket
    cost next, then per-fingerprint perf-ledger episodes
    (`obs/perfledger`: relative throughput across cards), and finally
    a **uniform price** (`default_job_s`) when a fleet has neither
    history nor episodes.  A fleet holding the job's raw data gets a
    locality discount, so ties break toward not moving bytes.  The
    perf ledger is the port's default (beside its tuning DB) or the
    path `FederationConfig.perf_ledger_path` names, never a file of
    the repository.
  * **Spill-over**: a fleet whose `/scale` advisory wants more
    replicas than are ready — or that answered a push with a 429
    shed — sorts behind its unsaturated siblings, so load on a hot
    fleet spills to the next-cheapest one.
  * **Global views are one more fold**: `/fleet/metrics` merges the
    per-fleet `fleetagg` aggregations with the same associative
    `merge`, `/slo` merges per-fleet SLO window states with
    `slo.merge_states` before one `evaluate_state`, and `/usage`
    folds per-fleet rollups — so federated burn-rate math equals the
    single-fleet computation on the merged windows by construction.

Chaos seams: the failover pass fires `FED_KILL_POINTS` through the
standard `FaultInjector` hook (fleet-death / pre-readmit /
post-readmit, and the zombie-fleet commit window).  The federation runs
no device work.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

from presto_tpu_torch.io.atomic import atomic_write_text
from presto_tpu_torch.obs import fleetagg, slo
from presto_tpu_torch.pipeline.leaseledger import (LEASED, PENDING,
                                             LeaseLedger, LedgerError,
                                             StaleLeaseError)
from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.usage import UsageLedger

#: chaos kill points the failover driver fires through its
#: FaultInjector hook — the authoritative runtime copy (re-exported by
#: testing/chaos.py; obs/taxonomy.FED_KILL_POINTS lists the same set)
FED_KILL_POINTS = ("fleet-dead", "pre-readmit", "post-readmit",
                   "zombie-fleet-commit")

#: terminal remote states a placement settles on
_TERMINAL = ("done", "failed")


class FederationError(LedgerError):
    """Federation ledger protocol violation."""


class FedStaleCommit(StaleLeaseError, FederationError):
    """A result arriving from a fleet whose placement lease the
    federation has fenced off — the zombie-fleet case."""


class NoFleetAvailable(RuntimeError):
    """No alive member fleet accepted the placement (503)."""


class FederationBusy(RuntimeError):
    """Every alive fleet is saturated (429 + Retry-After)."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__("every member fleet is saturated "
                         "(retry in %.1fs)" % retry_after_s)


class FedLedger(LeaseLedger):
    """Fleet liveness + placement ledger (`<feddir>/fleets.json`).

    Hosts are member *fleets* (joined with their router URL,
    heartbeated by the federation's probe loop, reaped on silence);
    items are federated *placements* — one row per admitted job or
    DAG, leased to the fleet it was routed to and fence-checked on
    commit exactly like a replica's job lease."""

    LEDGER_NAME = "fleets.json"
    ITEMS_KEY = "placements"
    ERROR = FederationError
    STALE = FedStaleCommit
    EV_LEASE = "fed-place"
    EV_DONE = "fed-commit"
    EV_REDO = "fed-readmit"
    EV_STALE = "fed-stale-commit"
    EV_HOST_DEAD = "fed-fleet-dead"
    EV_EPOCH_BUMP = "fed-epoch-bump"

    def admit(self, item_id: str, kind: str, spec: dict,
              tenant: str, bucket: Optional[str]) -> int:
        """Idempotently admit one federated item (pre-placement);
        returns the not-done count (ensure_items contract)."""
        return self.ensure_items([(item_id, {
            "kind": kind, "spec": spec, "tenant": tenant,
            "bucket": bucket})])

    def place(self, item_id: str, fleet: str, ttl: float,
              now: Optional[float] = None):
        """Targeted lease: bind one pending placement to one alive
        member fleet (the routing decision, durably recorded before
        the job is pushed).  None when the item is no longer pending
        (already placed or terminal — the idempotent-resume case)."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            h = state["hosts"].get(fleet)
            if h is None or not h.get("alive", False):
                raise self.ERROR(
                    "fleet %r is not an alive federation member"
                    % fleet)
            row = self._items(state).get(item_id)
            if row is None:
                raise self.ERROR("unknown federated item %r"
                                 % item_id)
            if row["state"] != PENDING:
                return None
            row["state"] = LEASED
            row["owner"] = fleet
            row["lease_epoch"] = int(state["epoch"])
            row["lease_expires"] = now + ttl
            row["leased_at"] = now
            self._save(state)
            epoch = int(state["epoch"])
        self._event(self.EV_LEASE, item=item_id, host=fleet,
                    epoch=epoch)
        return self._make_lease(item_id, row, epoch)

    def fail_terminal(self, lease, fleet: str, why: str,
                      now: Optional[float] = None) -> None:
        """Fence-checked terminal failure: the remote fleet reported
        the job/DAG failed for good (retry budget exhausted there), so
        the federation must not bounce it between fleets forever."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            bad = self._fence_why(row, lease, fleet)
            if bad is not None:
                self._reject_stale(state, lease, fleet, {}, bad)
            row["state"] = "failed"
            row["owner"] = fleet
            row["lease_epoch"] = None
            row["lease_expires"] = None
            row["failed_why"] = why
            row["completed_at"] = now
            self._save(state)
        self._event(self.EV_DONE, item=lease.item_id, host=fleet,
                    status="failed", why=why)

    def placements(self) -> Dict[str, dict]:
        return dict(self._items(self._load()))

    def adopt_leases(self) -> Dict[str, Tuple[str, object]]:
        """item_id -> (fleet, lease) for every currently leased
        placement — a restarted federation driver resumes polling the
        placements its dead incarnation made (the lease fields are in
        the durable row, so nothing depends on driver memory)."""
        out: Dict[str, Tuple[str, object]] = {}
        state = self._load()
        for iid, row in sorted(self._items(state).items()):
            if row["state"] == LEASED:
                out[iid] = (row["owner"], self._make_lease(
                    iid, row, int(row["lease_epoch"])))
        return out


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------

@dataclass
class FleetMember:
    """One federated fleet: its shared directory (for ledger/obs
    reads — the filesystem is the source of truth), its router URL
    (for pushes and liveness probes), an optional card fingerprint
    (tune/db.fingerprint_key: the perf-ledger pricing key), and the
    data roots it holds locally (the locality preference)."""
    name: str
    fleetdir: str
    url: str = ""
    fingerprint: Optional[str] = None
    data_roots: Tuple[str, ...] = ()


@dataclass
class FederationConfig:
    feddir: str
    fleets: List[FleetMember] = field(default_factory=list)
    poll_s: float = 1.0
    #: fleet heartbeat TTL: a member whose /healthz has not answered
    #: for this long is reaped (dead or partitioned — same remedy)
    heartbeat_ttl: float = 6.0
    #: placement lease TTL (renewed every pump pass while the owning
    #: fleet is alive; expiry alone also triggers re-admission)
    place_ttl: float = 600.0
    http_timeout: float = 4.0
    #: uniform price: expected device-seconds for a job on a fleet
    #: with no usage history and no perf-ledger episodes — the
    #: documented fallback that keeps a cold federation routable
    default_job_s: float = 5.0
    #: price factor for a fleet holding the job's raw data locally
    locality_discount: float = 0.75
    #: perf-ledger workload key used for per-fingerprint pricing
    perf_workload: str = "smoke"
    #: perf-ledger file (None: obs/perfledger.default_ledger_path)
    perf_ledger_path: Optional[str] = None
    #: give up re-placing an item after this many redos (a job that
    #: fails on every fleet is poisoned, not unlucky)
    max_redos: int = 6
    retry_after_s: float = 2.0
    fault_injector: Optional[object] = None


# ----------------------------------------------------------------------
# HTTP plumbing (stdlib only, like the fleet router)
# ----------------------------------------------------------------------

def _http_json(method: str, url: str, body: Optional[dict] = None,
               timeout: float = 4.0) -> Tuple[int, dict]:
    """(status, parsed JSON body) — HTTPError is a response, not an
    exception (the router speaks JSON at every status); URLError and
    timeouts propagate (the fleet is unreachable, which is the
    liveness signal)."""
    data = None
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except ValueError:
            payload = {}
        return e.code, payload


# ----------------------------------------------------------------------
# the federated router
# ----------------------------------------------------------------------

class FederationRouter:
    """Admission + observation front door over N member fleets."""

    def __init__(self, cfg: FederationConfig, obs=None):
        from presto_tpu_torch.obs import Observability, ObsConfig
        if not cfg.fleets:
            raise ValueError("a federation needs at least one fleet")
        self.cfg = cfg
        self.obs = obs or Observability(
            ObsConfig(enabled=True, service="presto-fed"))
        os.makedirs(cfg.feddir, exist_ok=True)
        self.fedledger = FedLedger(cfg.feddir, obs=self.obs)
        self.events = EventLog(
            path=os.path.join(cfg.feddir, "fed_events.jsonl"))
        self._injector = cfg.fault_injector
        self._members = {m.name: m for m in cfg.fleets}
        if len(self._members) != len(cfg.fleets):
            raise ValueError("duplicate fleet names in federation")
        self._usage = {m.name: UsageLedger(m.fleetdir)
                       for m in cfg.fleets}
        self._step_lock = threading.Lock()
        self._state_lock = threading.Lock()  # presto-lint: guards(_epochs, _advice, _shed_until, _placed)
        self._epochs: Dict[str, int] = {}
        self._advice: Dict[str, dict] = {}
        self._shed_until: Dict[str, float] = {}
        self._placed: Dict[str, List[Tuple[str, object]]] = {}
        self._stop = threading.Event()
        self._poll_t: Optional[threading.Thread] = None
        reg = self.obs.metrics
        self._g_alive = reg.gauge(
            "fed_fleets_alive", "Member fleets currently alive")
        self._g_epoch = reg.gauge(
            "fed_epoch", "Federation membership epoch (fence token)")
        self._c_sub = reg.counter(
            "fed_submissions_total",
            "Federated jobs/DAGs pushed to a member fleet",
            ("fleet",))
        self._c_spill = reg.counter(
            "fed_spills_total",
            "Placements routed past a saturated fleet to a sibling")
        self._c_readmit = reg.counter(
            "fed_readmits_total",
            "Placements re-admitted after fleet death or lease "
            "expiry")
        self._c_stale = reg.counter(
            "fed_stale_commits_total",
            "Zombie-fleet commits rejected by the epoch fence")
        self._c_commit = reg.counter(
            "fed_commits_total",
            "Federated results committed through the fence")
        for m in cfg.fleets:
            epoch = self.fedledger.join(m.name, addr=m.url)
            self.fedledger.heartbeat(m.name, epoch)
            with self._state_lock:
                self._epochs[m.name] = epoch
            self.events.emit("fed-fleet-join", fleet=m.name,
                             url=m.url, fleetdir=m.fleetdir,
                             fingerprint=m.fingerprint, epoch=epoch)
        with self._state_lock:
            self._placed.update(
                {iid: [pl] for iid, pl
                 in self.fedledger.adopt_leases().items()})
        self._g_epoch.set(self.fedledger.epoch)
        self._g_alive.set(len(self.alive_fleets()))

    # ---- chaos seam ---------------------------------------------------

    def _point(self, name: str) -> None:
        """Kill-point hook: the stamp is recorded BEFORE the injector
        may kill us, so a dead federation driver's event stream names
        its kill point (mirrors fleet.py's `_chaos`)."""
        if self._injector is None:
            return
        self.events.emit("fed-chaos-point", point=name)
        self._injector.point(name)

    # ---- membership / liveness ----------------------------------------

    def alive_fleets(self, now: Optional[float] = None) -> List[str]:
        return self.fedledger.alive_hosts(
            now, ttl=self.cfg.heartbeat_ttl)

    def probe(self, now: Optional[float] = None) -> Dict[str, bool]:
        """One liveness pass: GET each member router's /healthz; a
        healthy answer heartbeats the fleet (and refreshes its cached
        /scale advisory), silence lets its heartbeat age toward the
        reaper.  A previously-dead fleet that answers again re-joins
        at the current epoch — its fenced placements were already
        re-admitted, so it simply starts fresh."""
        now = time.time() if now is None else now
        results: Dict[str, bool] = {}
        ledger_state = self.fedledger.read()
        for name, m in sorted(self._members.items()):
            ok = False
            if m.url:
                try:
                    status, _ = _http_json(
                        "GET", m.url + "/healthz",
                        timeout=self.cfg.http_timeout)
                    ok = status == 200
                except OSError as e:
                    self.events.emit("fed-probe-error", fleet=name,
                                     error=str(e))
            results[name] = ok
            if not ok:
                continue
            host = ledger_state["hosts"].get(name)
            if host is not None and not host.get("alive", False):
                epoch = self.fedledger.join(name, addr=m.url,
                                            now=now)
                with self._state_lock:
                    self._epochs[name] = epoch
                self.events.emit("fed-fleet-join", fleet=name,
                                 url=m.url, fleetdir=m.fleetdir,
                                 fingerprint=m.fingerprint,
                                 epoch=epoch, rejoin=True)
            with self._state_lock:
                epoch = self._epochs.get(name, 0)
            self.fedledger.heartbeat(name, epoch, now=now)
            self._refresh_advice(m)
        self._g_alive.set(len(self.alive_fleets(now)))
        return results

    def _refresh_advice(self, m: FleetMember) -> None:
        try:
            status, advice = _http_json(
                "GET", m.url + "/scale",
                timeout=self.cfg.http_timeout)
        except OSError:
            return
        if status == 200:
            with self._state_lock:
                self._advice[m.name] = advice

    def tombstone_fleet(self, name: str,
                        now: Optional[float] = None) -> None:
        """Graceful member departure: the reaper re-admits its
        placements immediately instead of waiting out the TTL."""
        self.fedledger.tombstone(name, now=now)

    # ---- placement pricing --------------------------------------------

    def _perf_ledger(self):
        from presto_tpu_torch.obs import perfledger
        path = (self.cfg.perf_ledger_path
                or perfledger.default_ledger_path())
        try:
            return perfledger.PerfLedger.load(path)
        except Exception:
            return None

    def _perf_speed(self, fingerprint: Optional[str]) \
            -> Optional[float]:
        """Geometric-mean throughput of a fingerprint's perf-ledger
        episodes (direction='higher' metrics only) — the relative-
        speed signal that prices a fleet with no usage history of its
        own."""
        if not fingerprint:
            return None
        led = self._perf_ledger()
        if led is None:
            return None
        eps = led.select(fingerprint=fingerprint,
                         workload=self.cfg.perf_workload)
        if not eps:
            eps = led.select(fingerprint=fingerprint)
        vals = []
        for ep in eps[-3:]:
            for m in ep.get("metrics", {}).values():
                if (m.get("direction") == "higher"
                        and isinstance(m.get("median"),
                                       (int, float))
                        and m["median"] > 0.0):
                    vals.append(math.log(float(m["median"])))
        if not vals:
            return None
        return math.exp(sum(vals) / len(vals))

    def price_fleet(self, member: FleetMember,
                    bucket: Optional[str]) -> Tuple[float, str]:
        """(expected device-seconds, source) for one bucket on one
        fleet.  Pricing ladder: the fleet's own per-bucket usage cost
        model -> its fleet-median bucket cost -> per-fingerprint
        perf-ledger episodes (federation-median throughput over this
        fingerprint's throughput, scaled onto default_job_s) -> the
        uniform default_job_s."""
        rows = self._usage[member.name].rows()
        means, _ = slo.bucket_cost_model(rows)
        b = str(bucket or "")
        if b in means:
            return means[b], "usage-bucket"
        if means:
            return (slo.fleet_median_cost(
                means, self.cfg.default_job_s), "usage-median")
        speed = self._perf_speed(member.fingerprint)
        if speed is not None:
            speeds = [s for s in
                      (self._perf_speed(m.fingerprint)
                       for m in self.cfg.fleets) if s is not None]
            ref = sorted(speeds)[len(speeds) // 2]
            return (self.cfg.default_job_s * ref / speed,
                    "perf-ledger")
        return self.cfg.default_job_s, "uniform"

    @staticmethod
    def _is_local(member: FleetMember, spec: dict) -> bool:
        raws = spec.get("rawfiles") or []
        if not member.data_roots or not raws:
            return False
        roots = [os.path.abspath(r) for r in member.data_roots]
        return all(any(os.path.abspath(str(f)).startswith(
            root + os.sep) or os.path.abspath(str(f)) == root
            for root in roots) for f in raws)

    def _saturated(self, name: str,
                   now: Optional[float] = None) -> bool:
        """A fleet is saturated while its last push shed (429,
        honored until Retry-After expires) or its /scale advisory
        wants more replicas than are ready — the same pressure signal
        a supervisor scales on, read as a routing signal here."""
        now = time.time() if now is None else now
        with self._state_lock:
            if now < self._shed_until.get(name, 0.0):
                return True
            advice = self._advice.get(name)
        if not advice:
            return False
        inputs = advice.get("inputs") or {}
        ready = int(inputs.get("ready_replicas") or 0)
        return int(advice.get("wanted_replicas") or 0) > ready

    def candidates(self, bucket: Optional[str], spec: dict,
                   now: Optional[float] = None) -> List[dict]:
        """Alive fleets ordered for placement: unsaturated before
        saturated, then by locality-discounted price, then by name
        (a stable tiebreak).  Every candidate carries its pricing
        provenance for the /fed view and the verdict artifacts."""
        now = time.time() if now is None else now
        alive = set(self.alive_fleets(now))
        out = []
        for name, m in sorted(self._members.items()):
            if name not in alive:
                continue
            price, source = self.price_fleet(m, bucket)
            local = self._is_local(m, spec)
            eff = price * (self.cfg.locality_discount if local
                           else 1.0)
            out.append({"fleet": name, "price_s": price,
                        "effective_s": eff, "source": source,
                        "local": local,
                        "saturated": self._saturated(name, now)})
        out.sort(key=lambda c: (c["saturated"], c["effective_s"],
                                c["fleet"]))
        return out

    # ---- admission ----------------------------------------------------

    @staticmethod
    def _bucket_hint(spec: dict) -> Optional[str]:
        from presto_tpu_torch.serve.router import FleetRouter
        return FleetRouter._bucket_hint(spec)

    def submit(self, spec: dict) -> dict:
        """Durably admit one job to the federation and place it on
        the best-priced alive fleet (spilling past saturated ones).
        The federated job id doubles as the member fleet's job id, so
        a re-push after fleet death is idempotent downstream."""
        with self.obs.span("fed:submit") as span:
            return self._admit("job", spec, span)

    def submit_dag(self, spec: dict) -> dict:
        """Durably admit one discovery DAG.  Failover granularity is
        the whole graph: a dead fleet's unexpanded subtrees cannot be
        grafted node-by-node onto a survivor (the sift's fan-out is
        fleet-local), so the survivor re-admits the DAG under the
        same id and re-expands it there — the federated commit still
        lands exactly once through the fence."""
        with self.obs.span("fed:dag-submit") as span:
            return self._admit("dag", spec, span)

    def _admit(self, kind: str, spec: dict, span) -> dict:
        if not isinstance(spec, dict):
            raise ValueError("spec must be a JSON object")
        tenant = str(spec.get("tenant") or "default")
        span.set_attr("tenant", tenant)
        iid = str(spec.get("job_id") or spec.get("dag_id")
                  or "fed-%s" % uuid.uuid4().hex[:12])
        bucket = self._bucket_hint(spec)
        self.fedledger.admit(iid, kind, spec, tenant, bucket)
        self.events.emit("fed-admit", item=iid, item_kind=kind,
                         tenant=tenant, bucket=bucket)
        placement = self._place_and_push(iid, kind, spec, bucket)
        span.set_attr("item", iid)
        span.set_attr("fleet", placement["fleet"])
        return {"item": iid, "kind": kind, "tenant": tenant,
                "placement": placement}

    def _place_and_push(self, iid: str, kind: str, spec: dict,
                        bucket: Optional[str],
                        now: Optional[float] = None) -> dict:
        """Route one pending item: walk the priced candidate order,
        durably lease the placement, then push to the fleet's router.
        A 429 marks the fleet shed (spill), an unreachable fleet
        releases the lease and tries the next sibling; raises
        FederationBusy / NoFleetAvailable when the walk ends."""
        now = time.time() if now is None else now
        cands = self.candidates(bucket, spec, now)
        # the fleet a pure price ordering would pick — when it is
        # saturated and the walk lands elsewhere, that is a spill
        best = (min(cands, key=lambda c: (c["effective_s"],
                                          c["fleet"]))
                if cands else None)
        with self.obs.span("fed:place", item=iid) as span:
            any_shed = False
            for pos, cand in enumerate(cands):
                name = cand["fleet"]
                member = self._members[name]
                try:
                    lease = self.fedledger.place(
                        iid, name, ttl=self.cfg.place_ttl, now=now)
                except FederationError:
                    continue            # died between census and place
                if lease is None:
                    # no longer pending: placed by a concurrent pass
                    # or already terminal — idempotent resume
                    row = self.fedledger.placements().get(iid, {})
                    return {"fleet": row.get("owner"),
                            "state": row.get("state"),
                            "resumed": True}
                status, detail = self._push(member, iid, kind, spec)
                if status == "ok":
                    with self._state_lock:
                        self._placed.setdefault(iid, []).append(
                            (name, lease))
                    self._c_sub.labels(fleet=name).inc()
                    spilled_past = [c["fleet"] for c in cands[:pos]]
                    if (best is not None and best["fleet"] != name
                            and best["saturated"]
                            and best["fleet"] not in spilled_past):
                        spilled_past.insert(0, best["fleet"])
                    if spilled_past:
                        self._c_spill.inc()
                        self.events.emit(
                            "fed-spill", item=iid, to=name,
                            past=spilled_past,
                            why=("shed" if any_shed
                                 else "saturated"))
                    span.set_attr("fleet", name)
                    return dict(cand, state="leased")
                self.fedledger.fail(lease, name)
                if status == "shed":
                    any_shed = True
                    with self._state_lock:
                        self._shed_until[name] = now + float(
                            detail.get("retry_after_s")
                            or self.cfg.retry_after_s)
                else:
                    self.events.emit("fed-push-error", item=iid,
                                     fleet=name, detail=str(detail))
            if any_shed:
                raise FederationBusy(self.cfg.retry_after_s)
            raise NoFleetAvailable(
                "no alive member fleet accepted %r (%d candidates)"
                % (iid, len(cands)))

    def _push(self, member: FleetMember, iid: str, kind: str,
              spec: dict) -> Tuple[str, dict]:
        """Push one placement to its fleet's router.  'ok' covers the
        duplicate-id answer: the id was minted by the federation, so
        a duplicate means a previous incarnation's push landed — the
        idempotent-resume contract, same as the campaign engine's."""
        if not member.url:
            return "unreachable", {"error": "no router url"}
        body = dict(spec)
        path = "/submit" if kind == "job" else "/dag"
        body["job_id" if kind == "job" else "dag_id"] = iid
        try:
            status, payload = _http_json(
                "POST", member.url + path, body,
                timeout=self.cfg.http_timeout)
        except OSError as e:
            return "unreachable", {"error": str(e)}
        if status == 202:
            return "ok", payload
        if "duplicate" in str(payload.get("error", "")):
            return "ok", payload
        if status == 429:
            return "shed", payload
        return "rejected", payload

    # ---- the pump: placements -> terminal federated commits -----------

    def _remote_view(self, member: FleetMember, iid: str,
                     kind: str) -> Tuple[Optional[dict], str]:
        """(view, via): the placement's state on its fleet — over
        HTTP while the router answers, straight from the fleet
        directory's job ledger otherwise.  The ledger read is how a
        *dead* fleet's landed results are discovered (read-only: the
        federation never writes a member fleet's ledger)."""
        path = ("/jobs/" if kind == "job" else "/dag/") + iid
        if member.url:
            try:
                status, payload = _http_json(
                    "GET", member.url + path,
                    timeout=self.cfg.http_timeout)
                if status == 200:
                    return payload, "http"
                if status == 404:
                    return None, "http"
            except OSError:
                pass
        from presto_tpu_torch.serve.jobledger import JobLedger
        led = JobLedger(member.fleetdir)
        view = (led.view(iid) if kind == "job"
                else led.dag_view(iid))
        return view, "ledger"

    def _commit(self, iid: str, fleet: str, lease, view: dict,
                now: float) -> bool:
        """Land one federated result through the fence: the remote
        terminal view is staged next to the final result path and
        committed under the fleets.json lock (fence-check -> rename
        -> journal).  A zombie fleet's late result dies here — the
        staged file is deleted, the journaled artifact untouched."""
        resdir = os.path.join(self.cfg.feddir, "results")
        os.makedirs(resdir, exist_ok=True)
        final = os.path.join(resdir, "%s.json" % iid)
        tmp = os.path.join(resdir, ".staged-%s.json" % iid)
        atomic_write_text(tmp, json.dumps(
            {"item": iid, "fleet": fleet, "view": view},
            indent=1, sort_keys=True) + "\n")
        ledger_state = self.fedledger.read()
        host = ledger_state["hosts"].get(fleet) or {}
        if not host.get("alive", False):
            # a result surfacing from a fleet the federation has
            # declared dead: the textbook zombie commit
            self._point("zombie-fleet-commit")
        try:
            self.fedledger.complete(
                lease, fleet, {final: tmp}, now=now,
                extra={"remote_state": view.get("state")})
            self._c_commit.inc()
            return True
        except FedStaleCommit:
            self._c_stale.inc()
            return False

    def pump(self, now: Optional[float] = None) -> dict:
        """One pass over live placements: renew leases of alive
        owners, poll each placement's remote state, commit terminal
        results through the fence (failed ones terminally,
        fence-checked too), and place anything pending (admitted but
        never routed, or re-admitted by the reaper)."""
        now = time.time() if now is None else now
        with self._state_lock:
            placed = {iid: list(pls)
                      for iid, pls in self._placed.items()}
        committed, stale = 0, 0
        for iid, pls in sorted(placed.items()):
            for fleet, lease in pls:
                member = self._members.get(fleet)
                if member is None:
                    continue
                row = self.fedledger.placements().get(iid)
                if row is None:
                    self._drop_placement(iid, fleet)
                    continue
                kind = str(row.get("kind") or "job")
                held = (row["state"] == LEASED
                        and row["owner"] == fleet
                        and int(row["lease_epoch"] or -1)
                        == int(lease.epoch))
                view, _via = self._remote_view(member, iid, kind)
                if view is None:
                    if held:
                        # pushed-then-crashed window (or a fleet
                        # that lost the push): re-push, same id
                        self._push(member, iid, kind,
                                   dict(row.get("spec") or {}))
                    elif row["state"] in ("done", "failed"):
                        # fenced-off placement whose fleet never saw
                        # the push: nothing can land late; forget it
                        self._drop_placement(iid, fleet)
                    continue
                if view.get("state") not in _TERMINAL:
                    if held:
                        self.fedledger.renew(
                            lease, fleet, self.cfg.place_ttl,
                            now=now)
                    continue
                # a terminal remote state commits through the fence
                # even when `held` is false — a fenced-off fleet's
                # late result MUST be rejected there (the zombie
                # path), never silently discarded before the fence
                if view.get("state") == "failed":
                    try:
                        self.fedledger.fail_terminal(
                            lease, fleet,
                            "remote %s failed" % kind, now=now)
                    except FedStaleCommit:
                        self._c_stale.inc()
                        stale += 1
                elif self._commit(iid, fleet, lease, view, now):
                    committed += 1
                else:
                    stale += 1
                self._drop_placement(iid, fleet)
        replaced = self._place_pending(now)
        return {"committed": committed, "stale": stale,
                "placed": replaced}

    def _drop_placement(self, iid: str, fleet: str) -> None:
        with self._state_lock:
            pls = self._placed.get(iid) or []
            pls = [(f, l) for f, l in pls if f != fleet]
            if pls:
                self._placed[iid] = pls
            else:
                self._placed.pop(iid, None)

    def _place_pending(self, now: float) -> int:
        """Route every pending placement (fresh admissions that never
        got a fleet, plus items the reaper re-admitted)."""
        n = 0
        for iid, row in sorted(
                self.fedledger.placements().items()):
            if row["state"] != PENDING:
                continue
            if int(row.get("redos", 0)) > self.cfg.max_redos:
                continue
            try:
                self._place_and_push(
                    iid, str(row.get("kind") or "job"),
                    dict(row.get("spec") or {}),
                    row.get("bucket"), now=now)
                n += 1
            except (FederationBusy, NoFleetAvailable):
                break
        return n

    # ---- failover: whole-fleet death as replica death -----------------

    def failover(self, now: Optional[float] = None) -> dict:
        """One failure-detection pass one level up: reap member
        fleets whose heartbeat went silent (dead or partitioned),
        re-admit their placements, and re-route them on survivors —
        through the same epoch fence that re-admits a dead replica's
        jobs, so the dead fleet's late commits are rejected and
        nothing is lost or landed twice."""
        now = time.time() if now is None else now
        with self.obs.span("fed:failover") as span:
            report = self.fedledger.reap(
                self.cfg.heartbeat_ttl, now=now)
            self._g_epoch.set(report.epoch)
            if report.dead_hosts:
                self._point("fleet-dead")
                self._g_alive.set(len(self.alive_fleets(now)))
            readmitted = []
            for iid in report.redone:
                row = self.fedledger.placements().get(iid)
                if row is None or row["state"] != PENDING:
                    continue
                if int(row.get("redos", 0)) > self.cfg.max_redos:
                    continue
                self._point("pre-readmit")
                self._c_readmit.inc()
                try:
                    self._place_and_push(
                        iid, str(row.get("kind") or "job"),
                        dict(row.get("spec") or {}),
                        row.get("bucket"), now=now)
                    readmitted.append(iid)
                    self._point("post-readmit")
                except (FederationBusy, NoFleetAvailable):
                    # stays pending; the next pump pass retries
                    break
            span.set_attr("dead", len(report.dead_hosts))
            span.set_attr("readmitted", len(readmitted))
        return {"dead_fleets": report.dead_hosts,
                "epoch": report.epoch, "bumped": report.bumped,
                "readmitted": readmitted}

    def step(self, now: Optional[float] = None) -> dict:
        """One driver pass (probe -> failover -> pump), serialized so
        the poll loop and an on-demand caller never interleave."""
        now = time.time() if now is None else now
        with self._step_lock:
            self.probe(now)
            fo = self.failover(now)
            pu = self.pump(now)
        return {"failover": fo, "pump": pu}

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "FederationRouter":
        self._stop.clear()
        self._poll_t = threading.Thread(
            target=self._poll_loop, name="presto-fed-poll",
            daemon=True)
        self._poll_t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_t is not None:
            self._poll_t.join(timeout=10.0)
        self.events.close()
        self.obs.tracer.close()

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:
                self.events.emit("fed-probe-error",
                                 error="step: %s" % e)
            self._stop.wait(self.cfg.poll_s)

    # ---- introspection / global folds ---------------------------------

    def status(self, item_id: str) -> Optional[dict]:
        row = self.fedledger.placements().get(item_id)
        if row is None:
            return None
        return {"item": item_id, "state": row["state"],
                "fleet": row.get("owner"),
                "kind": row.get("kind"),
                "redos": int(row.get("redos", 0))}

    def result(self, item_id: str) -> Optional[dict]:
        path = os.path.join(self.cfg.feddir, "results",
                            "%s.json" % item_id)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def fleets_view(self, now: Optional[float] = None) -> dict:
        """GET /fed: the liveness ledger one level up — members with
        aliveness/epochs, placement counts, and the live candidate
        pricing table (empty-bucket pricing: what a cold job would
        pay on each fleet right now)."""
        now = time.time() if now is None else now
        state = self.fedledger.read()
        alive = set(self.alive_fleets(now))
        counts: Dict[str, int] = {}
        for row in state["placements"].values():
            counts[row["state"]] = counts.get(row["state"], 0) + 1
        return {
            "feddir": self.cfg.feddir,
            "epoch": int(state["epoch"]),
            "fleets": {
                name: {"alive": name in alive,
                       "url": m.url,
                       "fingerprint": m.fingerprint,
                       "saturated": self._saturated(name, now)}
                for name, m in sorted(self._members.items())},
            "placements": counts,
            "pricing": self.candidates(None, {}, now),
        }

    def fed_metrics(self, now: Optional[float] = None) -> dict:
        """GET /fleet/metrics: one more fleetagg fold — each member
        fleet's replica snapshots are merged per fleet, then the
        per-fleet merged states are merged again with the same
        associative `merge`, so the federated aggregate equals the
        single-registry aggregate over all snapshots."""
        now = time.time() if now is None else now
        merged: dict = {}
        per: Dict[str, dict] = {}
        for name, m in sorted(self._members.items()):
            agg = fleetagg.aggregate(m.fleetdir, now=now)
            per[name] = {"replicas": agg["replicas"],
                         "stale_replicas": agg["stale_replicas"]}
            merged = fleetagg.merge(merged, agg["merged"])
        return {"feddir": self.cfg.feddir, "fleets": per,
                "metrics": fleetagg.to_json(merged)}

    def slo_view(self, now: Optional[float] = None) -> dict:
        """GET /slo: federated burn rates — per-fleet SLO window
        states merged with `slo.merge_states` (associative +
        commutative) before ONE `evaluate_state`, so the federated
        burn math equals the single-fleet computation on the merged
        windows by construction."""
        now = time.time() if now is None else now
        specs: Dict[str, object] = {}
        for m in self.cfg.fleets:
            for spec in slo.load_specs(m.fleetdir):
                specs.setdefault(spec.tenant, spec)
        tenants = {}
        for tenant, spec in sorted(specs.items()):
            merged = None
            for m in self.cfg.fleets:
                st = slo.window_state(
                    spec, self._usage[m.name].rows(), now)
                merged = (st if merged is None
                          else slo.merge_states(merged, st))
            tenants[tenant] = slo.evaluate_state(spec, merged)
        return {"tenants": tenants,
                "fleets": sorted(self._members)}

    def usage_view(self) -> dict:
        """GET /usage: per-fleet rollups plus the federated rollup
        over the concatenated rows (device-second sums are
        associative, so the fold equals the flat rollup)."""
        per: Dict[str, dict] = {}
        all_rows: List[dict] = []
        for name in sorted(self._members):
            rows = self._usage[name].rows()
            per[name] = slo.usage_rollup(rows)
            all_rows.extend(rows)
        return {"fleets": per,
                "merged": slo.usage_rollup(all_rows)}

    def scale_view(self, now: Optional[float] = None) -> dict:
        """GET /scale: every member's cached advisory plus the
        saturation verdict the placer routes on."""
        now = time.time() if now is None else now
        with self._state_lock:
            advice = dict(self._advice)
        return {"fleets": {
            name: {"advice": advice.get(name),
                   "saturated": self._saturated(name, now)}
            for name in sorted(self._members)}}


# ----------------------------------------------------------------------
# HTTP front door
# ----------------------------------------------------------------------

class _FedHandler(BaseHTTPRequestHandler):
    server_version = "presto-fed/1"

    @property
    def fed(self) -> FederationRouter:
        return self.server.fed          # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, status: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, sort_keys=True).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        path = urlparse(self.path).path
        try:
            if path == "/healthz":
                self._json(200, {"ok": True,
                                 "fleets": self.fed.alive_fleets()})
            elif path == "/fed":
                self._json(200, self.fed.fleets_view())
            elif path == "/fleet/metrics":
                self._json(200, self.fed.fed_metrics())
            elif path == "/slo":
                self._json(200, self.fed.slo_view())
            elif path == "/usage":
                self._json(200, self.fed.usage_view())
            elif path == "/scale":
                self._json(200, self.fed.scale_view())
            elif path == "/events":
                self._json(200, {"events": self.fed.events.tail()})
            elif path.startswith("/jobs/"):
                rest = path[len("/jobs/"):]
                iid, _, tail = rest.partition("/")
                if tail == "result":
                    out = self.fed.result(iid)
                else:
                    out = self.fed.status(iid)
                if out is None:
                    self._json(404, {"error": "unknown item %r"
                                     % iid})
                else:
                    self._json(200, out)
            else:
                self._json(404, {"error": "unknown endpoint"})
        except Exception as e:
            self._json(500, {"error": "%s: %s"
                             % (type(e).__name__, e)})

    def do_POST(self) -> None:
        path = urlparse(self.path).path
        if path not in ("/submit", "/dag"):
            self._json(404, {"error": "unknown endpoint"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            spec = json.loads(self.rfile.read(length) or b"{}")
            if path == "/dag":
                self._json(202, self.fed.submit_dag(spec))
            else:
                self._json(202, self.fed.submit(spec))
        except FederationBusy as e:
            self._json(429, {"error": "federation-saturated",
                             "retry_after_s": e.retry_after_s},
                       headers={"Retry-After": "%d" % max(
                           1, math.ceil(e.retry_after_s))})
        except NoFleetAvailable as e:
            self._json(503, {"error": "no-fleet-available",
                             "detail": str(e)})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:
            self._json(500, {"error": "%s: %s"
                             % (type(e).__name__, e)})


class FedHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, fed: FederationRouter):
        super().__init__(addr, _FedHandler)
        self.fed = fed


def start_fed_http(fed: FederationRouter, host: str = "127.0.0.1",
                   port: int = 0) -> FedHTTPServer:
    httpd = FedHTTPServer((host, port), fed)
    t = threading.Thread(target=httpd.serve_forever,
                         name="presto-fed-http", daemon=True)
    t.start()
    return httpd


# ----------------------------------------------------------------------
# CLI: presto-fed
# ----------------------------------------------------------------------

def parse_fleet(text: str) -> FleetMember:
    """NAME:FLEETDIR[:URL] (URL may itself contain colons)."""
    parts = text.split(":", 2)
    if len(parts) < 2 or not parts[0] or not parts[1]:
        raise ValueError(
            "fleet spec must be NAME:FLEETDIR[:URL], got %r" % text)
    return FleetMember(name=parts[0], fleetdir=parts[1],
                       url=parts[2] if len(parts) > 2 else "")


def build_parser():
    p = argparse.ArgumentParser(prog="presto-fed")
    p.add_argument("-host", type=str, default="127.0.0.1")
    p.add_argument("-port", type=int, default=8787)
    p.add_argument("-feddir", type=str, required=True,
                   help="Federation directory (the fleets.json "
                        "liveness+placement ledger)")
    p.add_argument("-fleet", action="append", default=[],
                   metavar="NAME:FLEETDIR[:URL]", required=True,
                   help="Member fleet (repeatable): its shared fleet "
                        "directory and router URL")
    p.add_argument("-fingerprint", action="append", default=[],
                   metavar="NAME:FINGERPRINT",
                   help="Card fingerprint of one member (the "
                        "perf-ledger pricing key; repeatable)")
    p.add_argument("-data", action="append", default=[],
                   metavar="NAME:ROOT",
                   help="Data root held locally by one member "
                        "(locality preference; repeatable)")
    p.add_argument("-poll", type=float, default=1.0)
    p.add_argument("-hb-ttl", type=float, default=6.0,
                   help="Fleet heartbeat TTL before the reaper "
                        "declares a silent fleet dead")
    p.add_argument("-default-job-s", type=float, default=5.0,
                   help="Uniform-fallback price (expected device-"
                        "seconds) for a fleet with no history")
    p.add_argument("-perf-ledger", type=str, default=None,
                   help="Perf-ledger path for fingerprint pricing "
                        "(default: the port's, beside its tuning "
                        "DB)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fleets = [parse_fleet(t) for t in args.fleet]
    by_name = {m.name: m for m in fleets}
    for spec, attr in ((args.fingerprint, "fingerprint"),
                       (args.data, "data_roots")):
        for text in spec:
            name, _, value = text.partition(":")
            if name not in by_name:
                raise SystemExit("unknown fleet %r in %r"
                                 % (name, text))
            if attr == "fingerprint":
                by_name[name].fingerprint = value
            else:
                by_name[name].data_roots = (
                    by_name[name].data_roots + (value,))
    cfg = FederationConfig(
        feddir=args.feddir, fleets=fleets, poll_s=args.poll,
        heartbeat_ttl=args.hb_ttl,
        default_job_s=args.default_job_s,
        perf_ledger_path=args.perf_ledger)
    fed = FederationRouter(cfg).start()
    httpd = start_fed_http(fed, args.host, args.port)
    host, port = httpd.server_address[:2]
    print("presto-fed: %d fleet(s) behind http://%s:%d "
          "(POST /submit, /dag; GET /fed, /fleet/metrics, /slo, "
          "/usage, /scale, /jobs/<id>)"
          % (len(fleets), host, port))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("presto-fed: shutting down")
    finally:
        httpd.shutdown()
        fed.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
