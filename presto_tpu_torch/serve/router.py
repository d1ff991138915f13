"""Fleet front door: durable admission, load shedding, tenant quotas.

Host copy of ``presto_tpu/serve/router.py`` for the PyTorch port; it
runs no device work (``python3 -m presto_tpu_torch.serve.router
-fleet DIR`` starts it).

The router is deliberately *not* a proxy holding jobs in memory — the
single-process serve layer already showed why that loses: a crash
forfeits every queued job.  `POST /submit` here lands the job
directly in the shared on-disk ledger (`serve/jobledger.py`), and the
replicas *pull* work by leasing — so "fanning submissions across
replicas" is the lease protocol itself: a draining or cold replica
(503 on `/readyz`) simply stops leasing and traffic flows around it
with no routing table to go stale, and a replica crash strands
nothing the reaper cannot re-admit.

What the router adds on top of the ledger:

  * **Load shedding** — when fleet depth (pending + leased) crosses
    the high-water mark, `/submit` answers 429 with a `Retry-After`
    header: the fleet-scale twin of the in-process queue's bounded-
    depth backpressure (QueueFull -> 429).  A second, *priced* mark
    (`high_water_ds`) sheds on the backlog's expected device-seconds
    under the per-bucket execute cost model, so few huge jobs and
    many tiny jobs back the fleet up equivalently.
  * **Tenant quotas** — `JobLedger.admit` enforces per-tenant quotas
    counted in active jobs AND priced in expected device-seconds
    (`ds_quota`); the typed `TenantQuotaExceeded` maps to a 429
    whose body names the tenant, quota, and unit
    (`error: "quota-exceeded"`), and a `quota-exceeded` event is
    recorded — never a silent drop.  Weighted round-robin *fairness*
    between tenants is the ledger's lease policy (deficit WRR over
    the `tenant` job field, with SLO-class weight multipliers from
    `<fleet>/slo.json`).
  * **Fleet view** — `/fleet` aggregates the ledger (depth, epoch,
    tenant counts) with each registered replica's `/readyz` (polled;
    replicas register their HTTP address at ledger join), and the
    router runs the idempotent reaper so a fleet whose every replica
    died still re-admits leases the moment one returns.

Wire protocol (stdlib HTTP + JSON, like server.py):

  POST /submit            {"rawfiles": [...], "config": {...},
                           "tenant": "...", "priority": int}
                          -> 202 ledger job view
                          429 shed (Retry-After) / quota-exceeded
                          503 no ready replica registered
  POST /dag               {"rawfiles": [...], "config": {...},
                           "sift": {...}, "fold": {...},
                           "toa": {...}, "tenant": "..."}
                          -> 202 {dag_id, nodes} — one discovery DAG
                          (search -> sift -> folds -> timing)
                          admitted as ONE durable transaction
                          (serve/dag.py); same 429/503 semantics
  GET  /dag/<id>          aggregate DAG view (per-node states)
  POST /campaign          {"id": "...", "manifest": [<POST /dag
                           specs>], "wave_size": int, "tenant": ...,
                           "weight": float, "priority": int}
                          -> 202 campaign status.  Creation is
                          idempotent (re-POSTing an existing id
                          resumes it); the first wave is admitted
                          inline and the router's poll loop keeps
                          pulsing every campaign it has touched —
                          safely alongside an external
                          presto-campaign driver (serve/campaign.py
                          serializes pulses per campaign).  No shed
                          or ready-replica gate: a campaign IS the
                          backlog, bounded to wave_size outstanding
                          DAGs by its own ledger.
  GET  /campaign          campaign ids with state + counts
  GET  /campaign/<id>     full status + live ETA/cost projection
  GET  /jobs/<id>         ledger job view (404 unknown)
  GET  /jobs/<id>/result  committed result.json (409 until done)
  GET  /fleet             topology + readiness + tenant counts
  GET  /healthz           router liveness
  GET  /metrics           router-process metrics (JSON;
                          ?format=prometheus)
  GET  /fleet/metrics     FLEET-WIDE aggregation over the replicas'
                          atomic snapshots (obs/fleetagg.py):
                          counters summed, gauges per-replica,
                          histograms bucket-merged so fleet p50/p99
                          are real percentiles; JSON by default,
                          Prometheus via Accept/?format= exactly
                          like /metrics; snapshots older than 3x
                          their publish interval are flagged stale
  GET  /slo               per-tenant SLO state (error budget, multi-
                          window burn rates, alert state) evaluated
                          over the durable usage ledger (obs/slo.py)
  GET  /usage             per-tenant/per-bucket device-seconds
                          rollup from <fleet>/usage.jsonl
  GET  /scale             advisory {wanted_replicas, reason}: ledger
                          backlog priced in expected device-seconds
                          over per-replica measured capacity, plus
                          SLO-debt pressure — recorded in the
                          slo_wanted_replicas gauge and an
                          slo-scale-advice event on every change so
                          a supervisor can replay decisions from
                          telemetry alone
  GET  /events?n=100      router event tail

Load shedding quotes `Retry-After` from the fleet-aggregated
`job_e2e_seconds` drain estimate (backlog x mean execute seconds /
ready replicas) when replica snapshots are available, falling back
to the configured constant; the chosen value is recorded in the
`shed` event payload.
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
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import urlparse, parse_qs

from presto_tpu_torch.obs import fleetagg, slo
from presto_tpu_torch.serve import campaign
from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.jobledger import (DEFAULT_TENANT, JobLedger,
                                              TenantQuotaExceeded)
from presto_tpu_torch.serve.queue import QueueFull


class FleetBusy(QueueFull):
    """Fleet depth crossed the high-water mark: shed with 429 +
    Retry-After (the ledger-scale twin of QueueFull)."""

    def __init__(self, depth: int, high_water: int,
                 retry_after_s: float):
        self.depth = depth
        self.high_water = high_water
        self.retry_after_s = retry_after_s
        super().__init__("fleet depth %d at high-water mark %d"
                         % (depth, high_water))


class NoReadyReplica(RuntimeError):
    """No registered replica is currently ready (503: clients should
    retry; jobs already admitted keep draining when one returns)."""


@dataclass
class RouterConfig:
    fleetdir: str
    high_water: int = 256          # shed point over pending+leased
    #: shed point over the backlog's EXPECTED DEVICE-SECONDS (priced
    #: by the per-bucket execute cost model, fleet-median fallback);
    #: 0 disables — the count-based high_water stays the backstop
    high_water_ds: float = 0.0
    retry_after_s: float = 2.0
    heartbeat_timeout: float = 10.0
    poll_s: float = 2.0            # replica /readyz poll cadence
    require_ready: bool = True     # 503 /submit with no ready replica
    #: "name:weight[:quota[:ds_quota]]" tenant configs applied at
    #: start (empty quota field skips it: "gold:4::120" is weight 4,
    #: no job-count quota, 120 expected device-seconds)
    tenants: List[str] = field(default_factory=list)
    #: "tenant:objective[:latency_s]" SLO specs (obs/slo.py);
    #: persisted to <fleet>/slo.json so the fleet report and a
    #: future supervisor share the source of truth.  Empty: reuse a
    #: previously persisted spec file, if any.
    slo: List[str] = field(default_factory=list)
    #: "fast:slow:threshold[,...]" burn-window override applied to
    #: every -slo spec ("" keeps the 5m/1h + 30m/6h SRE defaults)
    slo_windows: str = ""
    #: /scale advisory knobs (obs/slo.ScaleConfig)
    scale_target_drain_s: float = 30.0
    scale_min_replicas: int = 1
    scale_max_replicas: int = 16


class FleetRouter:
    """Admission + observation front door over one fleet directory."""

    def __init__(self, cfg: RouterConfig, obs=None):
        from presto_tpu_torch.obs import Observability, ObsConfig
        self.cfg = cfg
        self.obs = obs or Observability(
            ObsConfig(enabled=True, service="presto-router"))
        os.makedirs(cfg.fleetdir, exist_ok=True)
        self.ledger = JobLedger(cfg.fleetdir, obs=self.obs)
        self.events = EventLog()
        self._t0 = time.time()
        self._ready: Dict[str, Optional[dict]] = {}
        self._ready_lock = threading.Lock()
        self._stop = threading.Event()
        self._poll_t: Optional[threading.Thread] = None
        # fleet observability: the router's admission spans stream
        # into the shared obs dir (they are the ROOT spans of every
        # cross-process trace), and the poll loop refreshes a cached
        # fleet metric aggregation for Retry-After quoting
        if self.obs.enabled:
            self.obs.tracer.attach_jsonl(fleetagg.span_stream_path(
                cfg.fleetdir, "router-%d" % os.getpid()))
        self._agg: Optional[dict] = None
        for spec in cfg.tenants:
            parts = spec.split(":")
            self.ledger.set_tenant(
                parts[0],
                weight=(float(parts[1]) if len(parts) > 1
                        and parts[1] else 1.0),
                quota=(int(parts[2]) if len(parts) > 2
                       and parts[2] else None),
                ds_quota=(float(parts[3]) if len(parts) > 3
                          and parts[3] else None))
        # SLO observatory: declarative per-tenant specs, persisted as
        # <fleet>/slo.json (a restarted router with no -slo flags
        # reuses the persisted set); evaluation runs in the poll loop
        # and on demand from /slo, /usage, /scale
        windows = slo.parse_windows(cfg.slo_windows)
        if cfg.slo:
            self._slo_specs = [slo.parse_spec(s, windows=windows)
                               for s in cfg.slo]
            slo.save_specs(cfg.fleetdir, self._slo_specs)
        else:
            self._slo_specs = slo.load_specs(cfg.fleetdir)
        self._scale_cfg = slo.ScaleConfig(
            target_drain_s=cfg.scale_target_drain_s,
            min_replicas=cfg.scale_min_replicas,
            max_replicas=cfg.scale_max_replicas)
        # campaign drivers this router has touched (POST /campaign
        # or a status read): the poll loop pulses the running ones so
        # a campaign created through the front door advances without
        # a dedicated presto-campaign process.  In-memory only — a
        # restarted router re-adopts a campaign on the next POST or
        # status read (idempotent), and an external driver can run
        # concurrently (the per-campaign lockdir serializes pulses).
        self._campaigns: Dict[str, object] = {}
        self._campaigns_lock = threading.Lock()  # presto-lint: guards(_campaigns)
        self._slo_lock = threading.Lock()  # presto-lint: guards(_slo_view, _alerting, _last_wanted)
        self._slo_view: Optional[dict] = None
        self._alerting: set = set()     # (tenant, window) pairs live
        self._last_wanted: Optional[int] = None
        reg = self.obs.metrics
        self._c_submissions = reg.counter(
            "fleet_submissions_total",
            "Jobs durably admitted to the fleet ledger", ("tenant",))
        self._c_dags = reg.counter(
            "dag_submitted_total",
            "Job graphs durably admitted to the ledger")
        self._c_shed = reg.counter(
            "fleet_shed_total",
            "Submissions shed at the high-water mark (429)")
        self._c_quota = reg.counter(
            "fleet_quota_rejections_total",
            "Submissions rejected by tenant quota (typed 429)",
            ("tenant",))
        self._g_depth = reg.gauge(
            "fleet_depth", "Fleet depth (pending + leased jobs)")
        self._g_ready = reg.gauge(
            "fleet_replicas_ready", "Replicas currently ready")
        self._c_agg = reg.counter(
            "fleet_obs_aggregations_total",
            "Fleet metric aggregation passes (snapshot merges)")
        self._g_budget = reg.gauge(
            "slo_error_budget_remaining",
            "Remaining error-budget fraction per tenant (1 = whole "
            "budget left, 0 = spent)", ("tenant",))
        self._g_burn = reg.gauge(
            "slo_burn_rate",
            "Fast-window burn rate per tenant and alert window "
            "(1 = spending exactly the budgeted rate)",
            ("tenant", "window"))
        self._c_burn_alerts = reg.counter(
            "slo_burn_alerts_total",
            "Multi-window burn-rate alerts fired (rising edges) per "
            "tenant", ("tenant",))
        self._g_wanted = reg.gauge(
            "slo_wanted_replicas",
            "Advisory wanted-replica count from the /scale signal "
            "(backlog device-seconds + SLO-debt pressure)")

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "FleetRouter":
        self._stop.clear()
        self._poll_t = threading.Thread(
            target=self._poll_loop, name="presto-router-poll",
            daemon=True)
        self._poll_t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_t is not None:
            self._poll_t.join(timeout=10.0)
        with self._campaigns_lock:
            drivers = list(self._campaigns.values())
            self._campaigns.clear()
        for drv in drivers:
            drv.close()
        self.events.close()
        self.obs.tracer.close()

    # ---- replica health -----------------------------------------------

    def _replica_addrs(self) -> Dict[str, Optional[str]]:
        state = self.ledger.read()
        return {host: h.get("addr")
                for host, h in sorted(state["hosts"].items())
                if h.get("alive", False)}

    @staticmethod
    def _get_readyz(addr: str, timeout: float = 2.0) \
            -> Optional[dict]:
        try:
            with urllib.request.urlopen(addr.rstrip("/") + "/readyz",
                                        timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:        # 503 still carries the readiness payload
                return json.loads(e.read())
            except Exception:
                return None
        except Exception:
            return None

    def poll_replicas(self) -> Dict[str, Optional[dict]]:
        """One health sweep: /readyz every registered live replica
        (None for unreachable ones) + the idempotent reap pass."""
        out: Dict[str, Optional[dict]] = {}
        for host, addr in self._replica_addrs().items():
            out[host] = self._get_readyz(addr) if addr else None
        with self._ready_lock:
            self._ready = out
        self._g_ready.set(sum(1 for r in out.values()
                              if r and r.get("ready")))
        self.ledger.reap(self.cfg.heartbeat_timeout)
        self._g_depth.set(self.ledger.depth())
        try:
            self._agg = fleetagg.aggregate(self.cfg.fleetdir)
            self._c_agg.inc()
        except Exception:
            self.obs.event("router-poll-error")
        try:
            self.evaluate_slo()
        except Exception:
            self.obs.event("router-poll-error")
        self._pulse_campaigns()
        return out

    def ready_replicas(self) -> List[str]:
        with self._ready_lock:
            return sorted(h for h, r in self._ready.items()
                          if r and r.get("ready"))

    def serving_replicas(self) -> List[str]:
        """Ready AND non-draining replicas — the capacity count the
        /scale advisory prices pressure against.  A draining replica
        still answers polls (it may be finishing in-flight work) but
        leases nothing new, so counting it toward capacity masks
        SLO-debt pressure exactly when the supervisor most needs the
        signal: mid-scale-down.  Both the readiness payload's own
        `draining` flag and the fleet lease state's are honored —
        an in-process replica drained directly (replica.drain())
        flips the lease state before the service flag."""
        with self._ready_lock:
            out = []
            for host, r in self._ready.items():
                if not (r and r.get("ready")):
                    continue
                if r.get("draining"):
                    continue
                if (r.get("lease") or {}).get("draining"):
                    continue
                out.append(host)
            return sorted(out)

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_replicas()
            except Exception:
                self.obs.event("router-poll-error")
            self._stop.wait(self.cfg.poll_s)

    # ---- admission ----------------------------------------------------

    @staticmethod
    def _bucket_hint(spec: dict) -> Optional[str]:
        """Best-effort plan-bucket hint recorded on the job row so
        `JobLedger.lease_batch` can hand a replica a whole same-bucket
        batch (the stacked executor's fleet feeder).  Failure — an
        unreadable header, an unknown config field — degrades to None
        (single-lease behavior), never to a rejected admission: the
        replica's own build_job still validates authoritatively."""
        try:
            from presto_tpu_torch.pipeline.survey import SurveyConfig
            from presto_tpu_torch.serve.plancache import bucket_key
            cfg = SurveyConfig(**dict(spec.get("config") or {}))
            return repr(bucket_key(list(spec["rawfiles"]), cfg))
        except Exception:
            return None

    # ---- admission control: Retry-After from fleet telemetry ----------

    @staticmethod
    def _trace_stamp(span) -> Optional[dict]:
        """The span's SpanContext as the wire dict stamped onto the
        admitted ledger row (None with observability disabled)."""
        ctx = span.context()
        return None if ctx is None else ctx.to_dict()

    def retry_after_estimate(self, depth: int):
        """(seconds, source): Retry-After quoted from the fleet-
        aggregated `job_e2e_seconds` drain estimate — mean device-
        execute seconds per job x backlog depth / ready replicas —
        when replica snapshots are available; the configured constant
        otherwise.  Never below the constant, capped at 600 s."""
        agg = self._agg
        if agg:
            roll = fleetagg.rollup(agg.get("merged") or {},
                                   "job_e2e_seconds", "phase")
            ph = roll.get("execute") or roll.get("total")
            if ph and ph.get("count"):
                mean = ph["sum"] / ph["count"]
                ready = max(1, len(self.ready_replicas()))
                est = depth * mean / ready
                return (max(self.cfg.retry_after_s,
                            min(est, 600.0)), "e2e-estimate")
        return self.cfg.retry_after_s, "constant"

    def _shed(self, tenant: str, depth: int,
              backlog_ds: Optional[float] = None) -> None:
        """429 + Retry-After at the high-water mark; the chosen value
        (and whether it came from the e2e estimate or the constant
        fallback) rides the `fleet_shed_total` event payload.
        ``backlog_ds`` names the priced backlog when the DEVICE-
        SECOND mark tripped (the cost-model shed path)."""
        retry_after_s, source = self.retry_after_estimate(depth)
        self._c_shed.inc()
        fields = dict(tenant=tenant, depth=depth,
                      high_water=self.cfg.high_water,
                      retry_after_s=round(retry_after_s, 3),
                      retry_after_source=source)
        if backlog_ds is not None:
            fields["backlog_device_seconds"] = round(backlog_ds, 3)
            fields["high_water_ds"] = self.cfg.high_water_ds
        self.events.emit("shed", **fields)
        raise FleetBusy(depth, self.cfg.high_water, retry_after_s)

    def _check_water(self, tenant: str, depth: int) -> None:
        """Both shed marks: job count (the backstop) and expected
        device-seconds (the priced gate — a backlog of few huge jobs
        sheds exactly like one of many tiny jobs)."""
        if depth >= self.cfg.high_water:
            self._shed(tenant, depth)
        if self.cfg.high_water_ds > 0.0:
            backlog_ds = self.ledger.backlog_device_seconds()
            if backlog_ds >= self.cfg.high_water_ds:
                self._shed(tenant, depth, backlog_ds)

    def submit(self, spec: dict) -> dict:
        """Durably admit one job.  Raises FleetBusy (shed),
        TenantQuotaExceeded (typed), NoReadyReplica (503).  The
        admission span's context is stamped onto the ledger row, so
        the leasing replica resumes THIS trace."""
        if not isinstance(spec, dict):
            raise ValueError("spec must be a JSON object")
        tenant = str(spec.get("tenant") or DEFAULT_TENANT)
        span = self.obs.span("fleet:submit", tenant=tenant)
        try:
            depth = self.ledger.depth()
            self._g_depth.set(depth)
            self._check_water(tenant, depth)
            if self.cfg.require_ready and not self.ready_replicas():
                raise NoReadyReplica(
                    "no ready replica registered in %s"
                    % self.cfg.fleetdir)
            try:
                view = self.ledger.admit(
                    spec, tenant=tenant,
                    job_id=spec.get("job_id"),
                    priority=int(spec.get("priority", 10)),
                    bucket=self._bucket_hint(spec),
                    trace=self._trace_stamp(span))
            except TenantQuotaExceeded as e:
                self._c_quota.labels(tenant=tenant).inc()
                self.events.emit("quota-exceeded", tenant=tenant,
                                 quota=e.quota, active=e.active)
                raise
        except Exception as e:
            span.finish("error: %s" % type(e).__name__)
            raise
        span.set_attr("job", view["job_id"])
        span.finish()
        self._c_submissions.labels(tenant=tenant).inc()
        self.events.emit("enqueue", job=view["job_id"],
                         tenant=tenant, depth=depth + 1)
        return view

    def submit_dag(self, spec: dict) -> dict:
        """Durably admit one discovery DAG (search -> sift ->
        fold-fan-out -> timing) as a single ledger transaction
        (serve/dag.plan_dag + JobLedger.admit_dag).  Shedding, the
        ready-replica gate, and tenant quotas apply exactly as for
        single submissions — the quota counts the whole graph."""
        if not isinstance(spec, dict):
            raise ValueError("spec must be a JSON object")
        from presto_tpu_torch.serve.dag import plan_dag
        tenant = str(spec.get("tenant") or DEFAULT_TENANT)
        span = self.obs.span("fleet:dag-submit", tenant=tenant)
        try:
            depth = self.ledger.depth()
            self._g_depth.set(depth)
            self._check_water(tenant, depth)
            if self.cfg.require_ready and not self.ready_replicas():
                raise NoReadyReplica(
                    "no ready replica registered in %s"
                    % self.cfg.fleetdir)
            nodes = plan_dag(spec)
            try:
                # one trace for the whole graph: every node row
                # carries this span's context, and the sift's fenced
                # expand re-parents its fan-out under the sift span
                out = self.ledger.admit_dag(
                    nodes, tenant=tenant,
                    priority=int(spec.get("priority", 10)),
                    dag_id=spec.get("dag_id"),
                    trace=self._trace_stamp(span))
            except TenantQuotaExceeded as e:
                self._c_quota.labels(tenant=tenant).inc()
                self.events.emit("quota-exceeded", tenant=tenant,
                                 quota=e.quota, active=e.active)
                raise
        except Exception as e:
            span.finish("error: %s" % type(e).__name__)
            raise
        span.set_attr("dag", out["dag_id"])
        span.finish()
        self._c_submissions.labels(tenant=tenant).inc(len(nodes))
        self._c_dags.inc()
        self.events.emit("dag-submit", dag=out["dag_id"],
                         tenant=tenant, nodes=len(nodes))
        return dict(out, tenant=tenant)

    def dag_status(self, dag_id: str) -> Optional[dict]:
        return self.ledger.dag_view(dag_id)

    # ---- campaign engine ----------------------------------------------

    def _campaign_driver(self, campaign_id: str,
                         cfg_kw: Optional[dict] = None):
        """The cached per-campaign driver (created on first touch).
        Sharing the router's obs handle and job ledger means
        campaign telemetry rides the router's /metrics and span
        stream; sharing the ledger's stat-cache keeps status reads
        cheap."""
        from presto_tpu_torch.serve.campaign import (CampaignConfig,
                                                     CampaignDriver,
                                                     _safe_id)
        cid = _safe_id(str(campaign_id))
        with self._campaigns_lock:
            drv = self._campaigns.get(cid)
            if drv is None:
                ccfg = CampaignConfig(fleetdir=self.cfg.fleetdir,
                                      campaign_id=cid,
                                      **dict(cfg_kw or {}))
                drv = CampaignDriver(ccfg, obs=self.obs,
                                     ledger=self.ledger)
                self._campaigns[cid] = drv
            return drv

    def submit_campaign(self, spec: dict) -> dict:
        """Durably create (or idempotently resume) a campaign from
        `{"id", "manifest", ...}` and run its first pulse — the
        manifest lands in `<fleet>/campaigns/<id>/campaign.json` and
        the first wave of discovery DAGs is admitted before the 202
        returns.  No shed/ready gate on purpose: the campaign ledger
        bounds outstanding work to wave_size DAGs, so an archive of
        any size never floods jobs.json the way a /submit firehose
        could."""
        if not isinstance(spec, dict):
            raise ValueError("spec must be a JSON object")
        manifest = spec.get("manifest")
        if not isinstance(manifest, list) or not manifest:
            raise ValueError(
                "manifest must be a non-empty list of observation "
                "specs (each the POST /dag wire schema)")
        kw = {}
        for key, cast in (("wave_size", int), ("tenant", str),
                          ("weight", float), ("priority", int),
                          ("yield_floor", float)):
            if spec.get(key) is not None:
                kw[key] = cast(spec[key])
        drv = self._campaign_driver(spec.get("id") or "campaign", kw)
        drv.create(manifest)
        return drv.pulse()

    def campaign_view(self, campaign_id: str) -> Optional[dict]:
        """`GET /campaign/<id>`: status + live ETA/cost projection
        (None for an unknown id — checked BEFORE a driver is built,
        so probing never creates an empty campaign directory).
        Reading a campaign adopts it into the poll loop's pulse set:
        a restarted router resumes driving a campaign the moment
        anyone asks about it."""
        from presto_tpu_torch.serve.campaign import load_campaign
        if load_campaign(self.cfg.fleetdir, campaign_id) is None:
            return None
        return self._campaign_driver(campaign_id).status()

    def campaigns_view(self) -> dict:
        """`GET /campaign`: every campaign under the fleet with its
        state and per-state observation counts (ledger reads only —
        no drivers are built or adopted)."""
        from presto_tpu_torch.serve.campaign import (CampaignDriver,
                                                     list_campaigns,
                                                     load_campaign)
        out = {}
        for cid in list_campaigns(self.cfg.fleetdir):
            doc = load_campaign(self.cfg.fleetdir, cid)
            if doc is None:
                continue
            out[cid] = {"state": doc.get("state"),
                        "observations": len(doc["observations"]),
                        "waves": int(doc.get("waves", 0)),
                        "counts": CampaignDriver._counts(doc)}
        return {"campaigns": out}

    def _pulse_campaigns(self) -> None:
        """One poll-loop pass over the adopted campaigns: pulse every
        one still running (settle landed DAGs, admit the next wave,
        refresh the backfill yield).  Terminal campaigns stay in the
        cache for cheap status reads but are not pulsed."""
        from presto_tpu_torch.serve.campaign import load_campaign
        with self._campaigns_lock:
            drivers = list(self._campaigns.values())
        for drv in drivers:
            try:
                doc = load_campaign(self.cfg.fleetdir,
                                    drv.cfg.campaign_id)
                if doc is None or doc.get("state") != "running":
                    continue
                drv.pulse()
            except Exception:
                self.obs.event("router-poll-error")

    # ---- introspection ------------------------------------------------

    def status(self, job_id: str) -> Optional[dict]:
        return self.ledger.view(job_id)

    def result(self, job_id: str) -> Optional[dict]:
        view = self.ledger.view(job_id)
        if view is None:
            return None
        if view["state"] == "done":
            path = os.path.join(self.cfg.fleetdir, "jobs", job_id,
                                "result.json")
            try:
                with open(path) as f:
                    view["result_detail"] = json.load(f)
            except (OSError, ValueError):
                view["result_detail"] = None
        return view

    def wait(self, job_ids, timeout: float = 300.0,
             poll: float = 0.1) -> bool:
        """Block until every listed job is ledger-terminal."""
        if isinstance(job_ids, str):
            job_ids = [job_ids]
        deadline = time.time() + timeout
        while time.time() < deadline:
            views = [self.ledger.view(j) for j in job_ids]
            if all(v is not None and v["state"] in ("done", "failed")
                   for v in views):
                return True
            time.sleep(poll)
        return False

    def fleet_view(self) -> dict:
        with self._ready_lock:
            ready = dict(self._ready)
        counts = self.ledger.counts()
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "fleetdir": self.cfg.fleetdir,
            "epoch": self.ledger.epoch,
            "depth": self.ledger.depth(),
            "high_water": self.cfg.high_water,
            "jobs": counts,
            "tenants": {
                "config": self.ledger.tenants(),
                "jobs": self.ledger.tenant_counts(),
            },
            "replicas": {
                host: {"addr": addr,
                       "ready": bool(ready.get(host)
                                     and ready[host].get("ready")),
                       "readyz": ready.get(host)}
                for host, addr in self._replica_addrs().items()
            },
        }

    def metrics(self) -> dict:
        return {
            "uptime_s": round(time.time() - self._t0, 3),
            "depth": self.ledger.depth(),
            "high_water": self.cfg.high_water,
            "ready_replicas": len(self.ready_replicas()),
            "shed": int(self._c_shed.value),
            "quota_rejections": int(self._c_quota.total()),
            "submissions": int(self._c_submissions.total()),
            "jobs": self.ledger.counts(),
            "events": self.events.counts(),
        }

    # ---- fleet-wide metric aggregation --------------------------------

    def _aggregate(self) -> dict:
        """A fresh snapshot merge (request path; the poll loop keeps
        `self._agg` warm for Retry-After quoting between requests)."""
        agg = fleetagg.aggregate(self.cfg.fleetdir)
        self._agg = agg
        self._c_agg.inc()
        return agg

    def fleet_metrics(self) -> dict:
        """The `GET /fleet/metrics` JSON body: per-replica snapshot
        freshness, the merged registry (counters summed, gauges
        per-replica, histogram percentiles over the merged sample
        windows), and the per-phase `job_e2e_seconds` rollup the
        control-plane consumers read."""
        agg = self._aggregate()
        merged = agg["merged"]
        return {
            "fleetdir": self.cfg.fleetdir,
            "depth": self.ledger.depth(),
            "jobs": self.ledger.counts(),
            "replicas": agg["replicas"],
            # stale = merged anyway but out of date (older than 3x
            # its publish interval): the fleet view is partial
            "stale_replicas": agg.get("stale_replicas", []),
            "job_e2e": fleetagg.rollup(merged, "job_e2e_seconds",
                                       "phase"),
            "latency": fleetagg.rollup(merged, "latency_seconds",
                                       "name"),
            "metrics": fleetagg.to_json(merged),
        }

    def fleet_metrics_prometheus(self) -> str:
        """Prometheus text exposition of the merged fleet registry
        (the `Accept: text/plain` / `?format=prometheus` answer of
        `GET /fleet/metrics`)."""
        return fleetagg.render_prometheus(
            self._aggregate()["merged"])

    # ---- SLO observatory ----------------------------------------------

    def _backlog_buckets(self,
                         state: Optional[dict] = None) -> List:
        """One bucket hint per active (pending + leased) ledger job
        — what the /scale advisory prices in device-seconds."""
        state = state or self.ledger.read()
        return [row.get("bucket")
                for row in state.get("jobs", {}).values()
                if row.get("state") in ("pending", "leased")]

    def evaluate_slo(self, now: Optional[float] = None) -> dict:
        """One SLO observatory pass over the durable usage ledger:
        per-tenant budget/burn evaluation, gauge updates, rising-edge
        `slo-burn-alert` events, and the /scale advisory (gauge +
        `slo-scale-advice` event on every change, so a supervisor
        replays decisions from telemetry alone).  Runs in the poll
        loop and on demand from the /slo, /usage, /scale endpoints.
        """
        now = time.time() if now is None else now
        with self.obs.span("slo:evaluate") as span:
            rows = self.ledger.usage.rows()
            evals = {spec.tenant: slo.evaluate(spec, rows, now)
                     for spec in self._slo_specs}
            # backfill actuation: while any interactive tenant burns
            # error budget, shrink the campaign lane's live weight —
            # update_backfill_yield excludes the declared backfill
            # tenants from the burn census, writes <fleet>/
            # backfill.json atomically, and the lease policy's
            # stat-cache picks it up on the next lease (None when no
            # backfill lane is declared)
            backfill_yield = slo.update_backfill_yield(
                self.cfg.fleetdir, evals)
            alerts = []
            for tenant, ev in sorted(evals.items()):
                self._g_budget.labels(tenant=tenant).set(
                    ev["budget_remaining"])
                for w in ev["windows"]:
                    self._g_burn.labels(
                        tenant=tenant, window=w["window"]).set(
                            w["fast_burn"])
                    if w["alerting"]:
                        alerts.append((tenant, w["window"], w))
            # capacity clamps to ready NON-DRAINING replicas: a
            # draining one is leaving and must not mask pressure;
            # running campaigns' projected remaining-archive
            # device-seconds ride along so the advisory prices the
            # whole archive, not just the admitted wave
            campaign_s = campaign.fleet_remaining_device_seconds(
                self.cfg.fleetdir, rows, now=now)
            advice = slo.scale_advice(
                self._backlog_buckets(), rows, evals,
                len(self.serving_replicas()),
                cfg=self._scale_cfg, now=now,
                campaign_remaining_s=campaign_s)
            wanted = advice["wanted_replicas"]
            span.set_attr("tenants", len(evals))
            span.set_attr("wanted_replicas", wanted)
        live = {(t, w) for t, w, _ in alerts}
        with self._slo_lock:
            rising = [(t, w, ev) for t, w, ev in alerts
                      if (t, w) not in self._alerting]
            self._alerting = live
            previous = self._last_wanted
            changed = wanted != previous
            self._last_wanted = wanted
            view = {
                "ts": now,
                "specs": [s.to_dict() for s in self._slo_specs],
                "tenants": evals,
                "usage": slo.usage_rollup(rows),
                "scale": advice,
                "backfill_yield": backfill_yield,
            }
            self._slo_view = view
        for tenant, window, w in rising:
            self._c_burn_alerts.labels(tenant=tenant).inc()
            self.events.emit("slo-burn-alert", tenant=tenant,
                             window=window,
                             fast_burn=w["fast_burn"],
                             slow_burn=w["slow_burn"],
                             threshold=w["threshold"])
        self._g_wanted.set(wanted)
        if changed:
            self.events.emit("slo-scale-advice", wanted=wanted,
                             previous=previous,
                             reason=advice["reason"],
                             **advice["inputs"])
        return view

    def slo_view(self) -> dict:
        """The `GET /slo` body: per-tenant budget, burn, and alert
        state (freshly evaluated)."""
        view = self.evaluate_slo()
        return {"ts": view["ts"], "specs": view["specs"],
                "tenants": view["tenants"]}

    def usage_view(self) -> dict:
        """The `GET /usage` body: the device-seconds rollup."""
        view = self.evaluate_slo()
        return dict(view["usage"], ts=view["ts"])

    def scale_view(self) -> dict:
        """The `GET /scale` body: the advisory wanted-replica signal
        and its inputs."""
        view = self.evaluate_slo()
        return dict(view["scale"], ts=view["ts"])


# ----------------------------------------------------------------------
# HTTP front end
# ----------------------------------------------------------------------

class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def router(self) -> FleetRouter:
        return self.server.router      # type: ignore[attr-defined]

    def log_message(self, fmt, *args):
        self.router.events.emit("http", line=fmt % args)

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, sort_keys=True).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _prometheus(self, text: str) -> None:
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/healthz":
                self._json(200, {"ok": True, "role": "router"})
            elif url.path == "/fleet":
                self._json(200, self.router.fleet_view())
            elif url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [""])[0]
                accept = self.headers.get("Accept", "") or ""
                if fmt in ("prometheus", "text") \
                        or "text/plain" in accept:
                    self._prometheus(
                        self.router.obs.metrics.render_prometheus())
                else:
                    self._json(200, self.router.metrics())
            elif url.path == "/fleet/metrics":
                # fleet-wide aggregation over the replicas' atomic
                # snapshots: same content negotiation as /metrics
                fmt = parse_qs(url.query).get("format", [""])[0]
                accept = self.headers.get("Accept", "") or ""
                if fmt in ("prometheus", "text") \
                        or "text/plain" in accept:
                    self._prometheus(
                        self.router.fleet_metrics_prometheus())
                else:
                    self._json(200, self.router.fleet_metrics())
            elif url.path == "/slo":
                self._json(200, self.router.slo_view())
            elif url.path == "/usage":
                self._json(200, self.router.usage_view())
            elif url.path == "/scale":
                self._json(200, self.router.scale_view())
            elif url.path == "/events":
                n = int(parse_qs(url.query).get("n", ["100"])[0])
                self._json(200,
                           {"events": self.router.events.tail(n)})
            elif url.path == "/campaign":
                self._json(200, self.router.campaigns_view())
            elif len(parts) == 2 and parts[0] == "campaign":
                view = self.router.campaign_view(parts[1])
                if view is None:
                    self._json(404, {"error": "no such campaign"})
                else:
                    self._json(200, view)
            elif len(parts) == 2 and parts[0] == "dag":
                view = self.router.dag_status(parts[1])
                if view is None:
                    self._json(404, {"error": "no such dag"})
                else:
                    self._json(200, view)
            elif len(parts) == 2 and parts[0] == "jobs":
                view = self.router.status(parts[1])
                if view is None:
                    self._json(404, {"error": "no such job"})
                else:
                    self._json(200, view)
            elif (len(parts) == 3 and parts[0] == "jobs"
                  and parts[2] == "result"):
                view = self.router.result(parts[1])
                if view is None:
                    self._json(404, {"error": "no such job"})
                elif view["state"] not in ("done", "failed"):
                    self._json(409, {"error": "job not finished",
                                     "state": view["state"]})
                else:
                    self._json(200, view)
            else:
                self._json(404, {"error": "unknown endpoint"})
        except Exception as e:
            self._json(500, {"error": "%s: %s"
                             % (type(e).__name__, e)})

    def do_POST(self) -> None:
        path = urlparse(self.path).path
        if path not in ("/submit", "/dag", "/campaign"):
            self._json(404, {"error": "unknown endpoint"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            spec = json.loads(self.rfile.read(length) or b"{}")
            if path == "/campaign":
                self._json(202, self.router.submit_campaign(spec))
            elif path == "/dag":
                self._json(202, self.router.submit_dag(spec))
            else:
                self._json(202, self.router.submit(spec))
        except FleetBusy as e:
            # ceil, not int(): truncation under-quotes the drain
            # estimate (2.9s -> "2" tells clients to come back early)
            self._json(429, {"error": "shed", "detail": str(e),
                             "retry_after_s": e.retry_after_s},
                       headers={"Retry-After":
                                "%d" % max(1, math.ceil(
                                    e.retry_after_s))})
        except TenantQuotaExceeded as e:
            self._json(429, {"error": "quota-exceeded",
                             "tenant": e.tenant, "quota": e.quota,
                             "active": e.active,
                             "unit": getattr(e, "unit", "jobs")},
                       headers={"Retry-After": "1"})
        except NoReadyReplica as e:
            self._json(503, {"error": "no-ready-replica",
                             "detail": str(e)})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:
            self._json(500, {"error": "%s: %s"
                             % (type(e).__name__, e)})


class RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, router: FleetRouter):
        super().__init__(addr, _RouterHandler)
        self.router = router


def start_http(router: FleetRouter, host: str = "127.0.0.1",
               port: int = 0) -> RouterHTTPServer:
    httpd = RouterHTTPServer((host, port), router)
    t = threading.Thread(target=httpd.serve_forever,
                         name="presto-router-http", daemon=True)
    t.start()
    return httpd


# ----------------------------------------------------------------------
# CLI: presto-router
# ----------------------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(prog="presto-router")
    p.add_argument("-host", type=str, default="127.0.0.1")
    p.add_argument("-port", type=int, default=8786)
    p.add_argument("-fleetdir", type=str, required=True,
                   help="Shared fleet directory (the job ledger)")
    p.add_argument("-high-water", type=int, default=256,
                   help="Shed submissions (429 + Retry-After) once "
                        "pending+leased jobs reach this depth")
    p.add_argument("-high-water-ds", type=float, default=0.0,
                   help="Shed once the backlog's EXPECTED DEVICE-"
                        "SECONDS (per-bucket execute cost model, "
                        "fleet-median fallback) reach this; 0 "
                        "disables the priced gate")
    p.add_argument("-retry-after", type=float, default=2.0)
    p.add_argument("-hb-timeout", type=float, default=10.0,
                   help="Replica heartbeat TTL for the reap pass")
    p.add_argument("-poll", type=float, default=2.0,
                   help="Replica /readyz poll cadence, seconds")
    p.add_argument("-tenant", action="append", default=[],
                   metavar="NAME:WEIGHT[:QUOTA[:DS_QUOTA]]",
                   help="Tenant WRR weight, optional active-job "
                        "quota, and optional expected-device-second "
                        "quota over active work (repeatable; an "
                        "empty field skips it: gold:4::120)")
    p.add_argument("-slo", action="append", default=[],
                   metavar="TENANT:OBJECTIVE[:LATENCY_S]",
                   help="Per-tenant SLO spec (repeatable): "
                        "availability objective in (0,1) plus an "
                        "optional per-job e2e latency objective; "
                        "persisted to <fleet>/slo.json and "
                        "evaluated at /slo with multi-window burn-"
                        "rate alerts")
    p.add_argument("-slo-windows", type=str, default="",
                   metavar="FAST:SLOW:THRESHOLD[,...]",
                   help="Burn-alert window pairs in seconds "
                        "(default: the 300:3600:14.4 and "
                        "1800:21600:6 SRE pairs)")
    p.add_argument("-scale-drain", type=float, default=30.0,
                   help="/scale advisory: target seconds to drain "
                        "the backlog")
    p.add_argument("-scale-min", type=int, default=1)
    p.add_argument("-scale-max", type=int, default=16)
    p.add_argument("-allow-empty", action="store_true",
                   help="Admit submissions even with no ready "
                        "replica (they queue in the ledger)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = RouterConfig(fleetdir=args.fleetdir,
                       high_water=args.high_water,
                       high_water_ds=args.high_water_ds,
                       retry_after_s=args.retry_after,
                       heartbeat_timeout=args.hb_timeout,
                       poll_s=args.poll,
                       require_ready=not args.allow_empty,
                       tenants=args.tenant,
                       slo=args.slo,
                       slo_windows=args.slo_windows,
                       scale_target_drain_s=args.scale_drain,
                       scale_min_replicas=args.scale_min,
                       scale_max_replicas=args.scale_max)
    router = FleetRouter(cfg).start()
    httpd = start_http(router, args.host, args.port)
    host, port = httpd.server_address[:2]
    print("presto-router: fleet %s on http://%s:%d "
          "(POST /submit, /dag, /campaign; GET /jobs/<id>, /fleet, "
          "/metrics, /slo, /usage, /scale, /campaign/<id>)"
          % (args.fleetdir, host, port))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("presto-router: shutting down")
    finally:
        httpd.shutdown()
        router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
