"""Campaign engine: archive-scale reprocessing as ONE durable unit.

Host copy of ``presto_tpu/serve/campaign.py`` for the PyTorch port
(the same campaign ledgers as the JAX package).

The serving tier can execute a discovery DAG exactly-once under
replica churn, but the survey-archive workload — tens of
thousands of observations x search -> sift -> fold -> timing — had to
be hand-driven as a job firehose nobody could pause, resume, price,
or survive a bad night with.  This module is the tier above the job
ledger that closes that gap: a **campaign** is a manifest of
observations admitted as discovery DAGs in bounded **waves**, with
its own durable ledger, so the fleet processes an archive of any
size with `jobs.json` bounded and a crashed driver resuming from
disk alone.

Ledger (`<fleet>/campaigns/<id>/campaign.json`, atomic +
schema-versioned exactly like supervisor.json): one row per
observation with states

    pending -> admitting -> admitted -> done | failed

**Crash-only wave protocol** (the admit-mark-then-admit_dag dance):

  * the driver durably marks an observation ``admitting`` — with its
    *deterministic* dag id ``<campaign>.<obs>`` — BEFORE calling
    `JobLedger.admit_dag(dag_id=...)`;
  * on restart, an ``admitting`` row whose dag the job ledger does
    not know is simply re-admitted; one whose dag exists is marked
    ``admitted`` — and because `admit_dag` is all-or-nothing and
    raises ``duplicate job_id`` on any replay, a zombie driver's
    second admit can never create a second DAG (the duplicate error
    IS the idempotence signal: "the prior admit landed");
  * completion counting is **fence-checked by construction**: an
    observation settles only from `dag_view`'s terminal state, and a
    DAG node's state only ever becomes ``done`` through the job
    ledger's epoch fence — so a zombie replica (or driver) can never
    double-count.  Settling is idempotent: a terminal row is never
    rewritten.

**Backfill lane**: campaign traffic runs as a low-weight
deficit-WRR tenant (`JobLedger.set_tenant`) declared in
`<fleet>/backfill.json`; every pulse recomputes the live yield
factor from the interactive tenants' burn rates
(`obs/slo.update_backfill_yield`) so the campaign thins out exactly
when a gold tenant is burning error budget — and the supervisor's
``preempt_fraction`` mode (serve/supervisor.py) kills and replaces
campaign-leased replicas at a paced rate, making spot-like
preemption a continuously exercised steady state riding the proven
lease/epoch-fence/re-admit path.

**ETA + cost projection** (`project`): measured device-seconds of
settled observations (usage.jsonl, grouped by dag id) give a
per-observation cost that prices the remaining census; throughput
over the campaign's own elapsed time gives the ETA.  Both converge
to the measured totals as the campaign drains.

Every decision (wave-admit, yield, resume, settle, complete) lands
on a durable per-campaign `campaign_events.jsonl` plus `campaign:*`
spans and `campaign_*` metrics (the JAX package's vocabulary).
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from presto_tpu_torch.io.atomic import atomic_write_text
from presto_tpu_torch.pipeline.leaseledger import _LockDir
from presto_tpu_torch.serve.events import EventLog
from presto_tpu_torch.serve.jobledger import JobLedger, JobLedgerError

CAMPAIGNS_DIR = "campaigns"
LEDGER_NAME = "campaign.json"
EVENTS_NAME = "campaign_events.jsonl"

CAMPAIGN_VERSION = 1

#: observation states in the campaign ledger
OBS_PENDING = "pending"
OBS_ADMITTING = "admitting"   # durably marked; admit_dag may have landed
OBS_ADMITTED = "admitted"     # the DAG exists in jobs.json
OBS_DONE = "done"
OBS_FAILED = "failed"

TERMINAL = (OBS_DONE, OBS_FAILED)

#: smoothing factor for the settle-throughput EWMAs (rate and
#: latency) that size waves — recent pulses dominate, but one noisy
#: settle burst cannot swing the budget by itself
EWMA_ALPHA = 0.3

_ID_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _safe_id(text: str) -> str:
    return _ID_RE.sub("-", str(text)).strip("-") or "campaign"


def campaigns_root(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), CAMPAIGNS_DIR)


def campaign_dir(fleetdir: str, campaign_id: str) -> str:
    return os.path.join(campaigns_root(fleetdir), _safe_id(campaign_id))


def ledger_path(fleetdir: str, campaign_id: str) -> str:
    return os.path.join(campaign_dir(fleetdir, campaign_id),
                        LEDGER_NAME)


def events_path(fleetdir: str, campaign_id: str) -> str:
    return os.path.join(campaign_dir(fleetdir, campaign_id),
                        EVENTS_NAME)


def list_campaigns(fleetdir: str) -> List[str]:
    """Campaign ids with a readable ledger under this fleet."""
    root = campaigns_root(fleetdir)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    return [n for n in names
            if os.path.exists(os.path.join(root, n, LEDGER_NAME))]


def load_campaign(fleetdir: str, campaign_id: str) -> Optional[dict]:
    """The persisted campaign ledger (None when absent, unreadable,
    or a foreign schema version — a reader never fails)."""
    try:
        with open(ledger_path(fleetdir, campaign_id)) as f:
            doc = json.load(f)
        if int(doc.get("version", -1)) != CAMPAIGN_VERSION:
            return None
        doc.setdefault("observations", {})
        return doc
    except (OSError, ValueError):
        return None


def fleet_remaining_device_seconds(fleetdir: str,
                                   usage_rows,
                                   now: Optional[float] = None
                                   ) -> float:
    """Every running campaign's projected remaining-archive
    device-seconds, summed — the term the `/scale` advisory folds
    into its backlog so a supervisor sees the whole archive, not just
    the currently-admitted wave (`CampaignDriver.project` is the
    per-campaign version; this is the fleet fold of the same math).

    Pure read: campaign ledgers + the usage rows the caller already
    holds.  A campaign with no settled observation yet is un-priced
    and contributes 0.0 (the admitted wave is still visible to the
    count-based backlog, so nothing is hidden — the projection just
    has no cost model until the first settle lands)."""
    total = 0.0
    for campaign_id in list_campaigns(fleetdir):
        doc = load_campaign(fleetdir, campaign_id)
        if doc is None or doc.get("state") != "running":
            continue
        dags = {str(r.get("dag_id") or ""): obs_id
                for obs_id, r in doc["observations"].items()}
        ds_by_obs: Dict[str, float] = {}
        for urow in usage_rows:
            obs_id = dags.get(str(urow.get("dag") or ""))
            if obs_id is None:
                continue
            ex = float((urow.get("phases") or {}).get("execute")
                       or 0.0)
            ds_by_obs[obs_id] = ds_by_obs.get(obs_id, 0.0) + ex
        settled = [o for o, r in doc["observations"].items()
                   if r["state"] in TERMINAL]
        if not settled:
            continue
        remaining = len(doc["observations"]) - len(settled)
        mean_obs = (sum(ds_by_obs.get(o, 0.0) for o in settled)
                    / len(settled))
        total += mean_obs * remaining
    return total


@dataclass
class CampaignConfig:
    """Knobs of one campaign (persisted into the ledger at create so
    a resumed driver needs nothing but the fleet dir + id)."""
    fleetdir: str
    campaign_id: str
    wave_size: int = 4            # outstanding-DAG ceiling; measured
                                  # settle throughput sizes waves
                                  # below it (see _wave_budget)
    tenant: str = "campaign"      # the backfill lane's tenant name
    weight: float = 0.1           # configured WRR weight (low: backfill)
    priority: int = 50            # worse than interactive default 10
    yield_floor: float = 0.05     # lowest live weight fraction


class SimulatedCrash(BaseException):
    """Injected driver death (BaseException so no handler in the
    driver can accidentally swallow it — mirrors the chaos tests'
    crash model elsewhere in the tree)."""


class CampaignDriver:
    """The campaign control loop over one fleet directory.

    Crash-only: every mutation is load -> mutate -> atomic save under
    a lockdir, every step is idempotent, and `resume()` rebuilds all
    driver state from the ledger alone — killing the driver at ANY
    instant and restarting it loses nothing and duplicates nothing.
    """

    def __init__(self, cfg: CampaignConfig, obs=None,
                 ledger: Optional[JobLedger] = None):
        from presto_tpu_torch.obs import Observability, ObsConfig
        self.cfg = cfg
        self.cfg.campaign_id = _safe_id(cfg.campaign_id)
        self.obs = obs or Observability(
            ObsConfig(enabled=True, service="presto-campaign"))
        self.ledger = ledger or JobLedger(cfg.fleetdir, obs=self.obs)
        self.cdir = campaign_dir(cfg.fleetdir, cfg.campaign_id)
        os.makedirs(self.cdir, exist_ok=True)
        self.events = EventLog(
            path=events_path(cfg.fleetdir, cfg.campaign_id))
        self._lock = _LockDir(os.path.join(self.cdir, ".lock"),
                              timeout=10.0)
        reg = self.obs.metrics
        self._c_waves = reg.counter(
            "campaign_waves_total",
            "Admission waves the campaign driver opened")
        self._c_admitted = reg.counter(
            "campaign_admitted_total",
            "Observations durably admitted as discovery DAGs")
        self._c_settled = reg.counter(
            "campaign_settled_total",
            "Observations settled terminal, by outcome",
            ("state",))
        self._g_outstanding = reg.gauge(
            "campaign_outstanding",
            "Discovery DAGs currently outstanding (admitted, not "
            "yet terminal) — bounded by wave_size at any archive "
            "size")
        self._g_yield = reg.gauge(
            "campaign_yield_factor",
            "Live backfill yield factor (1.0 = full configured "
            "weight; shrinks while interactive tenants burn error "
            "budget)")

    # ---- chaos seam ---------------------------------------------------

    def _seam(self, point: str) -> None:
        """Crash-injection seam (no-op in production; the atomicity
        tests override this to raise SimulatedCrash at wave-admit /
        mid-wave / pre-count-commit)."""

    # ---- ledger persistence -------------------------------------------

    def _load(self) -> dict:  # presto-lint: holds(_lock)
        doc = load_campaign(self.cfg.fleetdir, self.cfg.campaign_id)
        if doc is None:
            raise JobLedgerError(
                "campaign %r has no ledger under %s (create it "
                "first)" % (self.cfg.campaign_id, self.cdir))
        return doc

    def _save(self, doc: dict) -> None:  # presto-lint: holds(_lock)
        atomic_write_text(
            ledger_path(self.cfg.fleetdir, self.cfg.campaign_id),
            json.dumps(doc, indent=1, sort_keys=True) + "\n")

    # ---- creation -----------------------------------------------------

    def create(self, manifest: List[dict],
               now: Optional[float] = None) -> dict:
        """Durably create the campaign from a manifest of observation
        specs (each the POST /dag wire schema: rawfiles + config +
        sift/fold/toa policies, validated through `dag.plan_dag`
        before anything persists).  Registers the backfill tenant
        (low WRR weight + the `backfill.json` declaration the lease
        policy yields through).  Idempotent: re-creating an existing
        campaign returns its ledger untouched — the resume path."""
        from presto_tpu_torch.obs import slo
        from presto_tpu_torch.serve.dag import plan_dag
        now = time.time() if now is None else now
        with self._lock():
            doc = load_campaign(self.cfg.fleetdir,
                                self.cfg.campaign_id)
            if doc is not None:
                return doc
            observations: Dict[str, dict] = {}
            for i, spec in enumerate(manifest):
                spec = dict(spec)
                obs_id = _safe_id(spec.pop("id", None)
                                  or "obs-%06d" % (i + 1))
                if obs_id in observations:
                    raise JobLedgerError(
                        "duplicate observation id %r in manifest"
                        % obs_id)
                plan_dag(spec)          # validate early, fail loudly
                observations[obs_id] = {
                    "spec": spec,
                    "state": OBS_PENDING,
                    "dag_id": "%s.%s" % (self.cfg.campaign_id,
                                         obs_id),
                }
            doc = {
                "version": CAMPAIGN_VERSION,
                "campaign_id": self.cfg.campaign_id,
                "created": now,
                "state": "running",
                "tenant": self.cfg.tenant,
                "priority": int(self.cfg.priority),
                "wave_size": max(int(self.cfg.wave_size), 1),
                "weight": float(self.cfg.weight),
                "yield_floor": float(self.cfg.yield_floor),
                "waves": 0,
                "last_yield": 1.0,
                "observations": observations,
            }
            with self.obs.span("campaign:create",
                               campaign=self.cfg.campaign_id) as span:
                span.set_attr("observations", len(observations))
                self.ledger.set_tenant(self.cfg.tenant,
                                       weight=self.cfg.weight)
                slo.save_backfill(self.cfg.fleetdir,
                                  [self.cfg.tenant],
                                  floor=self.cfg.yield_floor)
                self._save(doc)
        self.events.emit("campaign-create",
                         campaign=self.cfg.campaign_id,
                         observations=len(doc["observations"]),
                         wave_size=doc["wave_size"],
                         tenant=self.cfg.tenant,
                         weight=self.cfg.weight)
        self.obs.event("campaign-create",
                       campaign=self.cfg.campaign_id)
        return doc

    def resume(self, now: Optional[float] = None) -> dict:
        """Announce a driver (re)start over an existing ledger; all
        actual recovery happens inside the next `pulse` (re-admitting
        marked-but-unknown DAGs, settling landed ones) — restart IS
        the normal path, not a special case."""
        now = time.time() if now is None else now
        with self._lock():
            doc = self._load()
        counts = self._counts(doc)
        self.events.emit("campaign-resume",
                         campaign=self.cfg.campaign_id, **counts)
        self.obs.event("campaign-resume",
                       campaign=self.cfg.campaign_id)
        return doc

    # ---- the pulse ----------------------------------------------------

    @staticmethod
    def _counts(doc: dict) -> Dict[str, int]:
        counts = {s: 0 for s in (OBS_PENDING, OBS_ADMITTING,
                                 OBS_ADMITTED, OBS_DONE, OBS_FAILED)}
        for row in doc["observations"].values():
            counts[row["state"]] = counts.get(row["state"], 0) + 1
        return counts

    @staticmethod
    def _outstanding(doc: dict) -> int:
        return sum(1 for r in doc["observations"].values()
                   if r["state"] in (OBS_ADMITTING, OBS_ADMITTED))

    def _plan(self, spec: dict):
        from presto_tpu_torch.serve.dag import plan_dag
        return plan_dag(spec)

    # presto-lint: holds(_lock)
    def _settle(self, doc: dict, now: float) -> List[str]:
        """Fence-checked completion counting: settle every
        outstanding observation whose DAG the job ledger reports
        terminal.  A node's state only becomes done through the
        epoch fence, so this count can never credit a zombie's late
        result; settling is write-once (a terminal row is skipped),
        so a racing second driver can never double-count."""
        settled: List[str] = []
        for obs_id in sorted(doc["observations"]):
            row = doc["observations"][obs_id]
            if row["state"] != OBS_ADMITTED:
                continue
            view = self.ledger.dag_view(row["dag_id"])
            if view is None or view["state"] not in TERMINAL:
                continue
            self._seam("pre-count-commit")
            row["state"] = (OBS_DONE if view["state"] == OBS_DONE
                            else OBS_FAILED)
            row["completed_at"] = now
            row["counts"] = dict(view.get("counts") or {})
            settled.append(obs_id)
        if settled:
            self._observe_settles(doc, settled, now)
            self._save(doc)
        return settled

    # presto-lint: holds(_lock)
    def _observe_settles(self, doc: dict, settled: List[str],
                         now: float) -> None:
        """Fold this pulse's settles into the throughput EWMAs that
        size waves: settle rate (obs/s between settle-bearing pulses)
        and admit→settle latency (s/obs).  Persisted in the campaign
        ledger by the caller's save, so a resumed driver sizes its
        first wave from the dead driver's measurements."""
        last = float(doc.get("last_settle_ts")
                     or doc.get("created", now))
        dt = max(now - last, 1e-6)
        rate_sample = len(settled) / dt
        lat_samples = [
            max(now - float(doc["observations"][o].get("admitted_at")
                            or now), 1e-6)
            for o in settled]
        lat_sample = sum(lat_samples) / len(lat_samples)
        prev_rate = doc.get("ewma_settle_rate")
        prev_lat = doc.get("ewma_settle_latency_s")
        doc["ewma_settle_rate"] = (
            rate_sample if prev_rate is None
            else EWMA_ALPHA * rate_sample
            + (1.0 - EWMA_ALPHA) * float(prev_rate))
        doc["ewma_settle_latency_s"] = (
            lat_sample if prev_lat is None
            else EWMA_ALPHA * lat_sample
            + (1.0 - EWMA_ALPHA) * float(prev_lat))
        doc["last_settle_ts"] = now

    @staticmethod
    def _wave_budget(doc: dict) -> int:
        """The measured wave bound: Little's-law concurrency (settle
        rate × admit→settle latency — the in-flight level the fleet
        actually sustains) rounded up, clamped to [1, wave_size].
        The configured ``wave_size`` constant is the ceiling and the
        pre-measurement default — until the first settle lands there
        is no throughput sample, so the bound starts at the constant
        and adapts from evidence only."""
        cap = max(int(doc["wave_size"]), 1)
        rate = float(doc.get("ewma_settle_rate") or 0.0)
        latency = float(doc.get("ewma_settle_latency_s") or 0.0)
        if rate <= 0.0 or latency <= 0.0:
            return cap
        return min(max(int(math.ceil(rate * latency)), 1), cap)

    # presto-lint: holds(_lock)
    def _admit_wave(self, doc: dict, now: float) -> List[str]:
        """Admit pending observations up to the wave bound.  Each one
        rides the admit-mark-then-admit_dag protocol: the ``admitting``
        mark (with the deterministic dag id) is durable BEFORE
        `admit_dag`, and a replayed admit's ``duplicate job_id`` error
        means the prior call landed — mark admitted, never re-admit."""
        admitted: List[str] = []
        # ``admitting`` rows (a crashed driver's in-flight marks)
        # already count as outstanding, so replaying them never
        # exceeds the wave bound — and they MUST replay even when the
        # budget is full, or a driver killed mid-wave would stall.
        # The bound itself is measured (settle-throughput EWMAs via
        # Little's law), with the wave_size constant as ceiling.
        budget = self._wave_budget(doc) - self._outstanding(doc)
        pending = [o for o in sorted(doc["observations"])
                   if doc["observations"][o]["state"] == OBS_PENDING]
        recovering = [o for o in sorted(doc["observations"])
                      if doc["observations"][o]["state"]
                      == OBS_ADMITTING]
        for obs_id in recovering + pending[:max(budget, 0)]:
            row = doc["observations"][obs_id]
            if row["state"] == OBS_PENDING:
                row["state"] = OBS_ADMITTING
                self._save(doc)          # the durable admit-mark
                self._seam("wave-admit")
            self._admit_one(doc, obs_id, row, now)
            admitted.append(obs_id)
            self._seam("mid-wave")
        return admitted

    # presto-lint: holds(_lock)
    def _admit_one(self, doc: dict, obs_id: str, row: dict,
                   now: float) -> None:
        with self.obs.span("campaign:admit",
                           campaign=self.cfg.campaign_id,
                           observation=obs_id) as span:
            try:
                self.ledger.admit_dag(
                    self._plan(row["spec"]), tenant=doc["tenant"],
                    priority=int(doc["priority"]),
                    dag_id=row["dag_id"], now=now)
            except JobLedgerError as e:
                if "duplicate job_id" not in str(e):
                    raise
                # the prior driver's admit landed before it died —
                # the duplicate error is the idempotence signal
                span.set_attr("replayed", True)
            row["state"] = OBS_ADMITTED
            row["admitted_at"] = now
            self._save(doc)
        self._c_admitted.inc()

    def _update_yield(self, doc: dict,
                      now: float) -> Optional[float]:
        """Recompute the live backfill yield from interactive burn
        and persist it (the lease policy stat-caches backfill.json,
        so the write is the actuation); emits campaign-yield only on
        change, so the event stream records every throttle decision
        without flooding."""
        from presto_tpu_torch.obs import slo
        specs = [s for s in slo.load_specs(self.cfg.fleetdir)
                 if s.tenant != doc["tenant"]]
        rows = self.ledger.usage.rows()
        evals = {s.tenant: slo.evaluate(s, rows, now) for s in specs}
        factor = slo.update_backfill_yield(self.cfg.fleetdir, evals)
        if factor is None:
            return None
        self._g_yield.set(factor)
        if abs(factor - float(doc.get("last_yield", 1.0))) > 1e-9:
            doc["last_yield"] = factor
            self._save(doc)
            self.events.emit(
                "campaign-yield", campaign=self.cfg.campaign_id,
                factor=round(factor, 6),
                burning=sorted(t for t, ev in evals.items()
                               if ev.get("alert")))
            self.obs.event("campaign-yield",
                           campaign=self.cfg.campaign_id)
        return factor

    def pulse(self, now: Optional[float] = None) -> dict:
        """One driver iteration: settle landed DAGs (fence-checked),
        admit the next wave up to the bound, refresh the backfill
        yield, and mark the campaign complete when every observation
        is terminal.  Safe to call from a fresh driver at any time —
        recovery IS this same code path."""
        now = time.time() if now is None else now
        with self.obs.span("campaign:pulse",
                           campaign=self.cfg.campaign_id) as span:
            with self._lock():
                doc = self._load()
                settled = self._settle(doc, now)
                admitted = self._admit_wave(doc, now)
                if admitted:
                    doc["waves"] = int(doc.get("waves", 0)) + 1
                    self._save(doc)
                counts = self._counts(doc)
                outstanding = self._outstanding(doc)
                finished = (doc["state"] == "running"
                            and not outstanding
                            and counts[OBS_PENDING] == 0
                            and counts[OBS_ADMITTING] == 0)
                if finished:
                    doc["state"] = "done"
                    doc["completed"] = now
                    self._save(doc)
            span.set_attr("settled", len(settled))
            span.set_attr("admitted", len(admitted))
        for obs_id in settled:
            row = doc["observations"][obs_id]
            self._c_settled.labels(state=row["state"]).inc()
            fields = dict(campaign=self.cfg.campaign_id,
                          observation=obs_id, dag=row["dag_id"],
                          counts=row.get("counts", {}))
            if row["state"] == OBS_DONE:
                self.events.emit("campaign-obs-done", **fields)
                self.obs.event("campaign-obs-done",
                               campaign=self.cfg.campaign_id)
            else:
                self.events.emit("campaign-obs-failed", **fields)
                self.obs.event("campaign-obs-failed",
                               campaign=self.cfg.campaign_id)
        if admitted:
            self._c_waves.inc()
            self.events.emit("campaign-wave-admit",
                             campaign=self.cfg.campaign_id,
                             wave=int(doc.get("waves", 0)),
                             observations=admitted,
                             outstanding=self._outstanding(doc),
                             wave_budget=self._wave_budget(doc))
            self.obs.event("campaign-wave-admit",
                           campaign=self.cfg.campaign_id)
        self._update_yield(doc, now)
        self._g_outstanding.set(self._outstanding(doc))
        if doc["state"] == "done" and (settled or admitted
                                       or "completed" in doc
                                       and doc["completed"] == now):
            counts = self._counts(doc)
            self.events.emit("campaign-complete",
                             campaign=self.cfg.campaign_id,
                             done=counts[OBS_DONE],
                             failed=counts[OBS_FAILED],
                             waves=int(doc.get("waves", 0)))
            self.obs.event("campaign-complete",
                           campaign=self.cfg.campaign_id)
        return self.status(doc=doc, now=now)

    def run(self, poll_s: float = 0.5,
            timeout: Optional[float] = None) -> dict:
        """Pulse until the campaign is terminal (or the timeout
        expires); returns the final status."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            status = self.pulse()
            if status["state"] != "running":
                return status
            if deadline is not None and time.time() > deadline:
                return status
            time.sleep(poll_s)

    # ---- introspection ------------------------------------------------

    def status(self, doc: Optional[dict] = None,
               now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        doc = doc or load_campaign(self.cfg.fleetdir,
                                   self.cfg.campaign_id)
        if doc is None:
            return {"campaign_id": self.cfg.campaign_id,
                    "state": "absent"}
        counts = self._counts(doc)
        return {
            "campaign_id": doc["campaign_id"],
            "state": doc["state"],
            "tenant": doc["tenant"],
            "wave_size": doc["wave_size"],
            "wave_budget": self._wave_budget(doc),
            "ewma_settle_rate": doc.get("ewma_settle_rate"),
            "ewma_settle_latency_s": doc.get(
                "ewma_settle_latency_s"),
            "waves": int(doc.get("waves", 0)),
            "observations": len(doc["observations"]),
            "counts": counts,
            "outstanding": self._outstanding(doc),
            "yield": float(doc.get("last_yield", 1.0)),
            "projection": self.project(doc, now=now),
        }

    def project(self, doc: Optional[dict] = None,
                now: Optional[float] = None) -> dict:
        """Live ETA + cost projection from measured telemetry alone:
        settled observations' device-seconds (usage.jsonl rows
        grouped by this campaign's dag ids) price the remaining
        census, and settle throughput over the campaign's elapsed
        time gives the ETA.  Converges to the measured total as the
        archive drains — zero projected remainder when done."""
        now = time.time() if now is None else now
        doc = doc or load_campaign(self.cfg.fleetdir,
                                   self.cfg.campaign_id)
        if doc is None:
            return {}
        dags = {r["dag_id"]: obs_id
                for obs_id, r in doc["observations"].items()}
        ds_by_obs: Dict[str, float] = {}
        for urow in self.ledger.usage.rows():
            obs_id = dags.get(str(urow.get("dag") or ""))
            if obs_id is None:
                continue
            ex = float((urow.get("phases") or {}).get("execute")
                       or 0.0)
            ds_by_obs[obs_id] = ds_by_obs.get(obs_id, 0.0) + ex
        settled = [o for o, r in doc["observations"].items()
                   if r["state"] in TERMINAL]
        remaining = (len(doc["observations"]) - len(settled))
        ds_settled = sum(ds_by_obs.get(o, 0.0) for o in settled)
        mean_obs = (ds_settled / len(settled)) if settled else None
        remaining_ds = (mean_obs * remaining
                        if mean_obs is not None else None)
        elapsed = max(now - float(doc.get("created", now)), 1e-9)
        rate = len(settled) / elapsed        # observations per second
        eta_s = (remaining / rate) if rate > 0 and remaining else (
            0.0 if not remaining else None)
        total = (ds_settled + remaining_ds
                 if remaining_ds is not None else None)
        return {
            "settled": len(settled),
            "remaining": remaining,
            "device_seconds_settled": round(ds_settled, 6),
            "mean_obs_device_seconds": (
                None if mean_obs is None else round(mean_obs, 6)),
            "remaining_device_seconds": (
                None if remaining_ds is None
                else round(remaining_ds, 6)),
            "projected_total_device_seconds": (
                None if total is None else round(total, 6)),
            "throughput_obs_per_s": round(rate, 6),
            "eta_s": None if eta_s is None else round(eta_s, 3),
        }

    def close(self) -> None:
        self.events.close()
