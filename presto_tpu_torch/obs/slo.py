"""SLO observatory: per-tenant error budgets, multi-window burn
rates, and the advisory `/scale` signal.

Host copy of ``presto_tpu/obs/slo.py`` for the PyTorch port (the
same ``slo.json``, ``backfill.json`` and usage rows as the JAX
package).

The fleet's *measurements* (`job_e2e_seconds` through
`obs/fleetagg.py`) become *decision signals* here — the
serving-economics layer of the control plane.  Everything here is a pure function over the durable usage
ledger (`serve/usage.py`: one row per fence-checked terminal job),
so the signals survive replica death and router restarts and can be
recomputed byte-for-byte from telemetry alone.

**Specs** (`SloSpec`) are declarative, one per tenant: an
availability objective (fraction of terminal jobs that must be
*good*) and an optional per-job latency objective (a done job slower
than `latency_s` end-to-end counts as bad — the deadline-lane analog
at fleet scope).  Specs persist as `<fleet>/slo.json` so the router,
the fleet report, and a future supervisor all read one source of
truth.

**Error budget**: with objective ``o``, the budget fraction is
``1 - o``; over the ledger's lifetime, ``budget_used = bad_fraction
/ (1 - o)`` (1.0 = budget exactly spent).

**Burn rates** follow the multi-window multi-burn-rate pattern from
the Google SRE workbook: ``burn(window) = bad_fraction(window) /
(1 - o)`` — burn 1 spends the budget exactly at the objective's
natural rate; burn N spends it N× faster.  An alert pair (fast
window, slow window, threshold) fires only when BOTH windows exceed
the threshold: the fast window gives reaction time, the slow window
suppresses blips.  Defaults are the classic 5m/1h @ 14.4 (page) and
30m/6h @ 6 (ticket) pairs.

**Window algebra**: burn evaluation factors through `window_state` —
pure per-window good/bad counts — and `merge_states`, which is
associative and commutative; for ANY partition of the usage rows
into shards, ``burn(merge(states(shards))) == burn(state(all
rows))``, mirroring the fleetagg percentile merge, so burn rates can
be computed incrementally or federated without drift.

**Scale advisory**: `scale_advice` derives a wanted-replica count
from the ledger backlog *expressed in expected device-seconds* (the
per-bucket mean `execute` phase is the cost model, as predictive
admission frames it) divided by per-replica measured
capacity (device-seconds actually executed per wall-second in a
recent window), targeting a configurable drain time; active burn
alerts add pressure (one replica above current ready).  The advisory
is just that — this PR derives and exposes the signal; acting on it
(an autoscaler, device-seconds admission) is the remaining
control-plane follow-up.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from presto_tpu_torch.io.atomic import atomic_write_text

SPEC_NAME = "slo.json"

SPEC_VERSION = 1

#: Google-SRE-workbook default alert pairs:
#: (fast window s, slow window s, burn threshold)
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),
    (1800.0, 21600.0, 6.0),
)

#: sparkline glyphs for the report's burn history
_SPARK = "▁▂▃▄▅▆▇█"


@dataclass(frozen=True)
class BurnWindow:
    """One fast/slow alert pair with its burn-rate threshold."""
    fast_s: float
    slow_s: float
    threshold: float

    @property
    def key(self) -> str:
        return "%gs/%gs" % (self.fast_s, self.slow_s)


@dataclass
class SloSpec:
    """One tenant's declarative service-level objective."""
    tenant: str
    objective: float                    # availability target in (0,1)
    latency_s: Optional[float] = None   # per-job e2e latency objective
    windows: Tuple[BurnWindow, ...] = tuple(
        BurnWindow(*w) for w in DEFAULT_WINDOWS)

    @property
    def budget_frac(self) -> float:
        return max(1.0 - float(self.objective), 1e-9)

    def to_dict(self) -> dict:
        return {"tenant": self.tenant,
                "objective": self.objective,
                "latency_s": self.latency_s,
                "windows": [[w.fast_s, w.slow_s, w.threshold]
                            for w in self.windows]}

    @classmethod
    def from_dict(cls, d: dict) -> "SloSpec":
        windows = tuple(BurnWindow(float(f), float(s), float(t))
                        for f, s, t in (d.get("windows")
                                        or DEFAULT_WINDOWS))
        lat = d.get("latency_s")
        return cls(tenant=str(d["tenant"]),
                   objective=float(d["objective"]),
                   latency_s=None if lat is None else float(lat),
                   windows=windows)


def parse_spec(text: str,
               windows: Optional[Sequence[Tuple[float, float,
                                                float]]] = None) \
        -> SloSpec:
    """One CLI spec string ``tenant:objective[:latency_s]`` (the
    router's ``-slo`` flag)."""
    parts = text.split(":")
    if len(parts) < 2:
        raise ValueError(
            "SLO spec %r must be tenant:objective[:latency_s]"
            % text)
    objective = float(parts[1])
    if not 0.0 < objective < 1.0:
        raise ValueError("SLO objective %r must be in (0, 1)"
                         % parts[1])
    kw = {}
    if windows:
        kw["windows"] = tuple(BurnWindow(*w) for w in windows)
    return SloSpec(tenant=parts[0], objective=objective,
                   latency_s=float(parts[2]) if len(parts) > 2
                   else None, **kw)


def parse_windows(text: str) -> Optional[List[Tuple[float, float,
                                                    float]]]:
    """``fast:slow:threshold[,fast:slow:threshold...]`` -> window
    tuples (None for an empty string: keep the defaults)."""
    text = (text or "").strip()
    if not text:
        return None
    out = []
    for part in text.split(","):
        f, s, t = (float(x) for x in part.split(":"))
        out.append((f, s, t))
    return out


def spec_path(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), SPEC_NAME)


def save_specs(fleetdir: str, specs: Sequence[SloSpec]) -> str:
    """Persist the spec set atomically as `<fleet>/slo.json` — the
    one source of truth the router, report, and future supervisor
    share."""
    path = spec_path(fleetdir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_write_text(path, json.dumps(
        {"version": SPEC_VERSION,
         "specs": [s.to_dict() for s in specs]},
        indent=1, sort_keys=True) + "\n")
    return path


def load_specs(fleetdir: str) -> List[SloSpec]:
    """The persisted spec set ([] when absent/unreadable — SLO
    evaluation simply has nothing to say then, never fails)."""
    try:
        with open(spec_path(fleetdir)) as f:
            doc = json.load(f)
        if int(doc.get("version", -1)) != SPEC_VERSION:
            return []
        return [SloSpec.from_dict(d) for d in doc.get("specs") or []]
    except (OSError, ValueError, KeyError, TypeError):
        return []


# ----------------------------------------------------------------------
# event classification + window algebra
# ----------------------------------------------------------------------

def classify(spec: SloSpec, row: dict) -> bool:
    """True when the usage row is a *good* event under this spec: a
    committed job within the latency objective.  Terminal failures
    and over-latency completions spend budget."""
    if row.get("state") != "done":
        return False
    if spec.latency_s is not None:
        total = float((row.get("phases") or {}).get("total") or 0.0)
        if total > spec.latency_s:
            return False
    return True


def window_state(spec: SloSpec, rows: Iterable[dict],
                 now: float) -> dict:
    """Pure per-window good/bad counts for one tenant — the
    mergeable \"registry\" burn evaluation factors through.  An event
    is in window W iff ``now - ts <= W``."""
    lengths = sorted({w.fast_s for w in spec.windows}
                     | {w.slow_s for w in spec.windows})
    state = {
        "tenant": spec.tenant,
        "total": 0,
        "bad": 0,
        "windows": {"%g" % length: {"good": 0, "bad": 0}
                    for length in lengths},
    }
    for row in rows:
        if str(row.get("tenant") or "") != spec.tenant:
            continue
        good = classify(spec, row)
        state["total"] += 1
        if not good:
            state["bad"] += 1
        age = now - float(row.get("ts") or 0.0)
        for length in lengths:
            if age <= length:
                key = "good" if good else "bad"
                state["windows"]["%g" % length][key] += 1
    return state


def merge_states(a: dict, b: dict) -> dict:
    """Sum two window states (associative + commutative — the window
    algebra the property test pins: merged-window burn equals the
    single-registry computation)."""
    out = {"tenant": a.get("tenant") or b.get("tenant"),
           "total": int(a.get("total", 0)) + int(b.get("total", 0)),
           "bad": int(a.get("bad", 0)) + int(b.get("bad", 0)),
           "windows": {}}
    keys = set(a.get("windows") or {}) | set(b.get("windows") or {})
    for k in sorted(keys):
        wa = (a.get("windows") or {}).get(k, {})
        wb = (b.get("windows") or {}).get(k, {})
        out["windows"][k] = {
            "good": int(wa.get("good", 0)) + int(wb.get("good", 0)),
            "bad": int(wa.get("bad", 0)) + int(wb.get("bad", 0)),
        }
    return out


def _burn(counts: dict, budget_frac: float) -> Tuple[float, int]:
    """(burn rate, events) for one window's counts: bad fraction over
    the budget fraction.  No events -> burn 0 (an idle tenant spends
    nothing)."""
    n = int(counts.get("good", 0)) + int(counts.get("bad", 0))
    if n == 0:
        return 0.0, 0
    return (counts.get("bad", 0) / n) / budget_frac, n


def evaluate_state(spec: SloSpec, state: dict) -> dict:
    """Burn-rate + budget evaluation over a (possibly merged) window
    state.  Deterministic: same state, same answer."""
    windows = []
    alert = False
    for w in spec.windows:
        fast, nf = _burn(state["windows"]["%g" % w.fast_s],
                         spec.budget_frac)
        slow, ns = _burn(state["windows"]["%g" % w.slow_s],
                         spec.budget_frac)
        alerting = (nf > 0 and ns > 0 and fast >= w.threshold
                    and slow >= w.threshold)
        alert = alert or alerting
        windows.append({
            "window": w.key,
            "fast_s": w.fast_s,
            "slow_s": w.slow_s,
            "threshold": w.threshold,
            "fast_burn": round(fast, 4),
            "slow_burn": round(slow, 4),
            "fast_events": nf,
            "slow_events": ns,
            "alerting": alerting,
        })
    total, bad = int(state["total"]), int(state["bad"])
    used = ((bad / total) / spec.budget_frac) if total else 0.0
    return {
        "tenant": spec.tenant,
        "objective": spec.objective,
        "latency_s": spec.latency_s,
        "events": total,
        "good": total - bad,
        "bad": bad,
        "budget_frac": round(spec.budget_frac, 9),
        "budget_used": round(used, 4),
        "budget_remaining": round(max(1.0 - used, 0.0), 4),
        "windows": windows,
        "alert": alert,
    }


def evaluate(spec: SloSpec, rows: Iterable[dict],
             now: float) -> dict:
    """One tenant's full SLO view straight from usage rows."""
    return evaluate_state(spec, window_state(spec, rows, now))


def burn_series(spec: SloSpec, rows: Sequence[dict], now: float,
                window_s: float, step_s: float,
                n: int = 16) -> List[float]:
    """Trailing burn-rate history: burn over `window_s` evaluated at
    ``n`` instants ending at `now`, `step_s` apart (the report's
    sparkline input)."""
    mine = [r for r in rows
            if str(r.get("tenant") or "") == spec.tenant]
    out = []
    for i in range(n):
        t = now - (n - 1 - i) * step_s
        counts = {"good": 0, "bad": 0}
        for row in mine:
            ts = float(row.get("ts") or 0.0)
            if 0.0 <= t - ts <= window_s:
                counts["good" if classify(spec, row) else "bad"] += 1
        out.append(round(_burn(counts, spec.budget_frac)[0], 4))
    return out


def sparkline(values: Sequence[float]) -> str:
    """Max-scaled unicode sparkline ('' for no data)."""
    if not values:
        return ""
    top = max(values)
    if top <= 0:
        return _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int(v / top * (len(_SPARK) - 1) + 0.5))]
        for v in values)


# ----------------------------------------------------------------------
# the backfill lane (campaign traffic yields to interactive burn)
# ----------------------------------------------------------------------

BACKFILL_NAME = "backfill.json"

BACKFILL_VERSION = 1

#: default lowest fraction of its configured WRR weight a backfill
#: tenant keeps while an interactive tenant is burning hard — the
#: campaign never fully starves (it would otherwise never finish),
#: it just slows to a trickle
BACKFILL_FLOOR = 0.05


def backfill_path(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), BACKFILL_NAME)


def save_backfill(fleetdir: str, tenants: Sequence[str],
                  yield_factor: float = 1.0,
                  floor: float = BACKFILL_FLOOR) -> str:
    """Durably declare the backfill tenant set (atomic, versioned —
    the campaign driver writes this once at start; the live
    ``yield`` field is then maintained by update_backfill_yield)."""
    path = backfill_path(fleetdir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_write_text(path, json.dumps(
        {"version": BACKFILL_VERSION,
         "tenants": sorted(str(t) for t in tenants),
         "floor": float(floor),
         "yield": float(yield_factor)},
        indent=1, sort_keys=True) + "\n")
    return path


def load_backfill(fleetdir: str) -> Optional[dict]:
    """The backfill declaration (None when absent/unreadable — no
    backfill lane, nothing yields)."""
    try:
        with open(backfill_path(fleetdir)) as f:
            doc = json.load(f)
        if int(doc.get("version", -1)) != BACKFILL_VERSION:
            return None
        return doc
    except (OSError, ValueError, TypeError):
        return None


def backfill_yield_factor(evals: Dict[str, dict],
                          exclude: Iterable[str] = (),
                          floor: float = BACKFILL_FLOOR) -> float:
    """The backfill-yield rule, a pure function over per-tenant SLO
    evaluations: while every interactive tenant burns its error
    budget at <= 1x (the sustainable rate), backfill keeps its full
    configured weight (factor 1.0); past that the factor shrinks as
    ``1 / worst_burn`` — a gold tenant burning 14x shrinks the
    campaign lane 14x — floored so the campaign never fully starves.
    ``exclude`` names the backfill tenants themselves (their own
    burn must not throttle them)."""
    excl = set(exclude)
    worst = 0.0
    for tenant, ev in (evals or {}).items():
        if tenant in excl:
            continue
        for w in ev.get("windows") or ():
            if int(w.get("fast_events", 0)) > 0:
                worst = max(worst, float(w.get("fast_burn", 0.0)))
    if worst <= 1.0:
        return 1.0
    return max(min(floor, 1.0), 1.0 / worst)


def update_backfill_yield(fleetdir: str,
                          evals: Dict[str, dict]) -> Optional[float]:
    """Recompute the live yield factor from interactive burn and
    persist it (atomically) when it moved: the job ledger's lease
    policy stat-caches `backfill.json`, so the write IS the
    actuation.  Returns the factor, or None when no backfill lane is
    declared.  Callers (the router's SLO pass, the campaign driver's
    pulse) emit their own events on change."""
    doc = load_backfill(fleetdir)
    if doc is None:
        return None
    factor = backfill_yield_factor(
        evals, exclude=doc.get("tenants") or (),
        floor=float(doc.get("floor", BACKFILL_FLOOR)))
    if abs(factor - float(doc.get("yield", 1.0))) > 1e-9:
        save_backfill(fleetdir, doc.get("tenants") or (),
                      yield_factor=factor,
                      floor=float(doc.get("floor", BACKFILL_FLOOR)))
    return factor


# ----------------------------------------------------------------------
# usage rollups (device-seconds accounting)
# ----------------------------------------------------------------------

def _execute_s(row: dict) -> float:
    return float((row.get("phases") or {}).get("execute") or 0.0)


def usage_rollup(rows: Iterable[dict]) -> dict:
    """Per-tenant (and per-bucket) device-seconds rollup over usage
    rows.  Only committed (`done`) rows meter device-seconds — they
    are the rows whose `execute` phase also reached the
    `job_e2e_seconds` histogram, which is what makes the conservation
    property exact."""
    tenants: Dict[str, dict] = {}
    total_s = 0.0
    total_jobs = 0
    for row in rows:
        t = str(row.get("tenant") or "")
        ent = tenants.setdefault(t, {"device_seconds": 0.0,
                                     "jobs": 0, "failed": 0,
                                     "buckets": {}})
        if row.get("state") == "done":
            ex = _execute_s(row)
            ent["device_seconds"] += ex
            ent["jobs"] += 1
            total_s += ex
            total_jobs += 1
            b = str(row.get("bucket") or "")
            bent = ent["buckets"].setdefault(
                b, {"device_seconds": 0.0, "jobs": 0})
            bent["device_seconds"] += ex
            bent["jobs"] += 1
        else:
            ent["failed"] += 1
    for ent in tenants.values():
        ent["device_seconds"] = round(ent["device_seconds"], 6)
        for bent in ent["buckets"].values():
            bent["device_seconds"] = round(bent["device_seconds"], 6)
    return {"tenants": {t: tenants[t] for t in sorted(tenants)},
            "total_device_seconds": round(total_s, 6),
            "total_jobs": total_jobs}


def bucket_cost_model(rows: Iterable[dict]) -> Tuple[Dict[str, float],
                                                     Optional[float]]:
    """(per-bucket mean execute seconds, global mean) from committed
    usage rows — the expected-device-seconds cost model the scale
    advisory (and a future device-seconds admission gate) prices
    backlog with."""
    acc: Dict[str, List[float]] = {}
    all_ex: List[float] = []
    for row in rows:
        if row.get("state") != "done":
            continue
        ex = _execute_s(row)
        if ex <= 0.0:
            continue
        acc.setdefault(str(row.get("bucket") or ""), []).append(ex)
        all_ex.append(ex)
    means = {b: sum(xs) / len(xs) for b, xs in acc.items()}
    return means, (sum(all_ex) / len(all_ex)) if all_ex else None


def fleet_median_cost(means: Dict[str, float],
                      default_s: float = 5.0) -> float:
    """The fleet-median per-bucket cost — the estimate an admission
    gate charges a bucket it has never executed.  Median, not mean:
    one pathological bucket must not poison every unknown job's
    price.  `default_s` is the cold-fleet fallback (no bucket has
    committed yet)."""
    if not means:
        return default_s
    ordered = sorted(means.values())
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def cost_estimator(rows: Iterable[dict], default_s: float = 5.0):
    """``bucket -> expected device-seconds`` closure over the usage
    ledger: known buckets price at their mean committed execute
    seconds, unknown buckets at the fleet-median bucket cost (the
    AutoTVM-style measured-cost prior), and a cold fleet at
    `default_s`.  The closure is what `JobLedger.admit` charges
    device-second quotas with and what the router's device-second
    shedding prices backlog with — one model, every consumer."""
    means, _global_mean = bucket_cost_model(rows)
    fallback = fleet_median_cost(means, default_s)

    def estimate(bucket) -> float:
        return means.get(str(bucket or ""), fallback)

    estimate.buckets = len(means)      # type: ignore[attr-defined]
    estimate.fallback = fallback       # type: ignore[attr-defined]
    return estimate


# ----------------------------------------------------------------------
# the /scale advisory
# ----------------------------------------------------------------------

@dataclass
class ScaleConfig:
    """Knobs of the wanted-replica derivation."""
    target_drain_s: float = 30.0   # drain the backlog within this
    min_replicas: int = 1
    max_replicas: int = 16
    default_job_s: float = 5.0     # cost of a bucket never seen
    capacity_window_s: float = 300.0
    #: measured capacity clamp (device-seconds per wall-second per
    #: replica): a briefly idle fleet must not divide by ~zero
    min_capacity: float = 0.25
    max_capacity: float = 4.0


def measured_capacity(rows: Sequence[dict], now: float,
                      cfg: ScaleConfig, replicas: int) -> float:
    """Per-replica device-seconds executed per wall-second over the
    trailing capacity window (1.0 = one device fully busy).  Falls
    back to 1.0 with no recent commits — the cold-start assumption
    that one replica is one device."""
    recent = [r for r in rows
              if r.get("state") == "done"
              and now - float(r.get("ts") or 0.0)
              <= cfg.capacity_window_s]
    if not recent or replicas <= 0:
        return 1.0
    ex = sum(_execute_s(r) for r in recent)
    cap = ex / cfg.capacity_window_s / max(replicas, 1)
    return min(max(cap, cfg.min_capacity), cfg.max_capacity)


def scale_advice(backlog_buckets: Sequence[Optional[str]],
                 rows: Sequence[dict],
                 evals: Dict[str, dict],
                 ready_replicas: int,
                 cfg: Optional[ScaleConfig] = None,
                 now: float = 0.0,
                 campaign_remaining_s: float = 0.0) -> dict:
    """The advisory `/scale` signal: wanted replica count + reason.

    ``backlog_buckets`` is one entry per pending/leased ledger job
    (its bucket hint, None for unknown).  The backlog is priced in
    expected device-seconds via the per-bucket execute cost model,
    divided by per-replica measured capacity and the target drain
    time; tenants with an active burn alert add SLO-debt pressure
    (at least one replica above current ready).
    ``campaign_remaining_s`` is the running campaigns' projected
    remaining-archive device-seconds (`CampaignDriver.project`) —
    work the bounded-wave admission has not put in the ledger yet, so
    the count-based backlog cannot see it; folding it in lets a
    supervisor spin capacity up for an archive instead of chasing one
    wave at a time.  Pure function — a supervisor (or a
    chaos harness in reverse) can replay every decision from
    telemetry alone."""
    cfg = cfg or ScaleConfig()
    means, global_mean = bucket_cost_model(rows)
    fallback = global_mean if global_mean is not None \
        else cfg.default_job_s
    ledger_s = sum(means.get(str(b or ""), fallback)
                   for b in backlog_buckets)
    campaign_s = max(0.0, float(campaign_remaining_s))
    backlog_s = ledger_s + campaign_s
    capacity = measured_capacity(rows, now, cfg,
                                 max(ready_replicas, 1))
    demand = 0
    if backlog_buckets or campaign_s > 0.0:
        demand = int(math.ceil(
            backlog_s / (cfg.target_drain_s * capacity)))
    pressure = sorted(t for t, ev in (evals or {}).items()
                      if ev.get("alert"))
    wanted = demand
    if pressure:
        wanted = max(wanted, ready_replicas + 1)
    wanted = min(max(wanted, cfg.min_replicas), cfg.max_replicas)
    if pressure and wanted > demand:
        reason = ("slo-debt: %s burning error budget; "
                  "backlog %.1f device-s wants %d"
                  % (",".join(pressure), backlog_s, demand))
    elif backlog_buckets or campaign_s > 0.0:
        reason = ("backlog %.1f device-s (%.1f ledger + %.1f "
                  "campaign) / (%.0fs drain x %.2f cap/replica) "
                  "-> %d"
                  % (backlog_s, ledger_s, campaign_s,
                     cfg.target_drain_s, capacity, demand))
    else:
        reason = "idle: no backlog, no SLO pressure"
    return {
        "wanted_replicas": int(wanted),
        "reason": reason,
        "inputs": {
            "backlog_jobs": len(backlog_buckets),
            "backlog_device_seconds": round(backlog_s, 3),
            "campaign_remaining_device_seconds": round(
                campaign_s, 3),
            "per_replica_capacity": round(capacity, 4),
            "ready_replicas": int(ready_replicas),
            "target_drain_s": cfg.target_drain_s,
            "slo_pressure": pressure,
            "cost_model_buckets": len(means),
        },
    }
