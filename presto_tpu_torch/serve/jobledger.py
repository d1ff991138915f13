"""Shared on-disk job ledger for a fleet of presto-serve replicas.

Host copy of ``presto_tpu/serve/jobledger.py`` for the PyTorch port.
The ledger files (``jobs.json``, ``usage.jsonl``, the heartbeats) are
the JAX package's, so either package's replicas and router can share
one fleet directory.  One addition: ``complete`` and
``complete_and_expand`` take an ``on_commit`` callable, run inside
the commit's critical section after the fence check passed and before
the state file is replaced, so what the committer counts is counted
before any reader can see the job terminal, and a fenced-off commit
counts nothing.

One process, one queue, one crash losing everything is the failure
mode this closes: submissions land here — a durable, transactional
ledger on the shared filesystem — and N replicas *lease* jobs out of
it, so a replica crash loses nothing but time.  The lease /
heartbeat / epoch-fencing / staged-commit mechanics are the generic
`pipeline/leaseledger.LeaseLedger` (the elastic PR's recovery
primitives, factored out of `pipeline/shardledger.py`); this module
binds them to the serve-job vocabulary:

  * an item is a **job row** in `jobs.json`: the submitted spec
    (rawfiles + SurveyConfig fields), a tenant, a priority, and the
    usual lease columns;
  * `complete()` commits the job's `result.json` through the staged
    fence-checked path, so a zombie replica's late result never
    lands (`stale-result-rejected`);
  * jobs add a fence-checked terminal ``failed`` state
    (`fail_terminal`): a job whose retry budget is exhausted on a
    live replica must terminate, not cycle the fleet forever;
  * the lease scheduling policy is **weighted round-robin over
    tenants** (deficit-style: the pending tenant with the smallest
    served/weight ratio goes next), so one chatty tenant cannot
    starve the rest, and per-tenant **quotas** bound admission:
    `admit()` raises the typed `TenantQuotaExceeded` — a visible,
    typed rejection, never a silent drop.

Discovery DAGs (`serve/dag.py`) add **job dependencies** on top of
the same lease core: a job may be admitted ``blocked_on`` a list of
parent job ids and becomes leasable only once every parent's
fence-checked commit has landed — the parent's state only ever
becomes ``done`` through the epoch fence, so a zombie replica's late
result can never unblock a child.  `complete_and_expand` commits a
node AND creates its dynamically fanned-out children (the sift
node's per-candidate fold jobs) in ONE fenced transaction, so a
crash between "result landed" and "children exist" is impossible,
and a fenced-off zombie expands nothing.  Children of a terminally
failed parent cascade to ``failed`` (`dag-cascade-fail`) instead of
blocking the fleet forever.

The router (`serve/router.py`) is the admission front door; replicas
(`serve/fleet.py`) are the lease-and-execute loop.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch.pipeline.leaseledger import (DONE, FAILED, LEASED,
                                                   PENDING, ItemLease,
                                                   LeaseLedger, LedgerError,
                                                   StaleLeaseError)
from presto_tpu_torch.serve.usage import UsageLedger

LEDGER_NAME = "jobs.json"

DEFAULT_TENANT = "default"


class JobLedgerError(LedgerError):
    """Base class for job-ledger protocol violations."""


class StaleResultError(StaleLeaseError, JobLedgerError):
    """A result commit attempted under a lease the fleet has fenced
    off — the zombie-replica case.  The staged result was discarded
    and the journaled one (if any) was never overwritten."""


class TenantQuotaExceeded(JobLedgerError):
    """Typed admission rejection: the tenant is at its quota —
    counted in active (pending + leased) jobs, or priced in expected
    device-seconds of active work (``unit="device-seconds"``, the
    measured-cost admission gate).  Mapped to HTTP 429 by the
    router; recorded as a `quota-exceeded` event, never a silent
    drop."""

    def __init__(self, tenant: str, quota, active,
                 unit: str = "jobs", cost: float = 0.0):
        self.tenant = tenant
        self.quota = quota
        self.active = active
        self.unit = unit
        self.cost = cost
        if unit == "jobs":
            msg = ("tenant %r is at its quota (%d active of %d "
                   "allowed)" % (tenant, active, quota))
        else:
            msg = ("tenant %r is at its device-second quota "
                   "(%.3f active + %.3f expected of %.3f allowed)"
                   % (tenant, active, cost, quota))
        super().__init__(msg)


class JobLedger(LeaseLedger):
    """Leased-job journal for one fleet directory."""

    LEDGER_NAME = LEDGER_NAME
    ITEMS_KEY = "jobs"
    ERROR = JobLedgerError
    STALE = StaleResultError
    EV_LEASE = "job-lease"
    EV_DONE = "job-done"
    EV_REDO = "job-redo"
    EV_STALE = "stale-result-rejected"
    EV_HOST_DEAD = "replica-dead"
    EV_EPOCH_BUMP = "fleet-epoch-bump"

    #: SLO-class lease-weight multiplier cap: a 99.9 % tenant beats a
    #: 50 % bronze 100:2 under contention, but no objective — however
    #: many nines — can starve the rest beyond this ratio
    CLASS_WEIGHT_CAP = 100.0

    # -- tenant configuration ------------------------------------------
    def set_tenant(self, tenant: str, weight: float = 1.0,
                   quota: Optional[int] = None,
                   ds_quota: Optional[float] = None) -> None:
        """Configure one tenant's WRR weight, active-job quota, and
        device-second quota (None = unbounded).  ``ds_quota`` bounds
        the *expected device-seconds* of the tenant's active
        (pending + leased) work, priced by the per-bucket execute
        cost model — the measured-cost admission gate that throttles
        one tenant's few huge jobs and another's many tiny jobs
        equivalently.  Unknown tenants default to weight 1, no
        quotas."""
        with self._lock():
            state = self._load()
            state.setdefault("tenants", {})[str(tenant)] = {
                "weight": max(float(weight), 1e-9),
                "quota": None if quota is None else int(quota),
                "ds_quota": (None if ds_quota is None
                             else float(ds_quota)),
            }
            self._save(state)

    def tenants(self) -> Dict[str, dict]:
        return dict(self._load().get("tenants", {}))

    # -- SLO-class lease weights ---------------------------------------
    def _class_weights(self) -> Dict[str, float]:
        """Per-tenant lease-weight multipliers derived from the SLO
        classes in `<fleet>/slo.json` (cached by file stat): a tenant
        with objective ``o`` multiplies its configured WRR weight by
        ``min(1/(1-o), CLASS_WEIGHT_CAP)``, so under contention a
        burning gold tenant's jobs are leased ahead of bronze
        backfill in proportion to how little error budget its class
        affords.  Tenants without a spec keep multiplier 1."""
        from presto_tpu_torch.obs import slo
        try:
            st = os.stat(slo.spec_path(self.workdir))
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            key = None
        cached = getattr(self, "_class_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        weights: Dict[str, float] = {}
        if key is not None:
            for spec in slo.load_specs(self.workdir):
                mult = 1.0 / max(1.0 - float(spec.objective), 1e-9)
                weights[spec.tenant] = min(max(mult, 1.0),
                                           self.CLASS_WEIGHT_CAP)
        self._class_cache = (key, weights)
        return weights

    def _backfill_factors(self) -> Dict[str, float]:
        """Per-tenant lease-weight yield factors for the backfill
        lane, from `<fleet>/backfill.json` (cached by file stat, like
        `_class_weights`): tenants the campaign driver declared as
        backfill have their WRR weight multiplied by the live yield
        factor the SLO pass maintains — when an interactive tenant
        burns its error budget, backfill leases thin out in
        proportion, without touching the configured weights."""
        from presto_tpu_torch.obs import slo
        try:
            st = os.stat(slo.backfill_path(self.workdir))
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            key = None
        cached = getattr(self, "_backfill_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        factors: Dict[str, float] = {}
        if key is not None:
            doc = slo.load_backfill(self.workdir)
            if doc is not None:
                y = min(max(float(doc.get("yield", 1.0)), 1e-9), 1.0)
                for t in doc.get("tenants") or ():
                    factors[str(t)] = y
        self._backfill_cache = (key, factors)
        return factors

    def _tenant_cfg(self, state: dict, tenant: str) -> dict:
        cfg = state.get("tenants", {}).get(tenant) or {}
        weight = max(float(cfg.get("weight", 1.0)), 1e-9)
        weight *= self._class_weights().get(tenant, 1.0)
        weight *= self._backfill_factors().get(tenant, 1.0)
        return {"weight": weight,
                "quota": cfg.get("quota"),
                "ds_quota": cfg.get("ds_quota")}

    # -- the measured-cost admission gate ------------------------------
    def cost_estimator(self):
        """``bucket -> expected device-seconds`` from the usage
        ledger's per-bucket execute cost model (fleet-median fallback
        for unknown buckets; obs/slo.cost_estimator), cached by the
        usage file's stat so admission stays O(active jobs), not
        O(history) per call."""
        from presto_tpu_torch.obs import slo
        try:
            st = os.stat(self.usage.path)
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            key = None
        cached = getattr(self, "_cost_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        est = slo.cost_estimator(self.usage.rows())
        self._cost_cache = (key, est)
        return est

    def _charge_ds_quota(self, state: dict, tenant: str, cfg: dict,
                         new_buckets: Sequence) -> None:
        """Raise the typed device-second rejection when admitting
        ``new_buckets`` would push the tenant's expected active
        device-seconds past its ds_quota.  Called under the ledger
        lock, before any row is created."""
        if cfg.get("ds_quota") is None:
            return
        est = self.cost_estimator()
        active_ds = sum(
            est(j.get("bucket"))
            for j in self._items(state).values()
            if j.get("tenant") == tenant
            and j["state"] in (PENDING, LEASED))
        cost = sum(est(b) for b in new_buckets)
        if active_ds + cost > float(cfg["ds_quota"]):
            self._event("quota-exceeded", tenant=tenant,
                        quota=cfg["ds_quota"],
                        active=round(active_ds, 6),
                        cost=round(cost, 6),
                        unit="device-seconds")
            raise TenantQuotaExceeded(
                tenant, float(cfg["ds_quota"]),
                round(active_ds, 6), unit="device-seconds",
                cost=round(cost, 6))

    def backlog_device_seconds(self) -> float:
        """Expected device-seconds of the active (pending + leased)
        backlog under the cost model — the router's device-second
        shedding signal (the priced twin of `depth()`)."""
        est = self.cost_estimator()
        return sum(est(row.get("bucket"))
                   for row in self._load()[self.ITEMS_KEY].values()
                   if row["state"] in (PENDING, LEASED))

    # -- admission ------------------------------------------------------
    def admit(self, spec: dict, tenant: str = DEFAULT_TENANT,
              job_id: Optional[str] = None, priority: int = 10,
              now: Optional[float] = None,
              bucket: Optional[str] = None,
              blocked_on: Optional[Sequence[str]] = None,
              dag: Optional[str] = None,
              trace: Optional[dict] = None) -> dict:
        """Durably admit one job.  Enforces the tenant's quota over
        its *active* (pending + leased) jobs; raises the typed
        TenantQuotaExceeded past it.  Returns the job's ledger view.
        Duplicate explicit job_ids raise JobLedgerError.

        ``bucket`` is the job's plan-bucket hint (the repr of
        serve/plancache.bucket_key, computed by the router at
        admission): `lease_batch` stacks only jobs sharing it, so a
        replica can claim a whole same-bucket batch in one fenced
        transaction.  None disables batch leasing for this job —
        never a correctness loss, only a batching one.

        ``blocked_on`` names parent job ids: the job stays pending
        but UN-leasable until every parent's fence-checked commit
        lands (serve/dag.py).  ``dag`` tags the row with its graph id
        for `dag_view`.

        ``trace`` is the router's span context
        (`SpanContext.to_dict`): stamped onto the row so the leasing
        replica resumes the submission's trace — search on replica A
        and its folds on replica B render as ONE timeline.  Purely
        telemetry: never read by the execution path, absent rows
        simply start fresh traces."""
        now = time.time() if now is None else now
        tenant = str(tenant or DEFAULT_TENANT)
        with self._lock():
            state = self._load()
            jobs = self._items(state)
            cfg = self._tenant_cfg(state, tenant)
            active = sum(1 for j in jobs.values()
                         if j.get("tenant") == tenant
                         and j["state"] in (PENDING, LEASED))
            if cfg["quota"] is not None and active >= cfg["quota"]:
                self._event("quota-exceeded", tenant=tenant,
                            quota=cfg["quota"], active=active,
                            unit="jobs")
                raise TenantQuotaExceeded(tenant, int(cfg["quota"]),
                                          active)
            self._charge_ds_quota(state, tenant, cfg, [bucket])
            if job_id is None:
                seq = int(state.get("next_id", 1))
                state["next_id"] = seq + 1
                job_id = "fjob-%06d" % seq
            elif job_id in jobs:
                raise JobLedgerError("duplicate job_id %r" % job_id)
            row = {
                "spec": dict(spec),
                "tenant": tenant,
                "priority": int(priority),
                "submitted": now,
                "error": "",
                "bucket": bucket,
                "blocked_on": list(blocked_on or ()),
                "dag": dag,
            }
            if trace:
                row["trace"] = dict(trace)
            jobs[job_id] = self._new_row(row)
            self._save(state)
            return self._view(job_id, jobs[job_id])

    # -- discovery DAGs -------------------------------------------------
    def _registry(self):
        """The shared metrics registry (None without an obs handle);
        dag_* counters register with literal names (the JAX package's
        metric catalog)."""
        return getattr(self.obs, "metrics", None)

    # -- durable usage metering (the SLO observatory's substrate) ------
    @property
    def usage(self) -> UsageLedger:
        """This fleet's crash-atomic `usage.jsonl` journal (lazy; a
        per-tenant device-seconds record that survives replica death
        and router restarts — serve/usage.py)."""
        led = getattr(self, "_usage", None)
        if led is None:
            led = self._usage = UsageLedger(self.workdir)
        return led

    def _usage_append(self, lease: ItemLease, usage: Optional[dict],
                      state: str, now: float) -> None:
        """Append one usage row for a terminal transition.  Called
        strictly AFTER the epoch-fence check accepted this replica's
        verdict (complete / complete_and_expand / fail_terminal), so
        a fenced zombie can never meter anything; crash-atomicity is
        the usage ledger's append contract.  The `execute` phase
        seconds also feed `slo_device_seconds_total{tenant,bucket}`
        so the snapshot/aggregation path carries the same number."""
        if usage is None:
            return
        row = dict(usage)
        row.setdefault("job_id", lease.item_id)
        row.setdefault("tenant", str(lease.data.get("tenant")
                                     or DEFAULT_TENANT))
        row.setdefault("bucket", lease.data.get("bucket"))
        row.setdefault("dag", lease.data.get("dag"))
        row["state"] = state
        row.setdefault("ts", now)
        self.usage.append(row)
        execute = float((row.get("phases") or {}).get("execute")
                        or 0.0)
        reg = self._registry()
        if reg is not None and state == DONE and execute > 0.0:
            reg.counter(
                "slo_device_seconds_total",
                "Device-execute seconds metered per tenant and plan "
                "bucket at each fence-checked commit (the usage "
                "ledger's counter twin)",
                ("tenant", "bucket")).labels(
                    tenant=row["tenant"],
                    bucket=str(row.get("bucket") or "")).inc(execute)

    def complete(self, lease, host: str, staged: Dict[str, str],
                 now: Optional[float] = None,
                 extra: Optional[dict] = None,
                 usage: Optional[dict] = None,
                 on_commit=None) -> Dict[str, dict]:
        """Fence-checked commit (the LeaseLedger.complete transaction)
        plus durable usage metering INSIDE it: the fence check runs
        first (a zombie raises STALE before ever reaching the append)
        and the usage row is durable before the ledger state flips to
        done — a job the fleet can observe as done has always been
        metered.  A crash between the append and the state save
        re-admits the job; the redo's row supersedes (usage reader
        dedups by job_id, last row wins).  ``on_commit()`` runs after
        the usage append, before the state save (module docstring)."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            why = self._fence_why(row, lease, host)
            if why is not None:
                self._reject_stale(state, lease, host, staged, why)
            arts = self._commit_row(state, lease, host, staged, row,
                                    now, extra)
            self._usage_append(lease,
                               usage if usage is not None else {},
                               DONE, now)
            if on_commit is not None:
                on_commit()
            self._save(state)
        self._event(self.EV_DONE, item=lease.item_id, host=host,
                    artifacts=len(arts))
        return arts

    def admit_dag(self, nodes: Sequence[Tuple[str, dict,
                                              Optional[str],
                                              Sequence[str]]],
                  tenant: str = DEFAULT_TENANT, priority: int = 10,
                  dag_id: Optional[str] = None,
                  now: Optional[float] = None,
                  trace: Optional[dict] = None) -> dict:
        """Durably admit one job graph as ONE ledger transaction.

        ``nodes`` is a sequence of ``(rel_id, spec, bucket,
        parent_rel_ids)``; every rel_id becomes ``<dag_id>-<rel_id>``
        and the parent references (both ``blocked_on`` and the spec's
        ``parents``/``retarget`` fields, which replicas use to locate
        committed parent artifact dirs) are prefixed the same way, so
        a DagSpec is portable across submissions.  The tenant quota
        counts the whole graph: either every node is admitted or none
        is (TenantQuotaExceeded / JobLedgerError leave the ledger
        untouched).  Returns ``{"dag_id", "nodes": {rel: job_id}}``.
        """
        now = time.time() if now is None else now
        tenant = str(tenant or DEFAULT_TENANT)
        with self._lock():
            state = self._load()
            jobs = self._items(state)
            cfg = self._tenant_cfg(state, tenant)
            active = sum(1 for j in jobs.values()
                         if j.get("tenant") == tenant
                         and j["state"] in (PENDING, LEASED))
            if (cfg["quota"] is not None
                    and active + len(nodes) > cfg["quota"]):
                self._event("quota-exceeded", tenant=tenant,
                            quota=cfg["quota"], active=active,
                            unit="jobs")
                raise TenantQuotaExceeded(tenant, int(cfg["quota"]),
                                          active)
            self._charge_ds_quota(state, tenant, cfg,
                                  [b for _, _, b, _ in nodes])
            if dag_id is None:
                seq = int(state.get("next_dag", 1))
                state["next_dag"] = seq + 1
                dag_id = "dag-%06d" % seq

            def _full(rel: str) -> str:
                return "%s-%s" % (dag_id, rel)

            ids = {}
            for rel, _spec, _bucket, _parents in nodes:
                jid = _full(rel)
                if jid in jobs:
                    raise JobLedgerError("duplicate job_id %r" % jid)
                ids[rel] = jid
            for rel, spec, bucket, parents in nodes:
                spec = dict(spec, dag=dag_id)
                raw = spec.get("parents")
                if isinstance(raw, dict):
                    spec["parents"] = {
                        role: ([_full(v) for v in val]
                               if isinstance(val, (list, tuple))
                               else _full(val))
                        for role, val in raw.items()}
                if isinstance(spec.get("retarget"), str):
                    spec["retarget"] = _full(spec["retarget"])
                row = {
                    "spec": spec,
                    "tenant": tenant,
                    "priority": int(priority),
                    "submitted": now,
                    "error": "",
                    "bucket": bucket,
                    "blocked_on": [_full(p) for p in parents or ()],
                    "dag": dag_id,
                }
                if trace:
                    # every node starts under the DAG's trace; the
                    # sift expand re-parents its fold fan-out under
                    # the sift node's own span (fleet.py _commit)
                    row["trace"] = dict(trace)
                jobs[ids[rel]] = self._new_row(row)
            self._save(state)
        self._event("dag-submit", dag=dag_id, nodes=sorted(ids),
                    tenant=tenant)
        reg = self._registry()
        if reg is not None:
            reg.counter(
                "dag_submitted_total",
                "Job graphs durably admitted to the ledger").inc()
        return {"dag_id": dag_id, "nodes": dict(ids)}

    @staticmethod
    def _leasable(items: dict, row: dict) -> bool:
        """A pending row is leasable once every blocked_on parent has
        landed its fence-checked commit (state == done).  A parent's
        state only ever becomes done THROUGH the fence, so a zombie's
        late result can never make a child leasable."""
        for pid in row.get("blocked_on") or ():
            prow = items.get(pid)
            if prow is None or prow["state"] != DONE:
                return False
        return True

    def _cascade_failures(self, state: dict, now: float) -> List[str]:
        """Terminally fail pending jobs whose parents can never
        complete (a failed — or missing — parent): the DAG analog of
        fail_terminal, so a poisoned node's whole downstream subtree
        settles with a diagnosable error instead of blocking the
        fleet forever.  Transitive by fixpoint.  Called under the
        ledger lock from the lease scheduling policy."""
        items = self._items(state)
        failed: List[str] = []
        changed = True
        while changed:
            changed = False
            for jid in sorted(items):
                row = items[jid]
                if row["state"] != PENDING:
                    continue
                for pid in row.get("blocked_on") or ():
                    prow = items.get(pid)
                    if prow is None or prow["state"] == FAILED:
                        row["state"] = FAILED
                        row["error"] = (
                            "dag parent %s %s" % (
                                pid, "failed: %s"
                                % prow.get("error", "")
                                if prow is not None else "missing"))
                        row["completed_at"] = now
                        failed.append(jid)
                        changed = True
                        break
        for jid in failed:
            row = items[jid]
            # a cascade-failed node never executed, but it is terminal:
            # meter a zero-execute row so accounting conserves (admitted
            # == done + failed exactly) and campaign ETA math cannot
            # diverge on a failing observation.  Re-appending after a
            # crash before the ledger save is harmless — rows() dedups
            # by job_id.
            self.usage.append({
                "job_id": jid,
                "tenant": str(row.get("tenant") or DEFAULT_TENANT),
                "bucket": row.get("bucket"),
                "dag": row.get("dag"),
                "state": FAILED,
                "ts": now,
                "phases": {},
                "cascade": True,
            })
        for jid in failed:
            self._event("dag-cascade-fail", item=jid,
                        error=items[jid]["error"])
        reg = self._registry()
        if failed and reg is not None:
            reg.counter(
                "dag_cascade_failures_total",
                "DAG children terminally failed because a parent "
                "node failed").inc(len(failed))
        return failed

    def complete_and_expand(self, lease, host: str,
                            staged: Dict[str, str],
                            now: Optional[float] = None,
                            extra: Optional[dict] = None,
                            children: Optional[Sequence[Tuple[
                                str, dict]]] = None,
                            retarget: Optional[Dict[str, dict]]
                            = None,
                            usage: Optional[dict] = None,
                            on_commit=None) -> Dict[str, dict]:
        """Fence-checked commit PLUS dynamic fan-out, atomically.

        The sift node's surviving-candidate list decides the fold
        fan-out; committing the list and creating the fold jobs must
        be one durable step — a crash between them would strand a
        done parent with no children, and a zombie must expand
        nothing.  So: under ONE ledger lock, fence-check (STALE
        raises exactly like complete(), staged files deleted, no row
        touched), land the staged result, create every child row
        idempotently (an id that already exists is left alone — the
        re-commit path), and retarget downstream nodes'
        ``blocked_on``/``parents`` (the timing node's fold fan-in).

        ``children``: [(job_id, row_fields)] where row_fields carries
        spec/tenant/priority/bucket/blocked_on/dag.  ``retarget``:
        {job_id: {"blocked_on": [...], "parents": {...merged into
        the row's spec...}}} applied only while the target is still
        pending.  ``on_commit`` as in `complete`."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            items = self._items(state)
            row = items.get(lease.item_id)
            why = self._fence_why(row, lease, host)
            if why is not None:
                self._reject_stale(state, lease, host, staged, why)
            arts = self._commit_row(state, lease, host, staged, row,
                                    now, extra)
            created = []
            for cid, fields in children or ():
                if cid in items:
                    continue            # idempotent re-expansion
                fields = dict(fields)
                fields.setdefault("submitted", now)
                fields.setdefault("error", "")
                items[cid] = self._new_row(fields)
                created.append(cid)
            for jid, change in (retarget or {}).items():
                trow = items.get(jid)
                if trow is None or trow["state"] != PENDING:
                    continue
                if "blocked_on" in change:
                    trow["blocked_on"] = list(change["blocked_on"])
                if "parents" in change:
                    spec = dict(trow.get("spec") or {})
                    parents = dict(spec.get("parents") or {})
                    parents.update(change["parents"])
                    spec["parents"] = parents
                    trow["spec"] = spec
            self._usage_append(lease,
                               usage if usage is not None else {},
                               DONE, now)
            if on_commit is not None:
                on_commit()
            self._save(state)
        self._event(self.EV_DONE, item=lease.item_id, host=host,
                    artifacts=len(arts))
        self._event("dag-expand", item=lease.item_id, host=host,
                    created=len(created),
                    retargeted=sorted(retarget or ()))
        reg = self._registry()
        if created and reg is not None:
            reg.counter(
                "dag_fanout_jobs_total",
                "Child jobs dynamically fanned out at a DAG node's "
                "fence-checked commit").inc(len(created))
        return arts

    def dag_view(self, dag_id: str) -> Optional[dict]:
        """Aggregate view of one job graph: every node's ledger view
        plus a graph-level state (failed > running > done)."""
        state = self._load()
        nodes = {jid: self._view(jid, row)
                 for jid, row in self._items(state).items()
                 if row.get("dag") == dag_id}
        if not nodes:
            return None
        states = {v["state"] for v in nodes.values()}
        if FAILED in states:
            agg = FAILED
        elif states == {DONE}:
            agg = DONE
        else:
            agg = "running"
        return {"dag_id": dag_id, "state": agg,
                "counts": {s: sum(1 for v in nodes.values()
                                  if v["state"] == s)
                           for s in sorted(states)},
                "nodes": nodes}

    # -- batch leasing --------------------------------------------------
    def lease_batch(self, host: str, ttl: float, k: int,
                    now: Optional[float] = None) -> List[ItemLease]:
        """Claim up to ``k`` same-bucket pending jobs for ``host`` in
        ONE fenced ledger transaction (the stacked batch executor's
        fleet feeder).  The first grant follows the ordinary deficit-
        WRR policy; the rest are restricted to pending jobs sharing
        the head's bucket hint, with the deficit selection re-applied
        over the tenants that still have matching jobs — every grant
        bumps its tenant's persisted ``served`` counter, so WRR
        fairness is preserved across the batch exactly as across k
        single leases.  Each returned lease carries the SAME epoch
        fence as a single lease: commits land per job, and a zombie's
        late batch commit is fenced per job.  Returns [] when nothing
        is pending; a head without a bucket hint returns just itself.
        """
        now = time.time() if now is None else now
        leases: List[ItemLease] = []
        with self._lock():
            state = self._load()
            h = state["hosts"].get(host)
            if h is not None and not h.get("alive", True):
                h["alive"] = True
                h["epoch"] = int(state["epoch"])
            iid = self._pick_pending(state, now)
            if iid is None:
                self._save(state)
                return []
            items = self._items(state)
            epoch = int(state["epoch"])

            def grant(jid):
                row = items[jid]
                row["state"] = LEASED
                row["owner"] = host
                row["lease_epoch"] = epoch
                row["lease_expires"] = now + ttl
                row["leased_at"] = now
                leases.append(self._make_lease(jid, row, epoch))

            grant(iid)
            hint = items[iid].get("bucket")
            served = state.setdefault("served", {})
            while hint is not None and len(leases) < max(int(k), 1):
                pend: Dict[str, List[str]] = {}
                for jid, row in items.items():
                    if (row["state"] == PENDING
                            and row.get("bucket") == hint
                            and self._leasable(items, row)):
                        pend.setdefault(
                            str(row.get("tenant", DEFAULT_TENANT)),
                            []).append(jid)
                if not pend:
                    break
                tenant = min(
                    pend,
                    key=lambda t: (float(served.get(t, 0))
                                   / self._tenant_cfg(state,
                                                      t)["weight"],
                                   t))
                jid = min(pend[tenant],
                          key=lambda j: (int(items[j].get("priority",
                                                          10)),
                                         float(items[j].get(
                                             "submitted", 0.0)), j))
                served[tenant] = int(served.get(tenant, 0)) + 1
                grant(jid)
            self._save(state)
        for lease in leases:
            self._event(self.EV_LEASE, item=lease.item_id, host=host,
                        epoch=lease.epoch, batch=len(leases))
        return leases

    # -- scheduling policy: weighted round-robin over tenants ----------
    def _pick_pending(self, state: dict,
                      now: float) -> Optional[str]:
        """Deficit-style WRR: among tenants with pending jobs, grant
        to the one with the smallest served/weight ratio (ties break
        by tenant name), then the oldest highest-priority job inside
        that tenant.  `served` counters persist in the ledger so the
        rotation is fleet-wide, not per-replica.

        DAG jobs whose parents have not all landed their fenced
        commits are pending but NOT grantable; children of a failed
        parent are cascaded to terminal failure first (both mutations
        persist with the grant — the caller saves state)."""
        self._cascade_failures(state, now)
        jobs = self._items(state)
        by_tenant: Dict[str, List[str]] = {}
        for jid, row in jobs.items():
            if (row["state"] == PENDING
                    and self._leasable(jobs, row)):
                by_tenant.setdefault(
                    str(row.get("tenant", DEFAULT_TENANT)),
                    []).append(jid)
        if not by_tenant:
            return None
        served = state.setdefault("served", {})
        tenant = min(
            by_tenant,
            key=lambda t: (float(served.get(t, 0))
                           / self._tenant_cfg(state, t)["weight"], t))
        jid = min(by_tenant[tenant],
                  key=lambda j: (int(jobs[j].get("priority", 10)),
                                 float(jobs[j].get("submitted", 0.0)),
                                 j))
        served[tenant] = int(served.get(tenant, 0)) + 1
        return jid

    # -- terminal failure ----------------------------------------------
    def fail_terminal(self, lease: ItemLease, host: str, error: str,
                      now: Optional[float] = None,
                      usage: Optional[dict] = None) -> None:
        """Fence-checked terminal failure: the replica exhausted the
        job's local retry budget (or the spec is unexecutable), so the
        job must stop cycling the fleet.  A fenced-off lease raises
        StaleResultError instead — the fleet already re-admitted the
        job, and this replica's verdict no longer counts."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            why = self._fence_why(row, lease, host)
            if why is not None:
                self._reject_stale(state, lease, host, {}, why)
            row["state"] = FAILED
            row["owner"] = host
            row["lease_epoch"] = None
            row["lease_expires"] = None
            row["error"] = str(error)
            row["completed_epoch"] = int(state["epoch"])
            row["completed_at"] = now
            # settle the downstream subtree NOW (not at the next
            # lease attempt): a drained fleet must not leave a failed
            # node's children pending forever
            self._cascade_failures(state, now)
            # failures meter too (the availability half of an SLO is
            # exactly "terminal failures count against the budget")
            self._usage_append(lease,
                               usage if usage is not None else {},
                               FAILED, now)
            self._save(state)
        self._event("job-failed", item=lease.item_id, host=host,
                    error=str(error))

    # -- introspection --------------------------------------------------
    @staticmethod
    def _view(job_id: str, row: dict) -> dict:
        spec = row.get("spec") or {}
        return {
            "job_id": job_id,
            "state": row["state"],
            "tenant": row.get("tenant", DEFAULT_TENANT),
            "priority": int(row.get("priority", 10)),
            "owner": row.get("owner"),
            "redos": int(row.get("redos", 0)),
            "error": row.get("error", ""),
            "submitted": row.get("submitted", 0.0),
            "artifacts": dict(row.get("artifacts", {})),
            "result": row.get("result"),
            "kind": str(spec.get("kind", "survey") or "survey"),
            "blocked_on": list(row.get("blocked_on") or ()),
            "dag": row.get("dag"),
        }

    def view(self, job_id: str) -> Optional[dict]:
        row = self._load()[self.ITEMS_KEY].get(job_id)
        return None if row is None else self._view(job_id, row)

    def depth(self) -> int:
        """Active fleet depth (pending + leased) — the router's load-
        shedding signal, mirroring the in-process queue's bound."""
        counts = self.counts()
        return counts.get(PENDING, 0) + counts.get(LEASED, 0)

    def lease_owners(self, tenant: Optional[str] = None) \
            -> Dict[str, int]:
        """Replica -> count of currently leased jobs (optionally one
        tenant's only) — the supervisor's preempt-target census: a
        ``preempt_fraction`` supervisor kills replicas holding
        campaign-tenant leases, and the lease reaper + epoch fence
        make that lossless."""
        out: Dict[str, int] = {}
        for row in self._load()[self.ITEMS_KEY].values():
            if row["state"] != LEASED:
                continue
            if (tenant is not None
                    and str(row.get("tenant")) != str(tenant)):
                continue
            owner = row.get("owner")
            if owner:
                out[str(owner)] = out.get(str(owner), 0) + 1
        return out

    def tenant_counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for row in self._load()[self.ITEMS_KEY].values():
            t = str(row.get("tenant", DEFAULT_TENANT))
            st = out.setdefault(t, {PENDING: 0, LEASED: 0, DONE: 0,
                                    FAILED: 0})
            st[row["state"]] = st.get(row["state"], 0) + 1
        return out

    def all_terminal(self) -> bool:
        jobs = self._load()[self.ITEMS_KEY]
        return bool(jobs) and all(j["state"] in (DONE, FAILED)
                                  for j in jobs.values())
