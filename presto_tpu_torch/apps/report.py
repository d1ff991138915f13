"""presto-report: render a human-readable run report from a workdir.

Host copy of ``presto_tpu/apps/report.py`` for the PyTorch port, over
the files the port writes.  One survey (or serve-job) working directory
accumulates several telemetry artifacts — the artifact journal
(`manifest.json`), span exports (`spans.jsonl` / `trace.perfetto.json`),
flight-recorder post-mortems (`flightrec-*.json`), ingest quality
ledgers (`*_quality.json`), tuning provenance (`tuned.json`) and the
analytic kernel-cost book (`kernel_costs.json`, obs/costmodel.py: a
count of each dispatch kind's FLOPs and device bytes, not a compiler's
cost analysis).  This tool folds them into one report:

  python -m presto_tpu_torch.apps.report <workdir>         full report
  python -m presto_tpu_torch.apps.report <workdir> -json   JSON
  python -m presto_tpu_torch.apps.report <workdir> -spans 30

Sections render only when their source file exists, so the tool is
useful on anything from a bare batch run (manifest only) to a chaos
post-mortem (flight recorder + open spans at death).  The roofline
placement takes the card's peaks from `kernel_costs.json` (measured on
the survey host) or from the tuning DB's cached measurement for this
host's card (obs/roofline.py); the report itself runs no device work.

`-fleet DIR` switches to FLEET mode: DIR is a fleet working directory
(the job ledger + `obs/` telemetry), and the report merges the ledger
state, every replica's metric snapshot (fleet-wide `job_e2e_seconds`
percentiles, devtel's dispatch counters and each replica's CUDA kernel
launches), the cross-process span streams joined by trace id
(`obs/fleetagg.py`; `-trace-out` exports them as ONE Perfetto file),
any dead replica's flight-recorder dump (discovered via the ledger's
tombstone/reap host records), the supervisor's registry and decision
timeline, and a per-DAG critical-path breakdown — which node gated
end-to-end latency, lease-wait vs device-execute share.

`-fleet DIR -campaign ID` renders one reprocessing campaign
(serve/campaign.py) from its durable artifacts alone: wave progress,
the live ETA/cost projection, the projection-convergence history
replayed from the settle order, and the campaign's decision event
timeline.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import OrderedDict
from typing import List, Optional


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
    except OSError:
        pass
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return "%.1f %s" % (n, unit)
        n /= 1024.0
    return "%d B" % n


# ----------------------------------------------------------------------
# collectors
# ----------------------------------------------------------------------

def collect(workdir: str) -> dict:
    """Everything the report needs, as one JSON-safe dict."""
    from presto_tpu_torch.obs.flightrec import find_dumps
    info: dict = {"workdir": os.path.abspath(workdir)}

    manifest = _load_json(os.path.join(workdir, "manifest.json"))
    if manifest:
        stages: "OrderedDict[str, dict]" = OrderedDict()
        for rel, ent in sorted(manifest.get("artifacts", {}).items()):
            st = stages.setdefault(str(ent.get("stage", "")) or "?",
                                   {"artifacts": 0, "bytes": 0})
            st["artifacts"] += 1
            st["bytes"] += int(ent.get("size", 0))
        info["manifest"] = {
            "artifacts": len(manifest.get("artifacts", {})),
            "stages": stages,
        }

    spans = _load_jsonl(os.path.join(workdir, "spans.jsonl"))
    if spans:
        info["spans"] = spans
    if os.path.exists(os.path.join(workdir, "trace.perfetto.json")):
        info["perfetto"] = os.path.join(workdir, "trace.perfetto.json")

    dumps = find_dumps(workdir)
    if dumps:
        info["flightrec"] = []
        for p in dumps:
            d = _load_json(p) or {}
            recs = d.get("records", [])
            last_point = ""
            for rec in reversed(recs):
                if rec.get("kind") == "chaos-point":
                    last_point = rec.get("point", "")
                    break
            info["flightrec"].append({
                "path": p,
                "reason": d.get("reason", "?"),
                "ts": d.get("ts", 0.0),
                "records": len(recs),
                "open_spans": [s.get("name", "?")
                               for s in d.get("open_spans", [])],
                "last_kill_point": last_point,
            })

    tuned = _load_json(os.path.join(workdir, "tuned.json"))
    if tuned:
        lookups = tuned.get("lookups", {}) or {}
        fams = {}
        for family, shapes in sorted(lookups.items()):
            hits = sum(1 for v in shapes.values()
                       if v.get("source") == "db")
            fams[family] = {
                "shapes": len(shapes),
                "db_hits": hits,
                "defaults": len(shapes) - hits,
                "configs": {k: v.get("config")
                            for k, v in sorted(shapes.items())
                            if v.get("source") == "db"},
            }
        info["tuning"] = {
            "fingerprint": tuned.get("fingerprint", "?"),
            "db_path": tuned.get("db_path", "?"),
            "db_load_error": tuned.get("db_load_error"),
            "stats": tuned.get("stats", {}),
            "families": fams,
        }

    # kernel observatory: the analytic per-kind cost book + roofline
    # placement (obs/costmodel wrote kernel_costs.json at flush; peaks
    # come from the file when the card's were measured on the survey
    # host, else from the tuning DB's cached peaks for this host's
    # card; none cached renders "(no peaks)" rows)
    from presto_tpu_torch.obs import costmodel as _costmodel
    from presto_tpu_torch.obs import roofline as _roofline
    costs = _costmodel.load_costs(workdir)
    if costs:
        peaks = costs.get("peaks")
        peaks_source = "survey host" if peaks else None
        if not peaks:
            peaks = _roofline.device_peaks(measure=False)
            peaks_source = "tuning DB" if peaks else None
        info["kernel_costs"] = {
            "kinds": costs.get("kinds", {}),
            "unavailable": costs.get("unavailable", {}),
            "peaks": peaks,
            "peaks_source": peaks_source,
            "roofline": _roofline.roofline_rows(costs, peaks),
        }

    quality = sorted(glob.glob(os.path.join(workdir,
                                            "*_quality.json")))
    if quality:
        info["quality"] = []
        for p in quality:
            q = _load_json(p) or {}
            info["quality"].append({
                "path": p,
                "bad_spectra": q.get("bad_spectra", 0),
                "nspectra": q.get("nspectra", 0),
                "scrubbed_samples": q.get("scrubbed_samples", 0),
                "counts": q.get("counts", {}),
            })

    # beam-multiplexer health (stream/beams.py writes beams.json at
    # end of observation: totals + per-beam QoS/veto/hand-off rows)
    beams = _load_json(os.path.join(workdir, "beams.json"))
    if beams:
        info["beams"] = beams
    return info


# ----------------------------------------------------------------------
# fleet mode
# ----------------------------------------------------------------------

def collect_fleet(fleetdir: str,
                  trace_out: Optional[str] = None) -> dict:
    """Everything the FLEET report needs: ledger state, merged
    metric snapshots, cross-process traces, dead-replica flight
    recorder dumps, per-DAG critical paths."""
    from presto_tpu_torch.obs import fleetagg
    from presto_tpu_torch.obs.flightrec import find_dumps
    from presto_tpu_torch.serve.jobledger import JobLedger

    info: dict = {"fleetdir": os.path.abspath(fleetdir)}
    ledger = JobLedger(fleetdir)
    state = ledger.read()
    jobs = state.get("jobs", {})
    counts: dict = {}
    for row in jobs.values():
        counts[row["state"]] = counts.get(row["state"], 0) + 1
    hosts = {}
    for host, h in sorted(state.get("hosts", {}).items()):
        _ts, tombstoned = ledger._hb_record(host)
        hosts[host] = {"alive": bool(h.get("alive", False)),
                       "tombstoned": tombstoned,
                       "addr": h.get("addr")}
    info["ledger"] = {"epoch": int(state.get("epoch", 0)),
                      "jobs": counts, "hosts": hosts,
                      "tenants": state.get("tenants", {})}

    # per-replica metric snapshots -> one fleet-wide registry
    agg = fleetagg.aggregate(fleetdir)
    if agg["replicas"]:
        merged = agg["merged"]
        info["snapshots"] = agg["replicas"]
        info["stale_snapshots"] = agg.get("stale_replicas", [])
        info["job_e2e"] = fleetagg.rollup(merged,
                                          "job_e2e_seconds",
                                          "phase")
        info["latency"] = fleetagg.rollup(merged,
                                          "latency_seconds",
                                          "name")
        # per-stage device-chain dispatch counts (devtel keeps the
        # jax_dispatches_total{kind} name) + the kernel-cost join when
        # any replica booked analytic unit costs
        disp = fleetagg.counter_rollup(merged, "jax_dispatches_total",
                                       "kind")
        if disp:
            flops = fleetagg.counter_rollup(merged,
                                            "kernel_flops_total",
                                            "kind")
            hbm = fleetagg.counter_rollup(merged,
                                          "kernel_hbm_bytes_total",
                                          "kind")
            info["dispatches"] = {
                kind: {"dispatches": n,
                       "flops_total": flops.get(kind),
                       "hbm_bytes_total": hbm.get(kind)}
                for kind, n in disp.items()}

        # the hand-written kernels' launches, booked by each replica
        # at its snapshots (serve/fleet.py)
        launches = fleetagg.counter_rollup(
            merged, "cuda_kernel_launches_total", "kernel")
        if launches:
            info["kernel_launches"] = {
                "merged": {k: int(v) for k, v in launches.items()},
                "replicas": {
                    name: {k: int(v) for k, v in fleetagg.counter_rollup(
                        fleetagg.merge_states({name: snap["metrics"]}),
                        "cuda_kernel_launches_total", "kernel").items()}
                    for name, snap in sorted(
                        fleetagg.load_snapshots(fleetdir).items())}}

    # SLO observatory: device-seconds usage, per-tenant budget/burn,
    # and the advisory /scale signal — recomputed from the durable
    # usage ledger + persisted specs, so the report agrees with the
    # router byte-for-byte (obs/slo.py)
    from presto_tpu_torch.obs import slo as slolib
    usage_rows = ledger.usage.rows()
    now = time.time()
    if usage_rows:
        info["usage"] = slolib.usage_rollup(usage_rows)
    specs = slolib.load_specs(fleetdir)
    evals = {}
    if specs:
        evals = {spec.tenant: slolib.evaluate(spec, usage_rows, now)
                 for spec in specs}
        spark = {}
        for spec in specs:
            w = spec.windows[0]
            spark[spec.tenant] = {
                "window_s": w.fast_s,
                "burn": slolib.burn_series(
                    spec, usage_rows, now, w.fast_s,
                    max(w.fast_s / 4.0, 1e-3), n=16),
            }
        info["slo"] = {"specs": [s.to_dict() for s in specs],
                       "tenants": evals, "sparklines": spark}
    # Fleet supervisor: the on-disk registry + durable decision
    # stream (serve/supervisor.py) — the scaling-episode timeline is
    # rebuilt purely from these artifacts and the usage ledger, the
    # same sources the acceptance harness replays
    from presto_tpu_torch.serve import supervisor as suplib
    sup_reg = suplib.load_registry(fleetdir)
    sup_events = _load_jsonl(suplib.events_path(fleetdir))
    if sup_reg.get("replicas") or sup_events:
        by_kind: dict = {}
        for ev in sup_events:
            k = ev.get("kind", "?")
            by_kind[k] = by_kind.get(k, 0) + 1
        info["supervisor"] = {
            "replicas": sup_reg.get("replicas", {}),
            "events": sup_events,
            "by_kind": by_kind,
        }

    if usage_rows or specs:
        backlog = [row.get("bucket")
                   for row in jobs.values()
                   if row.get("state") in ("pending", "leased")]
        # capacity counts ready NON-DRAINING replicas: a draining
        # replica is already leaving, so counting it would mask
        # pressure (the same clamp the router's /scale applies)
        draining = {name for name, r
                    in sup_reg.get("replicas", {}).items()
                    if r.get("state") == suplib.DRAINING}
        ready = len([h for h in ledger.alive_hosts()
                     if h not in draining])
        info["scale"] = slolib.scale_advice(backlog, usage_rows,
                                            evals, ready, now=now)

    # cross-process traces joined by trace id
    spans = fleetagg.load_fleet_spans(fleetdir)
    if spans:
        traces = fleetagg.spans_by_trace(spans)
        orphans = fleetagg.orphan_spans(spans)
        info["traces"] = {
            "spans": len(spans),
            "processes": len({s.get("pid") for s in spans}),
            "n_traces": len(traces),
            "orphan_spans": len(orphans),
        }
        if trace_out:
            fleetagg.write_merged_chrome(trace_out, spans)
            info["traces"]["merged_perfetto"] = \
                os.path.abspath(trace_out)

    # dead replicas' flight-recorder dumps: the ledger's host table
    # (reaped rows + heartbeat tombstones) says who died; their dumps
    # live under <fleet>/obs/<replica>/
    flight = []
    for host, h in hosts.items():
        for p in find_dumps(fleetagg.replica_dump_dir(fleetdir,
                                                      host)):
            d = _load_json(p) or {}
            recs = d.get("records", [])
            last_point = ""
            for rec in reversed(recs):
                if rec.get("kind") in ("chaos-point",
                                       "fleet-chaos-point"):
                    last_point = rec.get("point", "")
                    break
            flight.append({
                "replica": host,
                "dead": not h["alive"] or h["tombstoned"],
                "path": p,
                "reason": d.get("reason", "?"),
                "records": len(recs),
                "open_spans": [s.get("name", "?")
                               for s in d.get("open_spans", [])],
                "last_kill_point": last_point,
            })
    if flight:
        info["flightrec"] = flight

    # per-DAG critical-path attribution
    from presto_tpu_torch.obs.fleetagg import dag_critical_path
    dag_ids = sorted({row.get("dag") for row in jobs.values()
                      if row.get("dag")})
    if dag_ids:
        info["dags"] = {d: dag_critical_path(jobs, d)
                        for d in dag_ids}
    return info


def render_fleet(info: dict, file=None) -> None:
    out = file or sys.stdout
    w = lambda s="": print(s, file=out)     # noqa: E731
    w("presto-report (fleet): %s" % info["fleetdir"])
    led = info["ledger"]
    w()
    w("Ledger: epoch %d   jobs: %s"
      % (led["epoch"],
         " ".join("%s=%d" % kv for kv in sorted(
             led["jobs"].items())) or "none"))
    for host, h in led["hosts"].items():
        w("  replica %-16s %s%s" % (
            host,
            "alive" if h["alive"] and not h["tombstoned"]
            else "DEAD",
            " (tombstoned)" if h["tombstoned"] else ""))

    for name, snap in (info.get("snapshots") or {}).items():
        w("  snapshot %-15s ts=%s%s%s"
          % (name,
             time.strftime("%H:%M:%S",
                           time.localtime(snap.get("ts", 0))),
             " (tombstone)" if snap.get("tombstone") else "",
             "  !! STALE (%.0fs old, >3x publish interval)"
             % snap.get("age_s", 0.0) if snap.get("stale") else ""))
    if info.get("stale_snapshots"):
        w("  !! %d stale snapshot(s) merged: %s — the fleet view "
          "is partially out of date"
          % (len(info["stale_snapshots"]),
             ", ".join(info["stale_snapshots"])))

    e2e = info.get("job_e2e")
    if e2e:
        w()
        w("Fleet job_e2e_seconds (merged over replicas):")
        for phase, st in e2e.items():
            w("  %-12s n=%-5d p50=%8.3fs  p99=%8.3fs"
              % (phase, st["count"], st["p50"], st["p99"]))

    disp = info.get("dispatches")
    if disp:
        w()
        w("Device dispatches (merged jax_dispatches_total{kind}):")
        for kind, ent in disp.items():
            extra = ""
            if ent.get("flops_total"):
                extra = "  %10.3g FLOP  %s" % (
                    ent["flops_total"],
                    _fmt_bytes(ent.get("hbm_bytes_total") or 0.0))
            w("  %-16s %8d dispatch(es)%s"
              % (kind, int(ent["dispatches"]), extra))

    kl = info.get("kernel_launches")
    if kl:
        w()
        w("CUDA kernel launches (merged cuda_kernel_launches_total"
          "{kernel}): %s" % "  ".join(
              "%s=%d" % kv for kv in sorted(kl["merged"].items())))
        for name, per in kl["replicas"].items():
            w("  replica %-16s %s" % (name, "  ".join(
                "%s=%d" % kv for kv in sorted(per.items())) or "none"))

    usage = info.get("usage")
    if usage:
        w()
        w("Usage (usage.jsonl): %.3f device-seconds over %d "
          "committed job(s)"
          % (usage["total_device_seconds"], usage["total_jobs"]))
        for tenant, ent in usage["tenants"].items():
            w("  %-16s %10.3f dev-s  %4d job(s)  %d failed"
              % (tenant or "(default)", ent["device_seconds"],
                 ent["jobs"], ent["failed"]))
            for bkt, bent in sorted(ent["buckets"].items()):
                w("      bucket %-24s %10.3f dev-s  %d job(s)"
                  % ((bkt or "(none)")[:24],
                     bent["device_seconds"], bent["jobs"]))

    slo_info = info.get("slo")
    if slo_info:
        w()
        w("SLO observatory (slo.json): %d tenant spec(s)"
          % len(slo_info["specs"]))
        for tenant, ev in sorted(slo_info["tenants"].items()):
            w("  %-16s objective=%g%s  events=%d bad=%d  "
              "budget remaining %.1f%%%s"
              % (tenant, ev["objective"],
                 " lat<%gs" % ev["latency_s"]
                 if ev.get("latency_s") else "",
                 ev["events"], ev["bad"],
                 100.0 * ev["budget_remaining"],
                 "  !! ALERT" if ev["alert"] else ""))
            for win in ev["windows"]:
                w("      %-12s burn fast=%-8.2f slow=%-8.2f "
                  "(threshold %g)%s"
                  % (win["window"], win["fast_burn"],
                     win["slow_burn"], win["threshold"],
                     "  ALERTING" if win["alerting"] else ""))
            sp = (slo_info.get("sparklines") or {}).get(tenant)
            if sp and any(sp["burn"]):
                from presto_tpu_torch.obs.slo import sparkline
                w("      burn (trailing %gs windows)  %s  max %.1f"
                  % (sp["window_s"], sparkline(sp["burn"]),
                     max(sp["burn"])))

    scale = info.get("scale")
    if scale:
        w()
        w("Scale advisory: wanted_replicas=%d  (%s)"
          % (scale["wanted_replicas"], scale["reason"]))
        inp = scale["inputs"]
        w("  backlog %d job(s) = %.1f device-s   capacity "
          "%.2f/replica   ready %d   SLO pressure: %s"
          % (inp["backlog_jobs"], inp["backlog_device_seconds"],
             inp["per_replica_capacity"], inp["ready_replicas"],
             ", ".join(inp["slo_pressure"]) or "none"))

    sup = info.get("supervisor")
    if sup:
        w()
        w("Supervisor (supervisor.json + supervisor_events.jsonl):")
        for name, r in sorted(sup["replicas"].items()):
            w("  replica %-16s %-9s pid=%s"
              % (name, r.get("state", "?"), r.get("pid") or "?"))
        if not sup["replicas"]:
            w("  no supervised replicas registered")
        if sup["by_kind"]:
            w("  episode: %d event(s) — %s"
              % (len(sup["events"]),
                 "  ".join("%s=%d" % kv
                           for kv in sorted(sup["by_kind"].items()))))
        # the scaling-episode timeline, rebuilt purely from the
        # durable decision stream: every actuation with the advisory
        # inputs that drove it
        acted = [ev for ev in sup["events"]
                 if ev.get("kind") not in ("supervisor-hold",)]
        if acted:
            w("  timeline (holds elided):")
        for ev in acted[-20:]:
            what = ev.get("kind", "?").replace("supervisor-", "")
            detail = ""
            if ev.get("replica"):
                detail += " %s" % ev["replica"]
            if ev.get("replicas"):
                detail += " %s" % ",".join(ev["replicas"])
            if ev.get("wanted") is not None:
                detail += "  wanted=%s" % ev["wanted"]
            if ev.get("advice_reason"):
                detail += " (%s)" % ev["advice_reason"]
            if ev.get("why"):
                detail += "  why=%s" % ev["why"]
            if ev.get("warmup_s") is not None:
                detail += "  warmup=%.2fs" % ev["warmup_s"]
            w("    %s %-14s%s"
              % (time.strftime("%H:%M:%S",
                               time.localtime(ev.get("ts", 0))),
                 what, detail))
        holds = sup["by_kind"].get("supervisor-hold", 0)
        if holds:
            w("    (+ %d hold(s) withheld by hysteresis/cooldown)"
              % holds)

    tr = info.get("traces")
    if tr:
        w()
        w("Traces: %d spans over %d process(es), %d trace(s), "
          "%d orphan span(s)"
          % (tr["spans"], tr["processes"], tr["n_traces"],
             tr["orphan_spans"]))
        if tr.get("merged_perfetto"):
            w("  merged Perfetto trace: %s "
              "(open at https://ui.perfetto.dev)"
              % tr["merged_perfetto"])

    for fr in info.get("flightrec", []):
        w()
        w("Flight recorder (%s%s): %s"
          % (fr["replica"], " — DEAD" if fr["dead"] else "",
             fr["path"]))
        w("  reason: %s   records: %d" % (fr["reason"],
                                          fr["records"]))
        if fr["last_kill_point"]:
            w("  last kill point: %s" % fr["last_kill_point"])
        if fr["open_spans"]:
            w("  open spans at death: %s"
              % " > ".join(fr["open_spans"]))

    for dag_id, cp in (info.get("dags") or {}).items():
        w()
        w("DAG %s: %d/%d nodes done, e2e %s"
          % (dag_id, cp.get("n_done", 0), cp.get("n_nodes", 0),
             "%.3fs" % cp["e2e_s"] if cp.get("e2e_s") is not None
             else "incomplete"))
        if cp.get("critical_path"):
            w("  critical path (wait %.1f%% / run %.1f%% of e2e):"
              % (100 * (cp.get("wait_share") or 0.0),
                 100 * (cp.get("run_share") or 0.0)))
            for n in cp["critical_path"]:
                w("    %-28s %-7s wait %ss  run %ss"
                  % (n["job_id"], n["kind"],
                     "%7.3f" % n["wait_s"]
                     if n["wait_s"] is not None else "      ?",
                     "%7.3f" % n["run_s"]
                     if n["run_s"] is not None else "      ?"))


# ----------------------------------------------------------------------
# campaign mode
# ----------------------------------------------------------------------

def collect_campaign(fleetdir: str, campaign_id: str) \
        -> Optional[dict]:
    """Everything the CAMPAIGN report needs, rebuilt purely from the
    durable artifacts — the campaign ledger, its event stream, and
    the fleet usage ledger (None for an unknown campaign).  The
    projection-convergence series replays the settle history: after
    each settled observation, what the projected total device-seconds
    was at that instant — converging to the measured total as the
    archive drained."""
    from presto_tpu_torch.serve.campaign import (CampaignConfig,
                                           CampaignDriver, TERMINAL,
                                           events_path,
                                           load_campaign)
    doc = load_campaign(fleetdir, campaign_id)
    if doc is None:
        return None
    drv = CampaignDriver(CampaignConfig(fleetdir=fleetdir,
                                        campaign_id=campaign_id))
    try:
        status = drv.status(doc=doc)
        # device-seconds per observation (usage rows grouped by this
        # campaign's deterministic dag ids)
        dags = {r["dag_id"]: oid
                for oid, r in doc["observations"].items()}
        ds_by_obs: dict = {}
        for urow in drv.ledger.usage.rows():
            oid = dags.get(str(urow.get("dag") or ""))
            if oid is not None:
                ex = float((urow.get("phases") or {}).get("execute")
                           or 0.0)
                ds_by_obs[oid] = ds_by_obs.get(oid, 0.0) + ex
    finally:
        drv.close()
    settle_order = sorted(
        (float(r.get("completed_at", 0.0)), oid)
        for oid, r in doc["observations"].items()
        if r["state"] in TERMINAL)
    total_n = len(doc["observations"])
    series: List[dict] = []
    ds = 0.0
    for k, (ts, oid) in enumerate(settle_order, 1):
        ds += ds_by_obs.get(oid, 0.0)
        mean = ds / k
        series.append({
            "settled": k,
            "observation": oid,
            "device_seconds": round(ds, 6),
            "projected_total_device_seconds":
                round(ds + mean * (total_n - k), 6),
        })
    events = _load_jsonl(events_path(fleetdir, campaign_id))
    by_kind: dict = {}
    for ev in events:
        k = ev.get("kind", "?")
        by_kind[k] = by_kind.get(k, 0) + 1
    return {
        "fleetdir": os.path.abspath(fleetdir),
        "campaign": status,
        "created": doc.get("created"),
        "completed": doc.get("completed"),
        "convergence": series,
        "events": events,
        "by_kind": by_kind,
        "triage": _collect_campaign_triage(fleetdir, doc),
    }


def _collect_campaign_triage(fleetdir: str, doc: dict) \
        -> Optional[dict]:
    """Injection-recall roll-up across a campaign's triage nodes —
    read-only, from each DAG's committed `<dag_id>-triage` result
    summary (None when no observation ran triage).  Recall is only
    aggregated over observations whose traffic carried ground-truth
    sidecars (models/inject.py)."""
    scored = avoided = heur = folds = 0
    injected = recovered = 0
    n_triage = n_fallback = n_truth = 0
    for oid, row in sorted(doc.get("observations", {}).items()):
        dag_id = str(row.get("dag_id") or "")
        if not dag_id:
            continue
        path = os.path.join(fleetdir, "jobs", dag_id + "-triage",
                            "result.json")
        try:
            with open(path) as f:
                res = json.load(f).get("result") or {}
        except (OSError, ValueError):
            continue
        if res.get("mode") == "triage":
            n_triage += 1
        else:
            n_fallback += 1
        scored += int(res.get("scored") or 0)
        avoided += int(res.get("folds_avoided") or 0)
        heur += int(res.get("heuristic_folds") or 0)
        folds += int(res.get("folds") or 0)
        if res.get("injected"):
            n_truth += 1
            injected += int(res["injected"])
            recovered += int(res.get("recovered") or 0)
    if not (n_triage + n_fallback):
        return None
    return {
        "observations": n_triage + n_fallback,
        "learned": n_triage,
        "fallback": n_fallback,
        "scored": scored,
        "heuristic_folds": heur,
        "folds": folds,
        "folds_avoided": avoided,
        "fold_reduction": (heur / folds) if folds else None,
        "with_truth": n_truth,
        "injected": injected,
        "recovered": recovered,
        "recall": (recovered / injected) if injected else None,
    }


def render_campaign(info: dict, file=None) -> None:
    out = file or sys.stdout
    w = lambda s="": print(s, file=out)     # noqa: E731
    st = info["campaign"]
    c = st["counts"]
    w("presto-report (campaign): %s @ %s"
      % (st["campaign_id"], info["fleetdir"]))
    w()
    w("State: %-8s %d observation(s) over %d wave(s) "
      "(wave size %d, tenant %s)"
      % (st["state"], st["observations"], st["waves"],
         st["wave_size"], st["tenant"]))
    w("  done=%d failed=%d admitted=%d admitting=%d pending=%d  "
      "outstanding=%d  yield=%.3f"
      % (c["done"], c["failed"], c["admitted"], c["admitting"],
         c["pending"], st["outstanding"], st["yield"]))
    if info.get("completed") and info.get("created"):
        w("  elapsed %.1fs (created -> completed)"
          % (info["completed"] - info["created"]))

    proj = st.get("projection") or {}
    if proj:
        w()
        w("Projection (measured device-seconds x remaining census):")
        w("  settled %d / remaining %d   measured %.3f dev-s   "
          "mean/obs %s"
          % (proj["settled"], proj["remaining"],
             proj["device_seconds_settled"],
             "%.3f dev-s" % proj["mean_obs_device_seconds"]
             if proj.get("mean_obs_device_seconds") is not None
             else "?"))
        w("  projected total %s   eta %s   throughput %.3g obs/s"
          % ("%.3f dev-s" % proj["projected_total_device_seconds"]
             if proj.get("projected_total_device_seconds")
             is not None else "?",
             "%.1fs" % proj["eta_s"]
             if proj.get("eta_s") is not None else "?",
             proj["throughput_obs_per_s"]))

    tri = info.get("triage")
    if tri:
        w()
        w("Triage (learned fold selection, %d/%d observation(s) "
          "learned, %d fallback):"
          % (tri["learned"], tri["observations"], tri["fallback"]))
        w("  scored %d   folds %d of %d heuristic  (%d avoided%s)"
          % (tri["scored"], tri["folds"], tri["heuristic_folds"],
             tri["folds_avoided"],
             ", %.2fx reduction" % tri["fold_reduction"]
             if tri.get("fold_reduction") else ""))
        if tri["with_truth"]:
            w("  injection recall %s  (%d/%d injected pulsars kept, "
              "%d obs with truth sidecars)"
              % ("%.3f" % tri["recall"]
                 if tri.get("recall") is not None else "?",
                 tri["recovered"], tri["injected"],
                 tri["with_truth"]))

    series = info.get("convergence") or []
    if series:
        w()
        final = series[-1]["device_seconds"]
        w("Projection convergence (replayed from the settle "
          "history; final measured total %.3f dev-s):" % final)
        shown = (series if len(series) <= 8
                 else series[:3] + [None] + series[-4:])
        for row in shown:
            if row is None:
                w("    ...")
                continue
            pt = row["projected_total_device_seconds"]
            err = ((pt - final) / final * 100.0) if final else 0.0
            w("    after %3d settle(s)  projected %10.3f dev-s  "
              "(%+6.1f%% vs final)"
              % (row["settled"], pt, err))

    if info.get("by_kind"):
        w()
        w("Events (campaign_events.jsonl): %d — %s"
          % (len(info["events"]),
             "  ".join("%s=%d" % kv
                       for kv in sorted(info["by_kind"].items()))))
        interesting = [ev for ev in info["events"]
                       if ev.get("kind") not in ("campaign-obs-done",)]
        for ev in interesting[-20:]:
            what = ev.get("kind", "?").replace("campaign-", "")
            detail = ""
            for key in ("observations", "wave", "observation",
                        "factor", "done", "failed", "replica",
                        "outstanding"):
                if ev.get(key) is not None:
                    detail += "  %s=%s" % (key, ev[key])
            w("    %s %-12s%s"
              % (time.strftime("%H:%M:%S",
                               time.localtime(ev.get("ts", 0))),
                 what, detail))


# ----------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------

def render(info: dict, max_spans: int = 15, file=None) -> None:
    out = file or sys.stdout
    w = lambda s="": print(s, file=out)     # noqa: E731
    w("presto-report: %s" % info["workdir"])

    man = info.get("manifest")
    if man:
        w()
        w("Journal (manifest.json): %d verified artifacts"
          % man["artifacts"])
        for stage, st in man["stages"].items():
            w("  %-16s %4d artifacts  %10s"
              % (stage, st["artifacts"], _fmt_bytes(st["bytes"])))
    else:
        w("  (no manifest.json — unjournaled or pre-obs run)")

    spans = info.get("spans") or []
    if spans:
        w()
        total = sum(s.get("duration_s", 0.0) for s in spans)
        w("Spans (spans.jsonl): %d spans, %.2f s total"
          % (len(spans), total))
        slowest = sorted(spans, key=lambda s: -s.get("duration_s", 0))
        for s in slowest[:max_spans]:
            w("  %-32s %9.3f s  [%s]  %s"
              % (s.get("name", "?"), s.get("duration_s", 0.0),
                 s.get("status", "?"), s.get("thread", "")))
        if len(slowest) > max_spans:
            w("  ... %d more (see spans.jsonl)"
              % (len(slowest) - max_spans))
    if info.get("perfetto"):
        w("  Perfetto trace: %s (open at https://ui.perfetto.dev)"
          % info["perfetto"])

    for fr in info.get("flightrec", []):
        w()
        w("Flight recorder: %s" % fr["path"])
        w("  reason: %s   records: %d   at %s"
          % (fr["reason"], fr["records"],
             time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(fr["ts"]))))
        if fr["last_kill_point"]:
            w("  last kill point: %s" % fr["last_kill_point"])
        if fr["open_spans"]:
            w("  open spans at death: %s"
              % " > ".join(fr["open_spans"]))

    tuning = info.get("tuning")
    if tuning:
        w()
        w("Tuning provenance (tuned.json): db=%s"
          % tuning["db_path"])
        w("  fingerprint: %s" % tuning["fingerprint"])
        if tuning.get("db_load_error"):
            w("  !! DB unusable (%s) — every lookup fell back to "
              "defaults" % tuning["db_load_error"])
        st = tuning.get("stats", {})
        w("  lookups: %d hit the DB, %d fell back to defaults"
          % (st.get("hits", 0), st.get("misses", 0)))
        for family, f in sorted(tuning.get("families", {}).items()):
            w("  %-20s %d shape(s): %d tuned, %d default"
              % (family, f["shapes"], f["db_hits"], f["defaults"]))
            for skey, config in sorted(f.get("configs", {}).items()):
                w("      %-24s %s" % (skey, config))

    kc = info.get("kernel_costs")
    if kc:
        w()
        peaks = kc.get("peaks")
        if peaks:
            w("Roofline (kernel_costs.json): peak %.2f GFLOP/s, "
              "%.2f GB/s, ridge %.2f FLOP/B  [peaks: %s]"
              % (peaks["flops_per_s"] / 1e9,
                 peaks["bytes_per_s"] / 1e9,
                 peaks["flops_per_s"] / peaks["bytes_per_s"],
                 kc.get("peaks_source") or "?"))
        else:
            w("Roofline (kernel_costs.json): no device peaks "
              "available — intensities only")
        w("  %-14s %9s %12s %12s %9s %8s  %s"
          % ("kind", "dispatch", "FLOP/disp", "HBMB/disp",
             "FLOP/B", "HBM%", "verdict"))
        for row in kc.get("roofline", []):
            fl, by = (row.get("flops_per_dispatch"),
                      row.get("hbm_bytes_per_dispatch"))
            w("  %-14s %9d %12s %12s %9s %7.1f%%  %s"
              % (row["kind"], row["dispatches"],
                 "%.3g" % fl if fl is not None else "?",
                 _fmt_bytes(by) if by is not None else "?",
                 "%.2f" % row["intensity"]
                 if row.get("intensity") is not None else "?",
                 100.0 * row.get("hbm_share", 0.0),
                 row.get("verdict", "?")))
        kinds = kc.get("kinds") or {}
        w("  analytic totals (obs/costmodel, every dispatch of a kind "
          "at its unit cost):")
        for kind, ent in sorted(kinds.items()):
            if ent.get("flops_total") is None:
                continue
            w("    %-14s %12.4g FLOP  %12s  (%s)"
              % (kind, float(ent["flops_total"]),
                 _fmt_bytes(float(ent.get("hbm_bytes_total") or 0.0)),
                 ent.get("source", "?")))
        dd = next((r for r in kc.get("roofline", [])
                   if r["kind"] == "dedisp"), None)
        if dd is not None:
            w("  dedispersion HBM-byte share: %.1f%% of attributed "
              "traffic (%s over %d dispatches)"
              % (100.0 * dd.get("hbm_share", 0.0),
                 _fmt_bytes(dd.get("hbm_bytes_total", 0.0) or 0.0),
                 dd["dispatches"]))
        for reason, n in sorted((kc.get("unavailable") or {}).items()):
            w("  !! cost model unavailable %dx (%s) — affected kinds "
              "report no unit cost" % (n, reason))

    for q in info.get("quality", []):
        w()
        w("Data quality: %s" % q["path"])
        w("  %d/%d spectra quarantined, %d samples scrubbed"
          % (q["bad_spectra"], q["nspectra"], q["scrubbed_samples"]))
        for reason, n in sorted(q.get("counts", {}).items()):
            w("    %-12s %d" % (reason, n))

    beams = info.get("beams")
    if beams:
        w()
        w("Beam multiplexer (beams.json): %d beams on %s — "
          "%d triggers, %d vetoed, %d hand-off(s), %d replayed"
          % (beams.get("beams", 0), beams.get("host", "?"),
             beams.get("triggers", 0), beams.get("vetoed", 0),
             beams.get("handoffs", 0), beams.get("replayed", 0)))
        lat = beams.get("latency", {})
        w("  %-10s %-9s %8s %8s %6s %8s %8s %4s %9s"
          % ("beam", "state", "spectra", "triggers", "veto",
             "stalled", "dropped", "ho", "p99 ms"))
        for row in beams.get("per_beam", []):
            p = lat.get(row.get("beam", ""), {})
            p99 = p.get("p99") if isinstance(p, dict) else None
            w("  %-10s %-9s %8d %8d %6d %8d %8d %4s %9s"
              % (row.get("beam", "?"), row.get("state", "?"),
                 row.get("spectra", 0), row.get("triggers", 0),
                 row.get("vetoed", 0), row.get("stalled_spectra", 0),
                 row.get("dropped_spectra", 0),
                 "yes" if row.get("handoff") else "-",
                 "%.1f" % (1e3 * p99) if p99 is not None else "-"))


def build_parser():
    p = argparse.ArgumentParser(
        prog="presto-report",
        description="Render a run report from a survey/serve workdir "
                    "(manifest + spans + flight recorder + quality), "
                    "or a whole fleet directory with -fleet.")
    p.add_argument("workdir", nargs="?", default=None,
                   help="Survey or serve-job directory")
    p.add_argument("-fleet", type=str, default=None, metavar="DIR",
                   help="FLEET mode: merge this fleet directory's "
                        "ledger, per-replica metric snapshots, "
                        "cross-process traces, and dead-replica "
                        "flight-recorder dumps into one report with "
                        "per-DAG critical-path attribution")
    p.add_argument("-trace-out", type=str, default=None,
                   metavar="PATH",
                   help="Fleet mode: write the merged cross-process "
                        "Perfetto trace here")
    p.add_argument("-campaign", type=str, default=None,
                   metavar="ID",
                   help="With -fleet: CAMPAIGN mode — render the "
                        "campaign's ledger state, wave progress, "
                        "live ETA/cost projection with its "
                        "convergence history, and the decision "
                        "event timeline")
    p.add_argument("-json", action="store_true",
                   help="Emit the collected report as JSON")
    p.add_argument("-spans", type=int, default=15,
                   help="Slowest spans to list (default 15)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.campaign:
        if not args.fleet or not os.path.isdir(args.fleet):
            print("presto-report: -campaign needs -fleet DIR",
                  file=sys.stderr)
            return 1
        cinfo = collect_campaign(args.fleet, args.campaign)
        if cinfo is None:
            print("presto-report: no campaign %r under %s"
                  % (args.campaign, args.fleet), file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(cinfo, indent=1, sort_keys=True))
        else:
            render_campaign(cinfo)
        return 0
    if args.fleet:
        if not os.path.isdir(args.fleet):
            print("presto-report: no such fleet directory: %s"
                  % args.fleet, file=sys.stderr)
            return 1
        info = collect_fleet(args.fleet, trace_out=args.trace_out)
        if args.json:
            print(json.dumps(info, indent=1, sort_keys=True))
        else:
            render_fleet(info)
        return 0
    if not args.workdir or not os.path.isdir(args.workdir):
        print("presto-report: no such directory: %s" % args.workdir,
              file=sys.stderr)
        return 1
    info = collect(args.workdir)
    if args.json:
        print(json.dumps(info, indent=1, sort_keys=True))
    else:
        render(info, max_spans=args.spans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
