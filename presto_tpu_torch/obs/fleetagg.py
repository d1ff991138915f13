"""Fleet-wide metric aggregation + cross-process trace joining.

Host copy of ``presto_tpu/obs/fleetagg.py`` for the PyTorch port, on
the port's obs/metrics registry.  The snapshot files are the JAX
package's, so both packages' replicas aggregate together.

The fleet (router + N replicas + the shared job ledger) makes one
process's view a fraction of the story: `/metrics` answered per-replica, a DAG's spans landed in N
unrelated JSONL files, and nothing could answer "what is the fleet's
job p99?".  This module is the aggregation half of the fix:

  * **Snapshots** — each replica periodically publishes its full
    registry state (`MetricsRegistry.export_state`) as one atomic
    file `<fleet>/obs/<replica>.json` (io/atomic, tombstoned on
    graceful drain exactly like heartbeats), so aggregation is a
    lock-free read of small files — no replica RPC, no scrape race.
  * **Merging** — `merge_states` folds N exports into one fleet view:
    counters are summed, gauges become per-replica labeled series
    (a gauge is a point-in-time fact about ONE process), histograms
    are bucket-merged (element-wise bucket counts, summed count/sum,
    sample windows combined as a sorted multiset) so fleet-wide
    nearest-rank p50/p99 equal what a single shared registry would
    have reported.  The merge is associative and commutative over
    canonical states (both, and the single-registry equivalence under
    random shard splits, hold by construction).
  * **Traces** — `load_fleet_spans` joins the per-process
    `*.spans.jsonl` streams under `<fleet>/obs/`; spans carry
    trace/span/parent ids stamped through the ledger
    (`SpanContext.to_dict` on the admitted row), so grouping by
    trace id reconstructs one cross-process timeline per submission
    or DAG — exported as a single Perfetto file by
    `merged_chrome_trace`.
  * **Attribution** — `dag_critical_path` walks a DAG's ledger rows
    (submitted / leased_at / completed_at) to name the node chain
    that gated end-to-end latency and split each node's share into
    lease-wait vs execute time: exactly the per-bucket cost data the
    control plane (predictive admission, drain-time Retry-After)
    consumes — `serve/router.py` quotes Retry-After
    from the `job_e2e_seconds` aggregate here.

Everything reads through forgiving loaders: a torn, missing, or
stale-schema snapshot degrades to "not there", never to a failed
scrape.
"""

from __future__ import annotations

import copy
import glob
import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from presto_tpu_torch.io.atomic import atomic_write_text
from presto_tpu_torch.obs.metrics import _fmt, _label_suffix

#: fleet telemetry directory (snapshots, span streams, dead-replica
#: flight-recorder dumps) inside a fleet working directory
OBS_DIRNAME = "obs"

SNAPSHOT_VERSION = 1

#: assumed publish cadence for snapshots that predate the
#: `interval_s` field (FleetConfig.snapshot_s default)
DEFAULT_SNAPSHOT_INTERVAL = 2.0

#: a live snapshot older than this many publish intervals is STALE:
#: its publisher missed several heartbeat-paced publishes, so its
#: counters under-report and its gauges describe the past —
#: `aggregate()` still merges it (that work happened) but flags it,
#: and /fleet/metrics + presto-report -fleet surface the warning
STALE_INTERVALS = 3.0


def obs_dir(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), OBS_DIRNAME)


def snapshot_path(fleetdir: str, replica: str) -> str:
    return os.path.join(obs_dir(fleetdir), "%s.json" % replica)


def span_stream_path(fleetdir: str, name: str) -> str:
    return os.path.join(obs_dir(fleetdir), "%s.spans.jsonl" % name)


def replica_dump_dir(fleetdir: str, replica: str) -> str:
    """Where a dying replica's flight-recorder dump lands (per
    replica, so the fleet report can attribute it after the ledger
    reaps the host)."""
    return os.path.join(obs_dir(fleetdir), replica)


# ----------------------------------------------------------------------
# snapshot publish / load
# ----------------------------------------------------------------------

def publish_snapshot(fleetdir: str, replica: str, obs,
                     tombstone: bool = False,
                     now: Optional[float] = None,
                     interval: Optional[float] = None) -> str:
    """Atomically publish one replica's full registry state.  A
    tombstone snapshot is the drain-time final word — the metric twin
    of the heartbeat tombstone: aggregation keeps the replica's
    counters (that work happened) but drops its gauges (stale
    point-in-time facts).  ``interval`` records the publisher's
    cadence so `aggregate()` can flag a snapshot that missed
    STALE_INTERVALS publishes as stale."""
    path = snapshot_path(fleetdir, replica)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "version": SNAPSHOT_VERSION,
        "replica": replica,
        "pid": os.getpid(),
        "ts": time.time() if now is None else now,
        "tombstone": bool(tombstone),
        "interval_s": float(interval if interval
                            else DEFAULT_SNAPSHOT_INTERVAL),
        "service": getattr(getattr(obs, "cfg", None), "service",
                           "presto_tpu"),
        "metrics": obs.metrics.export_state(),
    }
    atomic_write_text(path, json.dumps(payload, sort_keys=True) + "\n")
    return path


def load_snapshots(fleetdir: str) -> Dict[str, dict]:
    """{replica: snapshot payload} for every readable snapshot in the
    fleet obs dir (unparseable or wrong-schema files are skipped)."""
    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(obs_dir(fleetdir),
                                              "*.json"))):
        if path.endswith(".spans.jsonl"):
            continue
        try:
            with open(path) as f:
                snap = json.load(f)
            if (not isinstance(snap, dict)
                    or int(snap.get("version", -1))
                    != SNAPSHOT_VERSION
                    or "metrics" not in snap):
                continue
        except (OSError, ValueError):
            continue
        name = str(snap.get("replica")
                   or os.path.splitext(os.path.basename(path))[0])
        out[name] = snap
    return out


# ----------------------------------------------------------------------
# merging
# ----------------------------------------------------------------------

def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def canonicalize(replica: str, state: dict) -> dict:
    """One export_state -> the canonical merged form: gauges gain a
    ``replica`` label, histogram samples become a sorted multiset,
    series are keyed by their full label set.  merge() operates only
    on canonical states, which is what makes it associative."""
    out: Dict[str, dict] = {}
    for name, fam in (state.get("families") or {}).items():
        kind = str(fam.get("kind", "untyped"))
        labelnames = [str(x) for x in fam.get("labelnames") or []]
        ent = {"kind": kind, "help": str(fam.get("help", "")),
               "labelnames": list(labelnames), "series": {}}
        if kind == "gauge" and "replica" not in ent["labelnames"]:
            ent["labelnames"].append("replica")
        if kind == "histogram":
            ent["buckets"] = list(fam.get("buckets") or [])
        for s in fam.get("series") or []:
            labels = dict(s.get("labels") or {})
            if kind == "gauge":
                labels["replica"] = replica
            key = _label_key(labels)
            if kind == "histogram":
                ent["series"][key] = {
                    "labels": labels,
                    "count": int(s.get("count", 0)),
                    "sum": float(s.get("sum", 0.0)),
                    "bucket_counts": (list(s["bucket_counts"])
                                      if s.get("bucket_counts")
                                      is not None else None),
                    "samples": sorted(float(x) for x in
                                      s.get("samples") or []),
                }
            else:
                ent["series"][key] = {"labels": labels,
                                      "value": float(
                                          s.get("value", 0.0))}
        out[name] = ent
    return out


def merge(a: dict, b: dict) -> dict:
    """Merge two canonical states (commutative, associative).
    Counters/histogram totals sum; gauge series are disjoint by
    construction (per-replica labels) and collide to max; histograms
    with mismatched bucket layouts keep count/sum/samples but drop
    the unmergeable bucket counts (percentiles still work — they
    come from the merged sample windows)."""
    out: Dict[str, dict] = {}
    for name in sorted(set(a) | set(b)):
        fa, fb = a.get(name), b.get(name)
        if fa is None or fb is None:
            out[name] = copy.deepcopy(fa if fb is None else fb)
            continue
        if fa["kind"] != fb["kind"]:
            out[name] = copy.deepcopy(fa)
            continue
        ent = {"kind": fa["kind"], "help": fa["help"] or fb["help"],
               "labelnames": list(fa["labelnames"]), "series": {}}
        same_buckets = True
        if fa["kind"] == "histogram":
            same_buckets = (fa.get("buckets") == fb.get("buckets"))
            ent["buckets"] = list(fa.get("buckets") or [])
        for key in sorted(set(fa["series"]) | set(fb["series"])):
            sa, sb = fa["series"].get(key), fb["series"].get(key)
            if sa is None or sb is None:
                merged = copy.deepcopy(sa if sb is None else sb)
            elif fa["kind"] == "histogram":
                bc = None
                if (same_buckets
                        and sa.get("bucket_counts") is not None
                        and sb.get("bucket_counts") is not None):
                    bc = [x + y for x, y in
                          zip(sa["bucket_counts"],
                              sb["bucket_counts"])]
                merged = {
                    "labels": dict(sa["labels"]),
                    "count": sa["count"] + sb["count"],
                    "sum": sa["sum"] + sb["sum"],
                    "bucket_counts": bc,
                    "samples": sorted(sa["samples"] + sb["samples"]),
                }
            elif fa["kind"] == "counter":
                merged = {"labels": dict(sa["labels"]),
                          "value": sa["value"] + sb["value"]}
            else:                       # gauge collision: max wins
                merged = {"labels": dict(sa["labels"]),
                          "value": max(sa["value"], sb["value"])}
            if (fa["kind"] == "histogram" and not same_buckets):
                merged["bucket_counts"] = None
            ent["series"][key] = merged
        out[name] = ent
    return out


def merge_states(states: Dict[str, dict]) -> dict:
    """{replica: export_state} -> one canonical merged state."""
    merged: dict = {}
    for replica in sorted(states):
        merged = merge(merged, canonicalize(replica,
                                            states[replica]))
    return merged


def percentiles(samples: List[float],
                qs=(50, 90, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles — the exact formula
    obs/metrics.HistogramChild.percentiles uses, applied to a merged
    sample multiset."""
    xs = sorted(samples)
    if not xs:
        return {"p%d" % q: 0.0 for q in qs}
    n = len(xs)
    return {"p%d" % q:
            xs[min(n - 1, max(0, (n * q + 99) // 100 - 1))]
            for q in qs}


def to_json(merged: dict) -> Dict[str, dict]:
    """Merged state -> the registry `snapshot()` JSON shape (with
    fleet-wide percentiles computed from the merged windows)."""
    out: Dict[str, dict] = {}
    for name in sorted(merged):
        fam = merged[name]
        series = []
        for key in sorted(fam["series"]):
            s = fam["series"][key]
            entry: dict = {"labels": dict(s["labels"])}
            if fam["kind"] == "histogram":
                pcts = percentiles(s["samples"])
                entry.update({
                    "count": s["count"],
                    "sum": round(s["sum"], 6),
                    "p50": round(pcts["p50"], 6),
                    "p90": round(pcts["p90"], 6),
                    "p99": round(pcts["p99"], 6),
                })
            else:
                entry["value"] = s["value"]
            series.append(entry)
        out[name] = {"type": fam["kind"], "help": fam["help"],
                     "series": series}
    return out


def rollup(merged: dict, name: str,
           label: str) -> Dict[str, dict]:
    """Histogram rollup across every OTHER label: merge the sample
    windows/counts of all series sharing each value of ``label``
    (e.g. job_e2e_seconds by phase, across buckets and replicas).
    The control-plane consumer: one number per phase, fleet-wide."""
    fam = merged.get(name)
    if fam is None or fam["kind"] != "histogram":
        return {}
    acc: Dict[str, dict] = {}
    for s in fam["series"].values():
        v = str(s["labels"].get(label, ""))
        a = acc.setdefault(v, {"count": 0, "sum": 0.0,
                               "samples": []})
        a["count"] += s["count"]
        a["sum"] += s["sum"]
        a["samples"].extend(s["samples"])
    out: Dict[str, dict] = {}
    for v, a in sorted(acc.items()):
        pcts = percentiles(a["samples"])
        out[v] = {"count": a["count"], "sum": round(a["sum"], 6),
                  "p50": round(pcts["p50"], 6),
                  "p90": round(pcts["p90"], 6),
                  "p99": round(pcts["p99"], 6)}
    return out


def counter_rollup(merged: dict, name: str,
                   label: str) -> Dict[str, float]:
    """Counter rollup across every OTHER label: sum the series
    sharing each value of ``label`` (e.g. jax_dispatches_total by
    kind, across replicas) — the fleet-wide per-stage dispatch table
    presto-report renders."""
    fam = merged.get(name)
    if fam is None or fam["kind"] != "counter":
        return {}
    acc: Dict[str, float] = {}
    for s in fam["series"].values():
        v = str(s["labels"].get(label, ""))
        acc[v] = acc.get(v, 0.0) + float(s.get("value", 0.0))
    return dict(sorted(acc.items()))


def render_prometheus(merged: dict) -> str:
    """Prometheus text exposition of a merged state (the
    `GET /fleet/metrics?format=prometheus` body).  Histogram series
    whose bucket layouts could not be merged expose only _sum/_count.
    """
    lines: List[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if fam["help"]:
            lines.append("# HELP %s %s"
                         % (name, fam["help"].replace("\n", " ")))
        lines.append("# TYPE %s %s" % (name, fam["kind"]))
        for key in sorted(fam["series"]):
            s = fam["series"][key]
            labels = tuple(sorted((k, str(v)) for k, v in
                                  s["labels"].items()))
            if fam["kind"] == "histogram":
                if s.get("bucket_counts") is not None:
                    acc = 0
                    buckets = [math.inf if b is None else float(b)
                               for b in fam.get("buckets") or []]
                    for ub, c in zip(buckets, s["bucket_counts"]):
                        acc += c
                        ls = labels + (("le", _fmt(ub)),)
                        lines.append("%s_bucket%s %s"
                                     % (name, _label_suffix(ls),
                                        _fmt(acc)))
                lines.append("%s_sum%s %s"
                             % (name, _label_suffix(labels),
                                _fmt(s["sum"])))
                lines.append("%s_count%s %s"
                             % (name, _label_suffix(labels),
                                _fmt(s["count"])))
            else:
                lines.append("%s%s %s"
                             % (name, _label_suffix(labels),
                                _fmt(s["value"])))
    return "\n".join(lines) + "\n"


def snapshot_is_stale(snap: dict,
                      now: Optional[float] = None) -> bool:
    """A LIVE snapshot older than STALE_INTERVALS publish intervals:
    its publisher stopped publishing without tombstoning (wedged
    heartbeat loop, paused process, dead-but-unreaped replica).  A
    tombstone is never stale — it is the intentional final word."""
    if snap.get("tombstone"):
        return False
    now = time.time() if now is None else now
    interval = float(snap.get("interval_s")
                     or DEFAULT_SNAPSHOT_INTERVAL)
    return now - float(snap.get("ts") or 0.0) \
        > STALE_INTERVALS * interval


def aggregate(fleetdir: str, now: Optional[float] = None) -> dict:
    """One full aggregation pass over a fleet directory: load every
    snapshot, merge (tombstoned replicas keep their counters and
    histograms — that work happened — but contribute no gauges), and
    report per-replica freshness.  Stale snapshots (older than 3x
    their publish interval, not tombstoned) still merge — their
    counters are real work — but are flagged per replica and in the
    top-level ``stale_replicas`` list so consumers see the fleet
    view is partially out of date instead of silently trusting it."""
    now = time.time() if now is None else now
    snaps = load_snapshots(fleetdir)
    states: Dict[str, dict] = {}
    stale: List[str] = []
    for name, snap in snaps.items():
        state = snap.get("metrics") or {}
        if snap.get("tombstone"):
            fams = {n: f for n, f in
                    (state.get("families") or {}).items()
                    if f.get("kind") != "gauge"}
            state = {"families": fams}
        if snapshot_is_stale(snap, now):
            stale.append(name)
        states[name] = state
    return {
        "replicas": {
            name: {"ts": snap.get("ts", 0.0),
                   "pid": snap.get("pid"),
                   "service": snap.get("service"),
                   "tombstone": bool(snap.get("tombstone")),
                   "stale": name in stale,
                   "age_s": round(max(now - float(snap.get("ts")
                                                  or 0.0), 0.0), 3)}
            for name, snap in sorted(snaps.items())},
        "stale_replicas": sorted(stale),
        "merged": merge_states(states),
    }


# ----------------------------------------------------------------------
# cross-process trace joining
# ----------------------------------------------------------------------

def load_spans(paths: Iterable[str]) -> List[dict]:
    """Parse span dicts out of JSONL streams (bad lines skipped)."""
    out: List[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("span_id"):
                        rec.setdefault("_source",
                                       os.path.basename(path))
                        out.append(rec)
        except OSError:
            continue
    return out


def load_fleet_spans(fleetdir: str) -> List[dict]:
    """Every span from every process's stream under <fleet>/obs/."""
    return load_spans(sorted(glob.glob(
        os.path.join(obs_dir(fleetdir), "*.spans.jsonl"))))


def spans_by_trace(spans: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for s in spans:
        out.setdefault(str(s.get("trace_id") or ""), []).append(s)
    for trace in out.values():
        trace.sort(key=lambda s: float(s.get("start", 0.0)))
    return out


def orphan_spans(spans: List[dict]) -> List[dict]:
    """Spans whose parent_id names a span absent from the SAME trace
    — the broken-propagation signal the loadgen `-obs` verdict pins
    to zero."""
    out: List[dict] = []
    for trace in spans_by_trace(spans).values():
        ids = {s["span_id"] for s in trace}
        out += [s for s in trace
                if s.get("parent_id") and s["parent_id"] not in ids]
    return out


def merged_chrome_trace(spans: List[dict]) -> dict:
    """Span dicts from N processes -> one Chrome/Perfetto
    ``trace_event`` document: pid rows per source process, tid rows
    per (pid, thread) — the single timeline a cross-replica DAG
    renders into."""
    tids: Dict[Tuple[int, str], int] = {}
    names: Dict[int, str] = {}
    events = []
    for s in spans:
        pid = int(s.get("pid") or 0)
        names.setdefault(pid, str(s.get("_source", "pid-%d" % pid)))
        tid = tids.setdefault((pid, str(s.get("thread", ""))),
                              len(tids) + 1)
        start = float(s.get("start", 0.0))
        end = float(s.get("end", 0.0)) or start
        events.append({
            "name": s.get("name", "?"),
            "cat": "presto_tpu",
            "ph": "X",
            "ts": start * 1e6,
            "dur": max(end - start, 0.0) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": dict(s.get("attrs") or {},
                         trace_id=s.get("trace_id") or "",
                         span_id=s.get("span_id") or "",
                         parent_id=s.get("parent_id") or "",
                         status=s.get("status", "ok")),
        })
    for pid, label in names.items():
        events.append({"name": "process_name", "ph": "M",
                       "pid": pid, "tid": 0,
                       "args": {"name": label}})
    for (pid, tname), tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_merged_chrome(path: str, spans: List[dict]) -> str:
    atomic_write_text(path,
                      json.dumps(merged_chrome_trace(spans)) + "\n")
    return path


# ----------------------------------------------------------------------
# DAG critical-path attribution
# ----------------------------------------------------------------------

def dag_critical_path(jobs: Dict[str, dict], dag_id: str) -> dict:
    """Walk one DAG's ledger rows into a latency attribution: which
    node chain gated end-to-end latency, and inside each node how
    much was lease wait (submitted/parent-ready -> leased_at) vs
    execution (leased_at -> completed_at).  Pure function over the
    ledger's row dicts (jobs.json \"jobs\" table)."""
    rows = {jid: row for jid, row in jobs.items()
            if row.get("dag") == dag_id}
    if not rows:
        return {}
    done = {jid: row for jid, row in rows.items()
            if row.get("completed_at")}

    def parent_ready(row) -> float:
        ready = float(row.get("submitted") or 0.0)
        for pid in row.get("blocked_on") or ():
            prow = rows.get(pid)
            if prow and prow.get("completed_at"):
                ready = max(ready, float(prow["completed_at"]))
        return ready

    def node_view(jid) -> dict:
        row = rows[jid]
        leased = float(row.get("leased_at") or 0.0)
        completed = float(row.get("completed_at") or 0.0)
        ready = parent_ready(row)
        return {
            "job_id": jid,
            "kind": str((row.get("spec") or {}).get("kind",
                                                    "survey")),
            "state": row.get("state"),
            "wait_s": round(max(leased - ready, 0.0), 6)
            if leased else None,
            "run_s": round(max(completed - leased, 0.0), 6)
            if leased and completed else None,
        }

    submitted = min(float(r.get("submitted") or 0.0)
                    for r in rows.values())
    path: List[str] = []
    if done:
        cur = max(done, key=lambda j: float(done[j]["completed_at"]))
        seen = set()
        while cur and cur not in seen:
            seen.add(cur)
            path.append(cur)
            parents = [p for p in rows.get(cur, {}).get("blocked_on")
                       or () if p in done]
            cur = max(parents,
                      key=lambda p: float(done[p]["completed_at"])) \
                if parents else None
        path.reverse()
    e2e = (max(float(r["completed_at"]) for r in done.values())
           - submitted) if done else None
    nodes = [node_view(jid) for jid in path]
    wait = sum(n["wait_s"] or 0.0 for n in nodes)
    run = sum(n["run_s"] or 0.0 for n in nodes)
    return {
        "dag_id": dag_id,
        "n_nodes": len(rows),
        "n_done": len(done),
        "e2e_s": round(e2e, 6) if e2e is not None else None,
        "critical_path": nodes,
        "wait_s": round(wait, 6),
        "run_s": round(run, 6),
        "wait_share": round(wait / e2e, 4) if e2e else None,
        "run_share": round(run / e2e, 4) if e2e else None,
    }
