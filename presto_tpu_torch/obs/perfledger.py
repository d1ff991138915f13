"""Fingerprint-keyed, append-only performance ledger (obs layer).

Host copy of ``presto_tpu/obs/perfledger.py`` for the PyTorch port.
Point-in-time measurements say nothing of a *trajectory*; the perf
ledger is the durable time series a regression gate judges against:

    {"schema": 1,
     "episodes": [
       {"run_id": "...", "ts": 1754...,
        "fingerprint": "<tune/db.py card fingerprint>",
        "workload": "smoke" | "full" | ...,
        "source": "chip_smoke.py" | ...,
        "metrics": {
          "<name>": {"median": 1.2e9, "mad": 3.1e7, "k": 5,
                     "unit": "cells/s", "direction": "higher"}}}]}

Rules (the tune/db.py durability discipline):

  * episodes are median-of-k with the median absolute deviation kept
    as the per-episode noise band: the gate's tolerance scales with
    the measurement's own jitter, not a guessed constant;
  * the fingerprint is the comparability boundary: a baseline is only
    ever computed over episodes with the SAME fingerprint + workload
    (a CPU episode never gates a run on the card);
  * appends are merge-appends: re-read disk, union by ``run_id``,
    atomic replace, so concurrent writers compose;
  * loads are defensive: corruption/stale schema degrades to an empty
    ledger with ``load_error`` set and a warning, never a crash.

Two differences from the JAX module, both on purpose: there is no
environment switch, and the default path is the port's cache directory
beside its tuning DB (``~/.cache/presto_tpu_torch/perf_ledger.json``),
never a file of the repository.  Callers pass a path to use any other
file.

``gate()`` compares the newest episode against the rolling baseline
(the median of the previous ``window`` same-fingerprint episodes per
metric) and flags a regression when the direction-adjusted delta
exceeds ``max(rel_tol * baseline, mad_k * noise)``.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import warnings
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

def default_ledger_path() -> str:
    """The port's default ledger path: beside its tuning DB
    (tune/db.default_db_path), outside any checkout."""
    from presto_tpu_torch.tune.db import default_db_path
    return os.path.join(os.path.dirname(default_db_path()),
                        "perf_ledger.json")


# ----------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------

def median(xs) -> float:
    s = sorted(float(x) for x in xs)
    n = len(s)
    if not n:
        raise ValueError("median of nothing")
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def mad(xs) -> float:
    """Median absolute deviation — the robust noise band a couple of
    outlier reps cannot inflate."""
    m = median(xs)
    return median(abs(float(x) - m) for x in xs)


def metric_from_samples(samples, unit: str,
                        direction: str = "higher") -> dict:
    """One episode metric from raw per-rep samples."""
    if direction not in ("higher", "lower"):
        raise ValueError("direction must be 'higher' or 'lower'")
    return {"median": median(samples), "mad": mad(samples),
            "k": len(list(samples)), "unit": unit,
            "direction": direction}


def make_episode(metrics: Dict[str, dict],
                 fingerprint: Optional[str] = None,
                 workload: str = "full",
                 source: str = "bench.py",
                 run_id: Optional[str] = None,
                 meta: Optional[dict] = None) -> dict:
    if fingerprint is None:
        from presto_tpu_torch.tune.db import fingerprint_key
        fingerprint = fingerprint_key()
    ep = {
        "run_id": run_id or uuid.uuid4().hex[:12],
        "ts": time.time(),
        "fingerprint": fingerprint,
        "workload": workload,
        "source": source,
        "metrics": {str(k): dict(v) for k, v in metrics.items()},
    }
    if meta:
        ep["meta"] = dict(meta)
    return ep


def _valid_episode(ep) -> bool:
    return (isinstance(ep, dict) and isinstance(ep.get("run_id"), str)
            and isinstance(ep.get("metrics"), dict)
            and isinstance(ep.get("ts"), (int, float)))


# ----------------------------------------------------------------------
# the ledger
# ----------------------------------------------------------------------

class PerfLedger:
    """In-memory view of a ledger file (episodes sorted by ts;
    ``load_error`` records why a file on disk was unusable)."""

    def __init__(self, episodes: Optional[List[dict]] = None,
                 load_error: Optional[str] = None):
        self.episodes: List[dict] = list(episodes or [])
        self.load_error = load_error

    @classmethod
    def load(cls, path: str) -> "PerfLedger":
        """Defensive load: any structural problem degrades to an
        EMPTY ledger with ``load_error`` set and a warning — a bad
        ledger must never take a run down (the gate turns
        ``load_error`` into an explicit failure instead)."""
        if not os.path.exists(path):
            return cls()
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(
                "perf ledger %s is unreadable (%s) — starting empty"
                % (path, e), RuntimeWarning, stacklevel=2)
            return cls(load_error="unreadable: %s" % e)
        if not isinstance(raw, dict) or \
                raw.get("schema") != SCHEMA_VERSION:
            got = raw.get("schema") if isinstance(raw, dict) else None
            warnings.warn(
                "perf ledger %s has schema %r (want %d) — starting "
                "empty" % (path, got, SCHEMA_VERSION),
                RuntimeWarning, stacklevel=2)
            return cls(load_error="stale schema: %r" % (got,))
        eps = raw.get("episodes")
        if not isinstance(eps, list):
            warnings.warn(
                "perf ledger %s has a malformed episodes list — "
                "starting empty" % path, RuntimeWarning, stacklevel=2)
            return cls(load_error="malformed episodes")
        good = [ep for ep in eps if _valid_episode(ep)]
        led = cls(episodes=good)
        led.episodes.sort(key=lambda e: e["ts"])
        return led

    def merge(self, other: "PerfLedger") -> None:
        """Append-only union by run_id (ts-sorted afterwards) — two
        concurrent writers both land, nothing is ever rewritten."""
        seen = {ep["run_id"] for ep in self.episodes}
        for ep in other.episodes:
            if _valid_episode(ep) and ep["run_id"] not in seen:
                self.episodes.append(ep)
                seen.add(ep["run_id"])
        self.episodes.sort(key=lambda e: e["ts"])

    def append(self, episode: dict) -> None:
        if not _valid_episode(episode):
            raise ValueError("malformed episode")
        self.merge(PerfLedger(episodes=[episode]))

    def save(self, path: str) -> None:
        """Merge-save: fold in whatever is on disk now, then replace
        atomically."""
        from presto_tpu_torch.io.atomic import atomic_write_text
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        on_disk = PerfLedger.load(path)
        merged = PerfLedger(episodes=list(on_disk.episodes))
        merged.merge(self)
        atomic_write_text(path, json.dumps(
            {"schema": SCHEMA_VERSION, "episodes": merged.episodes},
            indent=1, sort_keys=True) + "\n")
        self.episodes = merged.episodes

    # -- selection -----------------------------------------------------

    def select(self, fingerprint: Optional[str] = None,
               workload: Optional[str] = None) -> List[dict]:
        out = []
        for ep in self.episodes:
            if fingerprint is not None and \
                    ep.get("fingerprint") != fingerprint:
                continue
            if workload is not None and \
                    ep.get("workload") != workload:
                continue
            out.append(ep)
        return out


# ----------------------------------------------------------------------
# the regression gate
# ----------------------------------------------------------------------

def rolling_baseline(history: List[dict], metric: str,
                     window: int = 5) -> Optional[dict]:
    """Baseline for one metric over the last ``window`` episodes of
    an already-selected (same fingerprint + workload) history:
    median-of-medians plus the widest recent noise band."""
    rows = [ep["metrics"][metric] for ep in history[-window:]
            if metric in ep.get("metrics", {})]
    rows = [r for r in rows
            if isinstance(r.get("median"), (int, float))]
    if not rows:
        return None
    return {
        "median": median(r["median"] for r in rows),
        "mad": max(float(r.get("mad", 0.0) or 0.0) for r in rows),
        "n": len(rows),
        "unit": rows[-1].get("unit", ""),
        "direction": rows[-1].get("direction", "higher"),
    }


def gate(episode: dict, history: List[dict], window: int = 5,
         rel_tol: float = 0.15, mad_k: float = 4.0) -> dict:
    """Judge ``episode`` against the rolling baseline of ``history``
    (same-fingerprint episodes, EXCLUDING the episode itself).

    A metric regresses when its direction-adjusted delta is worse
    than ``max(rel_tol * |baseline|, mad_k * noise)`` where noise is
    the larger of the baseline's and the episode's MAD bands.
    Returns {"ok": bool, "rows": [...]} with one row per judged
    metric (metrics with no baseline yet are "no-baseline", never a
    failure — the first episodes seed the ledger)."""
    rows = []
    ok = True
    prior = [ep for ep in history
             if ep.get("run_id") != episode.get("run_id")]
    for name, m in sorted(episode.get("metrics", {}).items()):
        value = m.get("median")
        if not isinstance(value, (int, float)):
            continue
        base = rolling_baseline(prior, name, window=window)
        if base is None:
            rows.append({"metric": name, "status": "no-baseline",
                         "value": value, "unit": m.get("unit", "")})
            continue
        direction = m.get("direction", base["direction"])
        noise = max(float(m.get("mad", 0.0) or 0.0), base["mad"])
        threshold = max(rel_tol * abs(base["median"]), mad_k * noise)
        delta = (base["median"] - value if direction == "higher"
                 else value - base["median"])     # >0 == worse
        status = "regression" if delta > threshold else "ok"
        if status == "regression":
            ok = False
        rows.append({
            "metric": name, "status": status,
            "value": value, "baseline": base["median"],
            "delta_worse": delta, "threshold": threshold,
            "noise_band": noise, "baseline_n": base["n"],
            "direction": direction, "unit": m.get("unit", ""),
        })
    return {"ok": ok, "rows": rows}


def inject_slowdown(episode: dict, factor: float) -> dict:
    """A synthetic degraded copy of ``episode`` (rates divided /
    times multiplied by ``factor``) — the deliberate-slowdown proof
    that the gate actually trips."""
    if factor <= 1.0:
        raise ValueError("slowdown factor must be > 1")
    out = json.loads(json.dumps(episode))
    out["run_id"] = "inject-" + uuid.uuid4().hex[:8]
    out["source"] = "inject-slowdown"
    for m in out.get("metrics", {}).values():
        if not isinstance(m.get("median"), (int, float)):
            continue
        if m.get("direction", "higher") == "higher":
            m["median"] = m["median"] / factor
        else:
            m["median"] = m["median"] * factor
    return out
