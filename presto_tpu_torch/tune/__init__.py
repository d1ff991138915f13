"""presto_tpu_torch.tune: device-aware tuning with a persistent DB.

PyTorch counterpart of ``presto_tpu/tune/__init__.py``.  The knobs of the
port's hot paths that partition work or pick an execution geometry
(the in-flight depths of the fused survey, the stacked serve batch
geometry, the beam multiplexer's stack, the plan cache's bucket edges,
the search's column slab) are per-card tuning parameters:

  * :mod:`tune.space`  declarative search spaces per family, with shape
    keys so results generalize across observations;
  * :mod:`tune.runner` the on-card measurement harness (CUDA events,
    warm-up apart, median-of-k, pruning, out-of-memory quarantine);
  * :mod:`tune.db`     the persistent DB keyed by the card's fingerprint;
  * :func:`best`       the lookup the integration points consult.

Lookups are opt-in (``SurveyConfig.tune`` or ``configure(enabled=
True)``; there is no environment switch) and performance-only: every
tuned knob changes overlap or partitioning, never arithmetic, so a
tuned run's outputs are byte-identical to an untuned run's.  A
corrupted or absent DB reads as the built-in defaults with a warning.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from presto_tpu_torch.tune.db import (TuneDB, default_db_path,
                                device_fingerprint, fingerprint_key)

__all__ = [
    "enabled", "configure", "scoped", "best", "stats", "provenance",
    "write_provenance", "reset", "shape_key", "pow2_bucket",
    "key_accel_tile", "key_harm_layout", "key_dedisp_batch",
    "GLOBAL_KEY", "TuneDB", "default_db_path", "device_fingerprint",
    "fingerprint_key",
]

#: shape key for families whose best config is observation-independent
GLOBAL_KEY = "*"


# ----------------------------------------------------------------------
# shape keys
# ----------------------------------------------------------------------

def pow2_bucket(n: int) -> int:
    """Round up to the next power of two (generalization bucket for
    size-like shape dimensions)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def shape_key(**fields) -> str:
    """Canonical 'k=v,k2=v2' string over sorted field names."""
    return ",".join("%s=%s" % (k, fields[k]) for k in sorted(fields))


def key_accel_tile(numz: int, numharm: int, slab: int) -> str:
    """Shape key for the search's column slab (search/accel
    .reference_tile): plane rows (8-padded), harmonic count, and the
    pow2-bucketed slab width."""
    return shape_key(numz=-(-int(numz) // 8) * 8, numharm=int(numharm),
                     slab=pow2_bucket(slab))


def key_harm_layout(numz: int, numharm: int) -> str:
    """Shape key for the harmonic-sum engine choice."""
    return shape_key(numz=-(-int(numz) // 8) * 8, numharm=int(numharm))


def key_dedisp_batch(nsub: int) -> str:
    """Shape key for the dedispersion DM-batch unroll bound: the
    subband count (pow2-bucketed) fixes the per-row slice count."""
    return shape_key(nsub=pow2_bucket(nsub))


# ----------------------------------------------------------------------
# process state: enable override, cached DB, lookup provenance
# ----------------------------------------------------------------------

_lock = threading.Lock()
_enabled_override: Optional[bool] = None
_db_path_override: Optional[str] = None
_db_cache: dict = {}      # path -> (mtime_or_None, TuneDB)
_fp_cache: Optional[str] = None
_stats = {"hits": 0, "misses": 0, "load_errors": 0}
_provenance: Dict[str, Dict[str, dict]] = {}


def enabled() -> bool:
    """True when tuning-DB lookups are active: configure(enabled=True)
    or a SurveyConfig.tune scope (off by default; no environment
    switch)."""
    return bool(_enabled_override)


def configure(enabled: Optional[bool] = None,
              db_path: Optional[str] = None) -> None:
    """Set process-wide overrides (None = off, the default path)."""
    global _enabled_override, _db_path_override
    with _lock:
        _enabled_override = enabled
        if db_path is not None or enabled is None:
            _db_path_override = db_path
        _db_cache.clear()


class scoped:
    """Context manager: override the enable switch for a block (the
    SurveyConfig.tune wiring), restoring the previous override."""

    def __init__(self, enabled: Optional[bool]):
        self._want = enabled

    def __enter__(self):
        global _enabled_override
        self._prev = _enabled_override
        if self._want is not None:
            _enabled_override = bool(self._want)
        return self

    def __exit__(self, *exc):
        global _enabled_override
        _enabled_override = self._prev
        return False


def reset() -> None:
    """Drop all process state (tests)."""
    global _enabled_override, _db_path_override, _fp_cache
    with _lock:
        _enabled_override = None
        _db_path_override = None
        _fp_cache = None
        _db_cache.clear()
        _stats.update(hits=0, misses=0, load_errors=0)
        _provenance.clear()


def _resolve_db_path() -> str:
    return _db_path_override or default_db_path()


def _get_db() -> TuneDB:
    """The cached DB for the current path, reloaded when the file's
    mtime changes (a tuner may repopulate it mid-process)."""
    path = _resolve_db_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    with _lock:
        cached = _db_cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
    db = TuneDB.load(path)
    with _lock:
        if db.load_error is not None:
            _stats["load_errors"] += 1
        _db_cache[path] = (mtime, db)
    _note_load_error(db)
    return db


def _note_load_error(db: TuneDB) -> None:
    if db.load_error is None:
        return
    try:
        from presto_tpu_torch.obs import get_obs
        get_obs().metrics.counter(
            "tune_db_load_errors_total",
            "Tuning-DB files that failed to load (fell back to "
            "defaults)").inc()
    except Exception:
        pass


def _fingerprint() -> str:
    global _fp_cache
    if _fp_cache is None:
        _fp_cache = fingerprint_key(device_fingerprint())
    return _fp_cache


# ----------------------------------------------------------------------
# the lookup
# ----------------------------------------------------------------------

def best(family: str, shape_key: str,
         default: Optional[dict] = None,
         obs=None) -> Optional[dict]:
    """The tuned config for (family, shape_key) on this device, or
    ``default`` when tuning is disabled, the DB has no matching entry,
    or the DB failed to load.  Counts tune_db_hits_total /
    tune_db_misses_total and records lookup provenance for
    presto-report."""
    if not enabled():
        return default
    cfg = _get_db().lookup(_fingerprint(), family, shape_key)
    hit = cfg is not None
    with _lock:
        _stats["hits" if hit else "misses"] += 1
        fam = _provenance.setdefault(family, {})
        if shape_key not in fam or (hit and
                                    fam[shape_key]["source"] != "db"):
            fam[shape_key] = {
                "source": "db" if hit else "default",
                "config": dict(cfg) if hit else
                          (dict(default) if default else None),
            }
    _count(obs, hit, family)
    return cfg if hit else default


def _count(obs, hit: bool, family: str) -> None:
    try:
        if obs is None:
            from presto_tpu_torch.obs import get_obs
            obs = get_obs()
        if not obs.enabled:
            return
        if hit:
            obs.metrics.counter(
                "tune_db_hits_total", "Tuning-DB lookup hits",
                ("family",)).labels(family=family).inc()
        else:
            obs.metrics.counter(
                "tune_db_misses_total",
                "Tuning-DB lookups that fell back to defaults",
                ("family",)).labels(family=family).inc()
    except Exception:
        pass


def stats() -> dict:
    """Process-lifetime lookup counters (independent of obs)."""
    with _lock:
        return dict(_stats)


def provenance() -> Dict[str, Dict[str, dict]]:
    """{family: {shape_key: {source: 'db'|'default', config}}} for
    every lookup this process has made while tuning was enabled."""
    with _lock:
        return {fam: {k: dict(v) for k, v in shapes.items()}
                for fam, shapes in _provenance.items()}


def write_provenance(workdir: str, extra: Optional[dict] = None) -> \
        Optional[str]:
    """Drop <workdir>/tuned.json describing which families hit the DB
    vs fell back to defaults (consumed by presto-report).  Never
    raises; returns the path written or None."""
    if not enabled():
        return None
    try:
        import json
        from presto_tpu_torch.io.atomic import atomic_write_text
        path = os.path.join(workdir, "tuned.json")
        doc = {
            "fingerprint": _fingerprint(),
            "db_path": _resolve_db_path(),
            "db_load_error": _get_db().load_error,
            "stats": stats(),
            "lookups": provenance(),
        }
        if extra:
            doc.update(extra)
        atomic_write_text(path, json.dumps(doc, indent=1,
                                           sort_keys=True))
        return path
    except Exception:
        return None
