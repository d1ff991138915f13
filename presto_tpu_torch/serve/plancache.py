"""Searcher-plan cache keyed on trial geometry (serve layer).

PyTorch counterpart of ``presto_tpu/serve/plancache.py``.  A resident
service builds each search plan once per *bucket*: jobs are keyed on
(nchan, nsamp, dtype, DM-block shape, zmax, numharm) with the sample
count quantized pad-to-bucket (next power of two), so beams whose raw
lengths differ by a few percent land in the same bucket.  Two layers:

  * ``bucket_key(rawfile, cfg)``: the *scheduling* key the micro-batching
    loop coalesces on (same bucket -> same batch).
  * ``PlanCache`` + ``SearcherProvider``: the *execution* cache.  The
    survey's searcher construction goes through
    ``SurveyConfig.plan_provider``, so same-shaped trial groups across
    jobs share one ``search/accel.AccelSearch`` (its kernel bank, z maps
    and powcuts on the device, and its per-device copies) instead of
    rebuilding them per job.

``PlanStore`` is the persistent tier, one directory per card
fingerprint (tune/db.py): a recipe sidecar of every plan built, merged
under a lock by concurrent services, so a second service on the same
store rebuilds its plans from the recipes.  The executable tier, XLA's
compilation cache in the JAX package, is cuda_build's own build
directory: a kernel library is kept there per source hash across
processes, and a prewarm loads the plans' libraries from it without an
nvcc run once they are built.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class PlanKey:
    """Hashable plan identity.  ``kind`` separates plan families ("job"
    scheduling buckets vs "accel" searcher plans); ``extra`` carries
    family-specific fields (sigma/flo/T for accel)."""
    kind: str
    nchan: int
    nsamp: int
    dtype: str
    dm_block: Tuple
    zmax: int
    numharm: int
    extra: Tuple = ()


#: bucket-edge schemes: the sub-pow2 mantissa steps each admits
_BUCKET_SCHEMES = {
    "pow2": (1.0,),
    "pow2_half": (1.0, 1.5),
    "pow2_quarter": (1.0, 1.25, 1.5, 1.75),
}


def bucket_quantize(n: int, scheme: str = "pow2") -> int:
    """Smallest bucket edge >= n under ``scheme`` (unknown schemes take
    pow2: a coarser bucket, never an undersized one)."""
    n = max(int(n), 1)
    steps = _BUCKET_SCHEMES.get(scheme) or _BUCKET_SCHEMES["pow2"]
    p2 = 1 << (n - 1).bit_length()
    best = p2
    for m in steps:
        edge = int(m * (p2 >> 1))
        if edge >= n and edge < best:
            best = edge
    return best


def quantize_nsamp(n: int) -> int:
    """Pad-to-bucket sample-count quantization: the next power of two,
    or the tuning DB's ``plancache_bucket`` scheme when tuning is
    active.  A scheduling key only: it never changes job outputs."""
    from presto_tpu_torch import tune
    if tune.enabled():
        cfg = tune.best("plancache_bucket", tune.GLOBAL_KEY)
        if cfg:
            return bucket_quantize(n, str(cfg.get("scheme", "pow2")))
    from presto_tpu_torch.utils.psr import next2_to_n
    return int(next2_to_n(max(int(n), 1)))


def dm_block_shape(cfg) -> Tuple:
    """The DM fan-out geometry of a SurveyConfig: (lodm, hidm, nsub)
    fix the DDplan methods for an observation."""
    return (round(float(cfg.lodm), 3), round(float(cfg.hidm), 3),
            int(cfg.nsub))


def bucket_key(rawfiles, cfg) -> PlanKey:
    """Scheduling bucket for a job: observation geometry (the raw
    header) + search geometry (the config)."""
    from presto_tpu_torch.apps.common import open_raw
    paths = [rawfiles] if isinstance(rawfiles, str) else list(rawfiles)
    fb = open_raw(paths)
    hdr = fb.header
    nchan, nsamp, nbits = int(hdr.nchans), int(hdr.N), int(hdr.nbits)
    fb.close()
    return PlanKey(kind="job", nchan=nchan, nsamp=quantize_nsamp(nsamp),
                   dtype="uint%d" % nbits if nbits < 32 else "float32",
                   dm_block=dm_block_shape(cfg),
                   zmax=int(cfg.zmax), numharm=int(cfg.numharm))


@dataclass
class CompiledPlan:
    """A cached plan + bookkeeping.  ``device`` is the plan's device
    (obs/devtel.device_id), so a device error evicts exactly the plans
    bound to that device."""
    key: PlanKey
    obj: Any
    build_seconds: float
    built_at: float
    uses: int = 0
    device: Optional[str] = None


class PlanCache:
    """Thread-safe LRU cache of plans with hit/miss/eviction accounting
    on the shared metrics registry (the /metrics ``plans`` block and the
    ``plancache_*`` Prometheus series are the same counters)."""

    def __init__(self, capacity: int = 32, events=None, obs=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if obs is None:
            from presto_tpu_torch.obs import Observability, ObsConfig
            obs = Observability(ObsConfig(enabled=True))
        self.capacity = capacity
        self.obs = obs
        self._events = events
        self._lock = threading.Lock()  # presto-lint: guards(_plans, _compile_s)
        self._plans: "OrderedDict[PlanKey, CompiledPlan]" = OrderedDict()
        self._compile_s = 0.0
        reg = obs.metrics
        self._c_hits = reg.counter("plancache_hits_total",
                                   "Plan-cache hits")
        self._c_misses = reg.counter("plancache_misses_total",
                                     "Plan-cache misses (compiles)")
        self._c_evict = reg.counter(
            "plancache_evictions_total", "Plan-cache evictions",
            ("reason",))
        self._g_size = reg.gauge("plancache_size",
                                 "Compiled plans resident")

    def get(self, key: PlanKey, builder: Callable[[], Any],
            device: Optional[str] = None) -> Any:
        """The cached plan for ``key``, built (and booked as a compile)
        on first use.  The builder runs outside the lock; two racing
        builders for one key keep the first-inserted plan.  ``device``
        (a devtel.device_id) binds the plan for evict_bucket."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self._c_hits.inc()
                plan.uses += 1
                return plan.obj
            self._c_misses.inc()
        from presto_tpu_torch.obs import devtel
        t0 = time.time()
        obj = builder()
        dt = time.time() - t0
        if device is None:
            device = devtel.current_device_id()
        with self._lock:
            existing = self._plans.get(key)
            if existing is not None:        # lost the build race
                existing.uses += 1
                return existing.obj
            self._compile_s += dt
            self._plans[key] = CompiledPlan(
                key=key, obj=obj, build_seconds=dt, built_at=t0,
                uses=1, device=device)
            self._plans.move_to_end(key)
            while len(self._plans) > self.capacity:
                old_key, _ = self._plans.popitem(last=False)
                self._c_evict.labels(reason="capacity").inc()
                if self._events is not None:
                    self._events.emit("evict", plan=repr(old_key))
            self._g_size.set(len(self._plans))
        devtel.note_compile(self.obs, kind=key.kind, seconds=dt, key=key,
                            device=device)
        if self._events is not None:
            self._events.emit("compile", plan=repr(key), seconds=dt)
        return obj

    def evict_bucket(self, device: Optional[str] = None,
                     reason: str = "device_error") -> int:
        """Flush the plans bound to ``device`` (None: every plan): the
        scheduler's retry path calls this on a device error, so the
        retry rebuilds its plans instead of reusing state on a failed
        device.  Returns the number evicted, each counted under
        ``plancache_evictions_total{reason=...}``."""
        with self._lock:
            doomed = [k for k, p in self._plans.items()
                      if device is None or p.device == device
                      or p.device is None]
            for k in doomed:
                del self._plans[k]
                self._c_evict.labels(reason=reason).inc()
            self._g_size.set(len(self._plans))
        for k in doomed:
            if self._events is not None:
                self._events.emit("plan-evict", plan=repr(k),
                                  reason=reason, device=device or "*")
        self.obs.event("plan-evict", n=len(doomed), reason=reason,
                       device=device or "*")
        return len(doomed)

    def contains(self, key: PlanKey) -> bool:
        with self._lock:
            return key in self._plans

    def stats(self) -> dict:
        hits = int(self._c_hits.value)
        misses = int(self._c_misses.value)
        total = hits + misses
        with self._lock:
            size = len(self._plans)
            compile_s = self._compile_s
        return {
            "size": size,
            "capacity": self.capacity,
            "hits": hits,
            "misses": misses,
            "evictions": int(self._c_evict.total()),
            "compile_s": round(compile_s, 3),
            "hit_rate": (hits / total) if total else 0.0,
        }


def accel_plan_key(acfg, T: float, numbins: int) -> PlanKey:
    """The plan identity of one accel searcher.  T enters the key (it
    scales the z grid and candidate frequencies), so only identical
    trial geometries share a plan."""
    return PlanKey(kind="accel", nchan=0, nsamp=int(numbins),
                   dtype="float32", dm_block=(),
                   zmax=int(acfg.zmax), numharm=int(acfg.numharm),
                   extra=(float(acfg.sigma), float(acfg.flo),
                          round(float(T), 9)))


#: the CUDA kernel libraries a search plan launches
PLAN_LIBRARIES = ("plane_build", "stage_reduce")


class SearcherProvider:
    """The ``SurveyConfig.plan_provider`` adapter: the survey's
    per-trial-group searcher construction through a PlanCache, each plan
    an AccelSearch on the provider's ``device``.  With a PlanStore every
    plan built is recorded (its rebuild recipe lands in the store)."""

    def __init__(self, cache: PlanCache,
                 store: Optional["PlanStore"] = None, device="cuda"):
        self.cache = cache
        self.store = store
        self.device = torch.device(device)

    def searcher(self, acfg, T: float, numbins: int, device=None):
        """Cached AccelSearch for (acfg, T, numbins) on the provider's
        device (a caller's ``device`` must be that device)."""
        from presto_tpu_torch.obs import devtel
        from presto_tpu_torch.search.accel import resolve_device
        dev = resolve_device(self.device)
        if device is not None and resolve_device(device) != dev:
            raise ValueError("plan provider on %s asked for a searcher on "
                             "%s" % (dev, device))
        key = accel_plan_key(acfg, T, numbins)

        def _build():
            from presto_tpu_torch.search.accel import AccelSearch
            s = AccelSearch(acfg, T=T, numbins=numbins, device=dev)
            if self.store is not None:
                self.store.record(key, {
                    "kind": "accel", "acfg": asdict(acfg),
                    "T": float(T), "numbins": int(numbins)})
            return s

        return self.cache.get(key, _build, device=devtel.device_id(dev))

    def prewarm(self, limit: Optional[int] = None) -> int:
        """Rebuild every plan the store knows for this fingerprint into
        the cache, and on a card load the plans' kernel libraries (built
        first when cuda_build's directory does not hold them yet).
        Returns the number of plans warmed; a recipe that does not
        rebuild raises."""
        if self.store is None:
            return 0
        from presto_tpu_torch.search.accel import AccelConfig, \
            resolve_device
        n = 0
        for recipe in self.store.known().values():
            if recipe.get("kind") != "accel":
                continue
            if limit is not None and n >= limit:
                break
            self.searcher(AccelConfig(**recipe["acfg"]),
                          float(recipe["T"]), int(recipe["numbins"]))
            n += 1
        if n and resolve_device(self.device).type == "cuda":
            from presto_tpu_torch import cuda_build
            for name in PLAN_LIBRARIES:
                cuda_build.load(name)
        self.store.note_warm(self.cache)
        return n


# ----------------------------------------------------------------------
# persistent plan tier
# ----------------------------------------------------------------------

#: sidecar schema version (bumping it orphans old recipes)
STORE_SCHEMA = 1


class PlanStore:
    """Persistent plan tier keyed by the card's fingerprint.

      * **The executable tier** is cuda_build's build directory, which
        keeps each kernel library per source hash across processes (a
        change of the sources is a change of the fingerprint's
        kernel_hash).  ``xla_entries`` counts the plan libraries
        (PLAN_LIBRARIES) built there for the current sources (readyz's
        key keeps the JAX package's name).
      * **A plan-recipe sidecar** (``plankeys.json``): every plan built
        is recorded with what rebuilds it (SearcherProvider.prewarm),
        merged atomically under a lock directory so concurrent services
        compose.
    """

    def __init__(self, root: str, fingerprint: Optional[str] = None,
                 obs=None):
        from presto_tpu_torch.tune.db import fingerprint_key
        if obs is None:
            from presto_tpu_torch.obs import Observability, ObsConfig
            obs = Observability(ObsConfig(enabled=True))
        self.obs = obs
        self.fingerprint = fingerprint or fingerprint_key()
        fp_id = hashlib.sha1(self.fingerprint.encode()).hexdigest()[:16]
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, fp_id)
        self.sidecar = os.path.join(self.dir, "plankeys.json")
        from presto_tpu_torch.pipeline.leaseledger import _LockDir
        self._lock = _LockDir(self.sidecar + ".lock")
        self.supported: Optional[bool] = None
        self.enable_error: Optional[str] = None
        reg = obs.metrics
        self._g_warm = reg.gauge(
            "plancache_warm_fraction",
            "Fraction of persistently-known plans resident in the "
            "in-memory cache")
        self._c_prewarmed = reg.counter(
            "plancache_prewarmed_total",
            "Plans rebuilt from the persistent tier at replica start")
        self._g_known = reg.gauge(
            "plancache_store_plans",
            "Plans recorded in the persistent tier sidecar")

    # -- executable tier ------------------------------------------------
    def enable(self) -> bool:
        """The executable tier needs no set-up on the card (cuda_build
        keeps the libraries): marks the store supported."""
        self.supported = True
        return True

    @staticmethod
    def xla_entries() -> int:
        """The plan libraries (PLAN_LIBRARIES) built for the current
        kernel sources."""
        from presto_tpu_torch import cuda_build
        return sum(1 for name in PLAN_LIBRARIES
                   if cuda_build.is_built(name))

    # -- recipe sidecar ------------------------------------------------
    def _load_sidecar(self) -> dict:
        try:
            with open(self.sidecar) as f:
                raw = json.load(f)
            if (isinstance(raw, dict) and raw.get("schema") == STORE_SCHEMA
                    and isinstance(raw.get("plans"), dict)):
                return raw["plans"]
        except (OSError, ValueError):
            pass
        return {}

    def known(self) -> Dict[str, dict]:
        """{plan-key repr: rebuild recipe} recorded for this
        fingerprint."""
        plans = self._load_sidecar()
        self._g_known.set(len(plans))
        return plans

    def record(self, key: PlanKey, recipe: dict) -> None:
        """Merge one rebuild recipe into the sidecar (atomic
        read-modify-replace under the lock)."""
        from presto_tpu_torch.io.atomic import atomic_write_text
        os.makedirs(self.dir, exist_ok=True)
        with self._lock():
            plans = self._load_sidecar()
            plans[repr(key)] = dict(recipe, recorded_at=time.time())
            atomic_write_text(self.sidecar, json.dumps(
                {"schema": STORE_SCHEMA, "plans": plans},
                indent=1, sort_keys=True))
        self._g_known.set(len(plans))

    # -- warm accounting ----------------------------------------------
    @staticmethod
    def _recipe_key(recipe: dict) -> Optional[PlanKey]:
        if recipe.get("kind") != "accel":
            return None
        from presto_tpu_torch.search.accel import AccelConfig
        return accel_plan_key(AccelConfig(**recipe["acfg"]),
                              float(recipe["T"]), int(recipe["numbins"]))

    def warm_fraction(self, cache: PlanCache) -> float:
        """How much of the persistently-known working set is resident in
        ``cache`` (1.0 for an empty store: nothing to wait for)."""
        keys = [k for k in (self._recipe_key(r)
                            for r in self.known().values())
                if k is not None]
        if not keys:
            frac = 1.0
        else:
            frac = (sum(1 for k in keys if cache.contains(k))
                    / float(len(keys)))
        self._g_warm.set(frac)
        return frac

    def note_warm(self, cache: PlanCache) -> None:
        self._c_prewarmed.inc(cache.stats()["size"])
        self.warm_fraction(cache)
