"""serve/plancache: the port's plan cache and plan store against the JAX
package's presto_tpu/serve/plancache.py on the same inputs.

Bucket edges and keys are equal to the JAX package's; the LRU, the hit,
miss and eviction accounting, the device-bound eviction and the store's
recipe sidecar (and its warm fraction) follow the same rules, with the
port's plans an AccelSearch on the provider's device and its executable
tier the kernel libraries cuda_build keeps."""

import json
import os

import numpy as np
import pytest

from presto_tpu.pipeline.survey import SurveyConfig as JSurveyConfig
from presto_tpu.search.accel import AccelConfig as JAccelConfig
from presto_tpu.serve import plancache as jpc

from presto_tpu_torch import cuda_build
from presto_tpu_torch.models import synth
from presto_tpu_torch.obs import Observability, ObsConfig
from presto_tpu_torch.parallel.mesh import Mesh, batch_sharding
from presto_tpu_torch.pipeline.survey import SurveyConfig
from presto_tpu_torch.search.accel import AccelConfig, AccelSearch
from presto_tpu_torch.serve import plancache as pc


@pytest.mark.parametrize("scheme", ["pow2", "pow2_half", "pow2_quarter",
                                    "nonsense"])
def test_bucket_quantize_equals_jax(scheme):
    rng = np.random.default_rng(5)
    for n in list(range(1, 70)) + list(rng.integers(1, 1 << 24, 300)):
        assert pc.bucket_quantize(int(n), scheme) == \
            jpc.bucket_quantize(int(n), scheme), (n, scheme)


def test_quantize_dm_block_and_bucket_key_equal_jax(tmp_path):
    for n in (1, 2, 3, 4095, 4096, 4097, 3 * (1 << 20)):
        assert pc.quantize_nsamp(n) == jpc.quantize_nsamp(n)
    raw = str(tmp_path / "b.fil")
    synth.fake_filterbank_file(raw, 5000, 1e-3, 16, 1400.0, 2.0,
                               synth.FakeSignal(f=10.0, dm=20.0),
                               noise_sigma=2.0, seed=3)
    kw = dict(lodm=10.25, hidm=30.5, nsub=8, zmax=20, numharm=4)
    key = pc.bucket_key(raw, SurveyConfig(**kw))
    jkey = jpc.bucket_key(raw, JSurveyConfig(**kw))
    assert repr(key) == repr(jkey)
    assert pc.dm_block_shape(SurveyConfig(**kw)) == \
        jpc.dm_block_shape(JSurveyConfig(**kw))


def test_accel_plan_key_equals_jax():
    for z, nh, sg, flo, T, nb in ((0, 2, 4.0, 1.0, 8.192, 2048),
                                  (200, 8, 2.0, 0.5, 536.870912, 1 << 21)):
        k = pc.accel_plan_key(AccelConfig(zmax=z, numharm=nh, sigma=sg,
                                          flo=flo), T, nb)
        jk = jpc.accel_plan_key(JAccelConfig(zmax=z, numharm=nh, sigma=sg,
                                             flo=flo), T, nb)
        assert repr(k) == repr(jk)


def _keys(n):
    return [pc.PlanKey("accel", 0, 1000 + i, "float32", (), 0, 2)
            for i in range(n)]


def _jkeys(n):
    return [jpc.PlanKey("accel", 0, 1000 + i, "float32", (), 0, 2)
            for i in range(n)]


def test_cache_lru_hits_misses_evictions_like_jax():
    """The same access sequence gives the same stats, capacity
    evictions included, in both packages."""
    cache, jcache = pc.PlanCache(capacity=3), jpc.PlanCache(capacity=3)
    keys, jkeys = _keys(5), _jkeys(5)
    for i in (0, 1, 2, 0, 3, 4, 0, 1, 1):
        assert cache.get(keys[i], lambda i=i: i) == i
        assert jcache.get(jkeys[i], lambda i=i: i) == i
    a, b = cache.stats(), jcache.stats()
    for k in ("size", "capacity", "hits", "misses", "evictions",
              "hit_rate"):
        assert a[k] == b[k], k
    assert [cache.contains(k) for k in keys] == \
        [jcache.contains(k) for k in jkeys]
    with pytest.raises(ValueError):
        pc.PlanCache(capacity=0)


def test_evict_bucket_by_device():
    """Plans are bound to their device; a device's eviction flushes its
    plans only, each counted under reason device_error, and the event
    log sees each."""
    from presto_tpu_torch.serve.events import EventLog
    events = EventLog()
    cache = pc.PlanCache(capacity=8, events=events)
    keys = _keys(4)
    for i, dev in enumerate(("cuda_0", "cuda_1", "cuda_0", "cpu_0")):
        cache.get(keys[i], lambda: object(), device=dev)
    assert cache.evict_bucket(device="cuda_0") == 2
    assert [cache.contains(k) for k in keys] == [False, True, False, True]
    fam = cache.obs.metrics.get("plancache_evictions_total")
    assert fam.labels(reason="device_error").value == 2
    assert sum(1 for e in events.tail(100)
               if e["kind"] == "plan-evict") == 2
    assert cache.evict_bucket() == 2 and cache.stats()["size"] == 0


def test_searcher_provider_shares_one_plan_and_binds_its_device(tmp_path):
    cache = pc.PlanCache(capacity=4)
    prov = pc.SearcherProvider(cache, device="cpu")
    acfg = AccelConfig(zmax=4, numharm=2)
    s1 = prov.searcher(acfg, 8.192, 2048)
    s2 = prov.searcher(acfg, 8.192, 2048, device="cpu")
    assert s1 is s2 and isinstance(s1, AccelSearch)
    assert s1.device.type == "cpu"
    st = cache.stats()
    assert (st["hits"], st["misses"], st["size"]) == (1, 1, 1)
    assert cache._plans[pc.accel_plan_key(acfg, 8.192, 2048)].device \
        == "cpu_0"
    with pytest.raises(ValueError, match="asked for a searcher"):
        prov.searcher(acfg, 8.192, 2048, device="meta")
    # a compile is booked on the shared registry
    assert cache.obs.metrics.get("jax_compiles_total").labels(
        kind="accel").value == 1


def test_store_sidecar_matches_jax_and_prewarms(tmp_path):
    """The port's sidecar records the JAX package's plan key reprs with
    the same recipe fields; a second provider on the same store rebuilds
    every plan (warm fraction 0 -> 1), and a corrupt sidecar reads as an
    empty (vacuously warm) store."""
    obs = Observability(ObsConfig(enabled=True))
    store = pc.PlanStore(str(tmp_path / "store"), obs=obs)
    jstore = jpc.PlanStore(str(tmp_path / "jstore"), fingerprint="fp")
    assert store.enable() is True and store.supported is True
    prov = pc.SearcherProvider(pc.PlanCache(obs=obs), store=store,
                               device="cpu")
    jprov = jpc.SearcherProvider(jpc.PlanCache(), store=jstore)
    for z, T, nb in ((0, 8.192, 2048), (4, 16.384, 4096)):
        prov.searcher(AccelConfig(zmax=z, numharm=2), T, nb)
        jprov.searcher(JAccelConfig(zmax=z, numharm=2), T, nb)
    known, jknown = store.known(), jstore.known()
    assert sorted(known) == sorted(jknown)
    for k in known:
        for f in ("kind", "T", "numbins"):
            assert known[k][f] == jknown[k][f]
        assert known[k]["acfg"]["zmax"] == jknown[k]["acfg"]["zmax"]
    raw = json.load(open(store.sidecar))
    assert raw["schema"] == pc.STORE_SCHEMA == jpc.STORE_SCHEMA
    cold = pc.SearcherProvider(pc.PlanCache(obs=obs), store=store,
                               device="cpu")
    assert store.warm_fraction(cold.cache) == 0.0
    assert cold.prewarm() == 2
    assert store.warm_fraction(cold.cache) == 1.0
    assert obs.metrics.get("plancache_warm_fraction").value == 1.0
    with open(store.sidecar, "w") as f:
        f.write("{not json")
    assert store.known() == {} and store.warm_fraction(
        pc.PlanCache(obs=obs)) == 1.0


def test_store_counts_the_plan_libraries_built(tmp_path, monkeypatch):
    """The executable tier is cuda_build's build directory: xla_entries
    counts the plan libraries (plane_build, stage_reduce) built there for
    the current sources, and a library outside the plan is not one."""
    build = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_build, "_libs", {})
    store = pc.PlanStore(str(tmp_path / "store"),
                         obs=Observability(ObsConfig(enabled=True)))
    assert store.xla_entries() == 0
    assert cuda_build.load("native_io") is not None
    assert cuda_build.is_built("native_io")
    assert store.xla_entries() == 0
    for name in pc.PLAN_LIBRARIES:
        out = cuda_build._target(name)
        for path in (out, out + ".txt"):
            open(path, "w").close()
    assert store.xla_entries() == len(pc.PLAN_LIBRARIES) == 2
    os.remove(cuda_build._target("stage_reduce") + ".txt")
    assert store.xla_entries() == 1


def test_batch_sharding_ranges():
    mesh = Mesh(("cpu",) * 4)
    assert [r for _d, r in batch_sharding(mesh, 8)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [r for _d, r in batch_sharding(mesh, 6)] == \
        [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert [d for d, _r in batch_sharding(mesh, 3)] == list(mesh.devices)
