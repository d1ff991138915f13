"""presto_tpu_torch.tune: the tuning DB, lookups, the measurement
harness and the search spaces against the JAX package's presto_tpu/tune
on the same inputs.

TuneDB records, merges and loads as the JAX package's; ``best``,
``scoped``, ``stats`` and the provenance file answer the same for the
same entries (each package under its own fingerprint); the runner's
verdicts under one fake clock equal the JAX runner's, an out-of-memory
candidate quarantined; each ported family's candidates equal the JAX
family's, its smoke bench runs on the CPU, and every column slab gives
the same candidate lists."""

import json
import os
import warnings

import pytest
import torch

from presto_tpu import tune as jtune
from presto_tpu.tune import space as jspace
from presto_tpu.tune.db import TuneDB as JTuneDB
from presto_tpu.tune.runner import TuneRunner as JTuneRunner

from presto_tpu_torch import tune
from presto_tpu_torch.obs import Observability, ObsConfig
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.tune import space
from presto_tpu_torch.tune.db import (TuneDB, default_db_path,
                                      device_fingerprint, fingerprint_key,
                                      kernel_source_hash)
from presto_tpu_torch.tune.runner import TuneRunner


@pytest.fixture(autouse=True)
def _reset_tune():
    tune.reset()
    jtune.reset()
    yield
    tune.reset()
    jtune.reset()


def _strip(entries):
    """DB entries without the measurement timestamps."""
    out = json.loads(json.dumps(entries))
    for fams in out.values():
        for shapes in fams.values():
            for rec in shapes.values():
                rec.pop("measured_at", None)
    return out


def test_db_round_trip_and_merge_equal_jax(tmp_path):
    ops = [("fp", "fam", "k1", {"a": 1}, 0.5), ("fp", "fam", "k1", {"a": 2},
                                               0.7),
           ("fp", "fam", "k1", {"a": 3}, 0.2), ("fp2", "g", "*", {"b": 0},
                                               1.0)]
    db, jdb = TuneDB(), JTuneDB()
    for fp, fam, key, cfg, med in ops:
        db.record(fp, fam, key, cfg, med, reps=3)
        jdb.record(fp, fam, key, cfg, med, reps=3)
    assert _strip(db.entries) == _strip(jdb.entries)
    p, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    db.save(p)
    jdb.save(jp)
    other, jother = TuneDB(), JTuneDB()
    other.record("fp", "fam", "k1", {"a": 9}, 0.1)
    jother.record("fp", "fam", "k1", {"a": 9}, 0.1)
    other.save(p)                       # merge-save keeps the best
    jother.save(jp)
    assert _strip(TuneDB.load(p).entries) == _strip(JTuneDB.load(jp).entries)
    assert TuneDB.load(p).lookup("fp", "fam", "k1") == {"a": 9}
    assert TuneDB.load(p).size() == JTuneDB.load(jp).size() == (2, 2)
    for bad in ("{not json", json.dumps({"schema": 99, "entries": {}}),
                json.dumps({"schema": 1, "entries": []})):
        with open(p, "w") as f:
            f.write(bad)
        with open(jp, "w") as f:
            f.write(bad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            d, jd = TuneDB.load(p), JTuneDB.load(jp)
        assert d.entries == jd.entries == {}
        assert (d.load_error is None) == (jd.load_error is None) is False


def test_fingerprint_is_the_cards():
    fp = device_fingerprint()
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert fp["platform"] == want
    assert set(fp) == {"platform", "device_kind", "capability",
                       "device_count", "torch", "cuda", "kernel_hash"}
    assert fp["torch"] == torch.__version__
    assert fp["kernel_hash"] == kernel_source_hash() and \
        len(fp["kernel_hash"]) == 12
    assert fingerprint_key(fp) == fingerprint_key()
    assert "presto_tpu_torch" in default_db_path()
    assert default_db_path() != jtune.default_db_path()


def test_best_scoped_stats_provenance_equal_jax(tmp_path):
    """The same entry under each package's fingerprint: lookups disabled
    by default, enabled by configure() or scoped(); hits, misses, stats
    and the provenance file the same."""
    p, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    db, jdb = TuneDB(), JTuneDB()
    db.record(fingerprint_key(), "serve_batch_geometry", tune.GLOBAL_KEY,
              {"max_stack": 2, "scheme": "pow2"}, 0.01)
    jdb.record(jtune.fingerprint_key(), "serve_batch_geometry",
               jtune.GLOBAL_KEY, {"max_stack": 2, "scheme": "pow2"}, 0.01)
    db.save(p)
    jdb.save(jp)
    for mod, path in ((tune, p), (jtune, jp)):
        mod.configure(db_path=path)
    assert tune.enabled() is False
    assert tune.best("serve_batch_geometry", "*", default={"x": 1}) == \
        jtune.best("serve_batch_geometry", "*", default={"x": 1}) == {"x": 1}
    got = []
    for mod in (tune, jtune):
        with mod.scoped(True):
            got.append((mod.best("serve_batch_geometry", "*"),
                        mod.best("beam_stack_size", "*",
                                 default={"stack": 8}),
                        mod.stats(), mod.provenance()))
        assert mod.enabled() is False
    assert got[0] == got[1]
    assert got[0][0] == {"max_stack": 2, "scheme": "pow2"}
    docs = []
    for mod, d in ((tune, tmp_path / "a"), (jtune, tmp_path / "b")):
        os.makedirs(d)
        assert mod.write_provenance(str(d)) is None     # disabled
        mod.configure(enabled=True, db_path=mod is tune and p or jp)
        path = mod.write_provenance(str(d))
        docs.append(json.load(open(path)))
    assert sorted(docs[0]) == sorted(docs[1])
    assert docs[0]["lookups"] == docs[1]["lookups"]
    assert docs[0]["fingerprint"] == fingerprint_key()


def test_tuned_knobs_are_read(tmp_path):
    """fusion's depths, the plan cache's bucket scheme and the stacked
    batch geometry read their families when tuning is on, and the
    explicit value or the default otherwise."""
    from presto_tpu_torch.serve import plancache
    from presto_tpu_torch.serve.batchexec import resolve_stack_geometry
    p = str(tmp_path / "t.json")
    db = TuneDB()
    fp = fingerprint_key()
    db.record(fp, "pipeline_inflight_depth", "*",
              {"window": 3, "ingest_depth": 4}, 0.1)
    db.record(fp, "plancache_bucket", "*", {"scheme": "pow2_half"}, 1.0)
    db.record(fp, "serve_batch_geometry", "*",
              {"max_stack": 3, "scheme": "pow2"}, 0.1)
    db.save(p)
    assert fusion.resolve_depth() == fusion.DEFAULT_WINDOW_DEPTH
    assert plancache.quantize_nsamp(3000) == 4096
    tune.configure(enabled=True, db_path=p)
    assert fusion.resolve_depth() == 3
    assert fusion.resolve_depth(inflight_depth=20) == 8
    assert fusion.resolve_ingest_depth() == 4
    assert plancache.quantize_nsamp(3000) == 3072
    assert resolve_stack_geometry() == (3, "pow2")
    assert resolve_stack_geometry([1 << 30], budget=2 << 30) == (2, "pow2")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cands(clock, oom_exc):
    def cost(dt):
        def fn():
            clock.t += dt
            return None
        return fn

    def oom():
        raise oom_exc
    return [({"c": 0}, cost(1.0)), ({"c": 1}, cost(0.5)),
            ({"c": 2}, cost(5.0)), ({"c": 3}, oom),
            ({"c": 4}, cost(0.25))]


def test_runner_with_a_fake_clock_equals_jax():
    """Warm-up apart, median-of-k, pruning against the best so far, a
    quarantined out-of-memory candidate: the same verdicts as the JAX
    runner's under one fake clock, and the counters on the handle."""
    obs = Observability(ObsConfig(enabled=True))
    c, jc = _Clock(), _Clock()
    r = TuneRunner(k=3, timer=c, device="cpu", obs=obs)
    jr = JTuneRunner(k=3, timer=jc)
    best, res = r.sweep("fam", "*", _cands(c, torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")))
    jbest, jres = jr.sweep("fam", "*", _cands(jc, RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory")))
    assert best.config == jbest.config == {"c": 4}
    for m, jm in zip(res, jres):
        assert (m.status, m.median_s, m.reps, m.compile_s) == \
            (jm.status, jm.median_s, jm.reps, jm.compile_s)
    assert [m.status for m in res] == ["ok", "ok", "pruned", "oom", "ok"]
    reg = obs.metrics
    assert reg.get("tune_candidates_total").labels(family="fam").value == 5
    assert reg.get("tune_candidates_quarantined_total").labels(
        family="fam").value == 1
    assert reg.get("tune_candidates_pruned_total").labels(
        family="fam").value == 1
    assert reg.get("jax_compiles_total").labels(kind="tune:fam").value == 4


def test_runner_timeout_and_cuda_default():
    c = _Clock()
    r = TuneRunner(k=10, timeout_s=2.5, timer=c, device="cpu")

    def fn():
        c.t += 1.0
    m = r.measure(fn, {"x": 1})
    assert m.status == "timeout" and m.reps == 2 and m.usable
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TuneRunner()


@pytest.mark.parametrize("name", ["pipeline_inflight_depth",
                                  "sharded_inflight_depth",
                                  "serve_batch_geometry", "beam_stack_size",
                                  "plancache_bucket", "oocfft_block"])
def test_family_candidates_equal_jax_and_smoke_bench_runs(name):
    fam, jfam = space.FAMILIES[name], jspace.FAMILIES[name]
    for smoke in (True, False):
        for shape in fam.shapes(smoke):
            assert fam.candidates(shape) == jfam.candidates(shape)
            assert fam.shape_key(shape) == jfam.shape_key(shape)
    shape = fam.shapes(True)[0]
    if fam.score is not None:
        for c in fam.candidates(shape):
            assert fam.score(shape, c) == pytest.approx(
                jfam.score(shape, c), rel=1e-12)
        return
    fam.bench(shape, fam.candidates(shape)[0], "cpu")()


def test_tune_family_records_the_winner():
    db = TuneDB()
    c = _Clock()
    r = TuneRunner(k=2, timer=c, device="cpu")
    out = space.tune_family(space.FAMILIES["plancache_bucket"], r,
                            smoke=True, db=db, fingerprint="fp")
    key, cfg, merit = out[0]
    assert db.lookup("fp", "plancache_bucket", key) == cfg
    out = space.tune_family(space.FAMILIES["serve_batch_geometry"], r,
                            smoke=True, db=db, fingerprint="fp")
    assert db.lookup("fp", "serve_batch_geometry", "*") == out[0][1]
    assert space.resolve(["beam_stack_size"])[0].name == "beam_stack_size"
    with pytest.raises(ValueError, match="unknown tuning family"):
        space.resolve(["harmonic_sum_layout"])


def test_column_slab_family_same_lists_at_every_slab():
    """accel_column_slab, the counterpart of accel_pallas_tile: its
    candidates' searches give the same candidate lists."""
    fam = space.FAMILIES["accel_column_slab"]
    shape = fam.shapes(True)[0]
    assert fam.shape_key(shape) == "numbins=4096,numharm=2,numz=8"
    lists = []
    for cfg in fam.candidates(shape):
        res = fam.bench(shape, cfg, "cpu")()
        lists.append([[(c.r, c.z, c.numharm, c.sigma) for c in t]
                      for t in res])
    assert len(lists) == 2 and lists[0] == lists[1]
    assert any(lists[0])


# ----------------------------------------------------------------------
# presto-tune (apps/tune)
# ----------------------------------------------------------------------

def test_presto_tune_list_and_device_report(tmp_path, capsys, monkeypatch):
    """--list names the port's families (the JAX CLI's line format);
    --device-report prints the card fingerprint (here the CPU's) and
    this fingerprint's DB entries, from --db; PRESTO_TPU_TUNE_DB is never
    read."""
    from presto_tpu_torch.apps import tune as tune_cli
    monkeypatch.setenv("PRESTO_TPU_TUNE_DB", str(tmp_path / "never.json"))
    assert tune_cli.main(["--list"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == sorted(space.FAMILIES)
    db_path = str(tmp_path / "tune.json")
    fp = fingerprint_key()
    db = TuneDB()
    db.record(fp, "plancache_bucket", "*", {"scheme": "pow2"}, 1.0)
    db.save(db_path)
    assert tune_cli.main(["--device-report", "--db", db_path]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["fingerprint"] == device_fingerprint()
    assert rep["fingerprint_key"] == fp
    assert rep["this_device"]["plancache_bucket"]["*"]["config"] == \
        {"scheme": "pow2"}
    assert rep["db_path"] == db_path
    assert not os.path.exists(str(tmp_path / "never.json"))
    # no --db: the port's default path, never the variable's
    assert tune_cli.main(["--device-report"]) == 0
    assert json.loads(capsys.readouterr().out)["db_path"] == \
        default_db_path()
    src = open(tune_cli.__file__).read()
    assert "os.environ" not in src and "getenv" not in src


def test_presto_tune_smoke_on_the_cpu(tmp_path, capsys):
    """--smoke -device cpu sweeps the column slab (the plain versions)
    and a modeled family into a temp DB, keyed by this machine's
    fingerprint; without -device it needs a card."""
    from presto_tpu_torch.apps import tune as tune_cli
    db_path = str(tmp_path / "tune.json")
    rc = tune_cli.main(["--smoke", "-device", "cpu", "--db", db_path,
                        "--families", "accel_column_slab,plancache_bucket"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["device"] == "cpu" and summary["smoke"]
    assert summary["fingerprint"] == fingerprint_key()
    assert set(summary["families"]) == {"accel_column_slab",
                                        "plancache_bucket"}
    db = TuneDB.load(db_path)
    assert db.lookup(fingerprint_key(), "accel_column_slab",
                     "numbins=4096,numharm=2,numz=8")["slab"] in (1024,
                                                                  4096)
    assert db.size() == (1, 2)
    assert tune_cli.main(["--families", "nope", "--db", db_path]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tune_cli.main(["--smoke", "--db", db_path])
