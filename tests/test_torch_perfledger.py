"""The port's perf ledger (obs/perfledger) against the JAX package's.

The same inputs give the same statistics (median, MAD, a metric from
samples), the same episodes (run id and timestamp pinned), the same
gate verdicts over seeded histories (higher- and lower-is-better, noisy
and quiet, no baseline, an injected slowdown), the same merge order and
the same saved bytes, and the same defensive loads.  Two differences,
on purpose: the port reads no environment variable, and its default
path is outside the repository, beside its tuning DB."""

import json
import os
import random

import pytest

from presto_tpu.obs import perfledger as jpl

from presto_tpu_torch.obs import perfledger as ppl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _episode(run_id, value, mad=1.0, metric="rate", ts=0.0,
             direction="higher", fingerprint="fp|cuda"):
    return {"run_id": run_id, "ts": float(ts), "fingerprint": fingerprint,
            "workload": "smoke", "source": "test",
            "metrics": {metric: {"median": float(value), "mad": float(mad),
                                 "k": 5, "unit": "x/s",
                                 "direction": direction}}}


@pytest.mark.parametrize("samples", [[3, 1, 2], [4, 1, 3, 2],
                                     [10, 10, 10], [1, 2, 9],
                                     [0.5, 7.25, 3.0, 3.0, 11.0]])
def test_statistics_equal_jax(samples):
    assert ppl.median(samples) == jpl.median(samples)
    assert ppl.mad(samples) == jpl.mad(samples)
    for direction in ("higher", "lower"):
        assert ppl.metric_from_samples(samples, "s", direction) == \
            jpl.metric_from_samples(samples, "s", direction)
    with pytest.raises(ValueError):
        ppl.metric_from_samples(samples, "s", "sideways")


def test_episode_equals_jax():
    metrics = {"rate": ppl.metric_from_samples([1.0, 2.0, 4.0], "x/s"),
               "wall": ppl.metric_from_samples([3.0, 2.5], "s", "lower")}
    kw = dict(fingerprint="fp|cuda", workload="federation",
              source="chip_smoke.py", run_id="r1", meta={"card": "H100"})
    ep, jep = ppl.make_episode(metrics, **kw), jpl.make_episode(metrics, **kw)
    ep["ts"] = jep["ts"] = 1.5
    assert ep == jep


def _history(rng, n, direction, base, noise, mad):
    return [_episode("h%d" % i, base + rng.uniform(-noise, noise),
                     mad=mad, ts=float(i), direction=direction)
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_gate_verdicts_equal_jax(seed):
    """Seeded histories and candidate episodes: the same verdict, rows,
    thresholds and baselines, with every window and tolerance."""
    rng = random.Random(seed)
    direction = ("higher", "lower")[seed % 2]
    base = rng.uniform(1.0, 1000.0)
    hist = _history(rng, rng.randint(0, 8), direction, base,
                    base * rng.uniform(0.0, 0.3), base * rng.uniform(0, 0.1))
    for value in (base, base * 0.5, base * 2.0, base * 1.1):
        ep = _episode("new", value, mad=base * 0.02, ts=99.0,
                      direction=direction)
        for window, rel_tol, mad_k in ((5, 0.15, 4.0), (2, 0.05, 1.0)):
            got = ppl.gate(ep, hist + [ep], window=window, rel_tol=rel_tol,
                           mad_k=mad_k)
            want = jpl.gate(ep, hist + [ep], window=window,
                            rel_tol=rel_tol, mad_k=mad_k)
            assert got == want
        assert ppl.rolling_baseline(hist, "rate") == \
            jpl.rolling_baseline(hist, "rate")
    if hist:
        slow = ppl.inject_slowdown(hist[-1], 2.0)
        jslow = jpl.inject_slowdown(hist[-1], 2.0)
        slow["run_id"] = jslow["run_id"]
        assert slow == jslow
        assert ppl.gate(slow, hist) == jpl.gate(jslow, hist)


def test_merge_save_bytes_and_select_equal_jax(tmp_path):
    """Out-of-order appends, a concurrent writer's episodes on disk, a
    duplicate run id: the same merged order and the same file bytes."""
    eps = [_episode("b", 2.0, ts=2.0), _episode("a", 1.0, ts=1.0),
           _episode("c", 3.0, ts=3.0, fingerprint="fp|cpu")]
    other = [_episode("d", 4.0, ts=1.5), _episode("a", 9.0, ts=9.0)]
    out = {}
    for name, mod in (("port", ppl), ("jax", jpl)):
        path = str(tmp_path / name / "ledger.json")
        mod.PerfLedger(episodes=list(other)).save(path)
        led = mod.PerfLedger()
        for ep in eps:
            led.append(ep)
        led.save(path)
        with open(path, "rb") as f:
            out[name] = f.read()
        loaded = mod.PerfLedger.load(path)
        # the on-disk "a" (a concurrent writer's) is kept, ts order
        assert [e["run_id"] for e in loaded.episodes] == ["d", "b", "c",
                                                          "a"]
        assert loaded.episodes[-1]["ts"] == 9.0
        assert [e["run_id"] for e in loaded.select(
            fingerprint="fp|cuda", workload="smoke")] == ["d", "b", "a"]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("text", ["{not json",
                                  json.dumps({"schema": 99}),
                                  json.dumps({"schema": 1,
                                              "episodes": {}}),
                                  json.dumps({"schema": 1, "episodes": [
                                      {"run_id": 3}, _episode("ok", 1.0)]})])
def test_defensive_loads_equal_jax(tmp_path, text):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write(text)
    with pytest.warns(RuntimeWarning) if "ok" not in text else \
            _no_warning():
        port = ppl.PerfLedger.load(path)
    jax = jpl.PerfLedger.load(path)
    assert port.load_error == jax.load_error
    assert port.episodes == jax.episodes


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_default_path_is_outside_the_repository(monkeypatch):
    """The default sits beside the port's tuning DB, never in the
    checkout; no environment variable moves it, and the module names
    neither the JAX package's switch nor a repository ledger."""
    from presto_tpu_torch.tune.db import default_db_path
    path = ppl.default_ledger_path()
    assert os.path.dirname(path) == os.path.dirname(default_db_path())
    assert not os.path.abspath(path).startswith(ROOT + os.sep)
    assert os.path.basename(path) not in ("PERF_LEDGER.json",
                                          "PERF_LEDGER.jsonl")
    monkeypatch.setenv("PRESTO_TPU_PERF_LEDGER", "/tmp/elsewhere.json")
    assert ppl.default_ledger_path() == path
    src = open(ppl.__file__).read()
    assert "PRESTO_TPU_PERF_LEDGER" not in src
    assert "os.environ" not in src and "getenv" not in src
    assert not hasattr(ppl, "ENV_LEDGER")
