"""The port's developer tools against the JAX package's: perf_gate's
verdicts equal obs/perfledger.gate's on the same episodes, its
deliberate slowdown and a corrupt ledger exit 1, --measure on the CPU
appends one episode to the ledger it is given and nothing else;
trace_merge's merged trace and orphan exit equal the JAX tool's on the
same span streams; profile_accel's spectrum is bench.py's, byte for
byte, and its stages give search()'s candidates; the new modules import
neither jax nor presto_tpu, and the device entry points need a card."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from presto_tpu.obs import perfledger as jledger

from presto_tpu_torch.apps import perf_gate, profile_accel, trace_merge
from presto_tpu_torch.obs import perfledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# perf_gate
# ---------------------------------------------------------------------------

def _history(mod, medians, mad=0.02, direction="higher"):
    """Episodes of one fingerprint, ts increasing, for ledger module mod."""
    eps = []
    for i, m in enumerate(medians):
        ep = mod.make_episode(
            {"rate": {"median": m, "mad": mad, "k": 5, "unit": "x/s",
                      "direction": direction},
             "other": {"median": 10.0 + 0.1 * (i % 2), "mad": 0.0, "k": 5,
                       "unit": "s", "direction": "lower"}},
            fingerprint="fp", workload="smoke", source="test",
            run_id="r%d" % i)
        ep["ts"] = 1000.0 + i
        eps.append(ep)
    return eps


CASES = {
    "steady": ([1.0, 1.01, 0.99, 1.0], {}),
    "regression": ([1.0, 1.0, 1.0, 0.5], {}),
    "seed": ([1.0], {}),
    "lower_is_better": ([1.0, 1.0, 1.0, 1.4], {"window": 2}),
    "tight": ([1.0, 1.0, 1.0, 0.93], {"rel_tol": 0.05, "mad_k": 1.0}),
    "noisy": ([1.0, 1.0, 1.0, 0.8], {"mad_k": 20.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_verdict_equals_jax(case):
    medians, kw = CASES[case]
    direction = "lower" if case == "lower_is_better" else "higher"
    want_hist = _history(jledger, medians, direction=direction)
    got_hist = _history(perfledger, medians, direction=direction)
    want = jledger.gate(want_hist[-1], want_hist, **kw)
    got = perfledger.gate(got_hist[-1], got_hist, **kw)
    assert got == want
    assert perfledger.inject_slowdown(got_hist[-1], 2.0)["metrics"][
        "rate"]["median"] == jledger.inject_slowdown(
            want_hist[-1], 2.0)["metrics"]["rate"]["median"]


def _ledger(tmp_path, medians):
    led = perfledger.PerfLedger(episodes=_history(perfledger, medians))
    path = str(tmp_path / "ledger.json")
    led.save(path)
    return path


def test_cli_gates_and_inject_slowdown_exits_1(tmp_path, capsys):
    path = _ledger(tmp_path, [1.0, 1.02, 0.98, 1.0])
    argv = ["--ledger", path, "--window", "3"]
    assert perf_gate.main(argv + ["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    hist = perfledger.PerfLedger.load(path).episodes
    assert out["verdict"] == perfledger.gate(hist[-1], hist, window=3)
    assert perf_gate.main(argv + ["--smoke"]) == 0
    assert perf_gate.main(argv + ["--inject-slowdown", "2.0"]) == 1
    assert "REGRESSION" in capsys.readouterr().err
    # the JAX tool's verdict on the same file
    jtool = _load_tool("perf_gate")
    assert jtool.main(argv + ["--inject-slowdown", "2.0"]) == 1
    assert jtool.main(argv) == 0


@pytest.mark.parametrize("content", ["{not json", '{"schema": 99}',
                                     '{"schema": 1, "episodes": 3}'])
def test_cli_corrupt_ledger_exits_1(tmp_path, capsys, content):
    path = tmp_path / "ledger.json"
    path.write_text(content)
    with pytest.warns(RuntimeWarning):
        rc = perf_gate.main(["--ledger", str(path)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "unusable" in err and str(path) in err


def test_cli_empty_ledger_exits_1(tmp_path, capsys):
    assert perf_gate.main(["--ledger", str(tmp_path / "none.json")]) == 1
    assert "no episodes" in capsys.readouterr().err


def test_measure_on_the_cpu_appends_one_episode(tmp_path, monkeypatch,
                                                capsys):
    """--measure --device cpu: one smoke episode (both metrics, k = 5,
    keyed by the CPU's fingerprint) in the ledger it was given; nothing
    written in the checkout or under HOME."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    before = sorted(os.listdir(ROOT))
    stamp = os.stat(os.path.join(ROOT, "PERF_LEDGER.json")).st_mtime_ns
    path = str(tmp_path / "ledger.json")
    assert perf_gate.main(["--measure", "--device", "cpu", "--ledger",
                           path]) == 0
    eps = perfledger.PerfLedger.load(path).episodes
    assert len(eps) == 1
    ep = eps[0]
    assert set(ep["metrics"]) == {"smoke_accel_cells_per_sec",
                                  "smoke_dedisp_trials_per_sec"}
    assert all(m["k"] == 5 and m["median"] > 0 and m["unit"]
               for m in ep["metrics"].values())
    assert "platform=cpu" in ep["fingerprint"]
    assert ep["meta"]["device"] == "cpu" and ep["meta"]["smoke"] == \
        perf_gate.SMOKE
    assert "NO BASELINE" in capsys.readouterr().err
    assert sorted(os.listdir(ROOT)) == before
    assert os.stat(os.path.join(ROOT, "PERF_LEDGER.json")).st_mtime_ns \
        == stamp
    assert not os.path.exists(tmp_path / "home")


def test_smoke_contract_is_the_jax_tools():
    assert perf_gate.SMOKE == _load_tool("perf_gate").SMOKE


# ---------------------------------------------------------------------------
# trace_merge
# ---------------------------------------------------------------------------

def _span(tid, sid, parent, name, pid, start, end, thread="main"):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent,
            "name": name, "pid": pid, "thread": thread, "start": start,
            "end": end, "duration_s": end - start, "status": "ok",
            "attrs": {"job": name}}


def _streams(tmp_path, orphan):
    fleet = tmp_path / "fleet"
    obs = fleet / "obs"
    obs.mkdir(parents=True)
    router = [_span("t1", "a", None, "router:admit", 11, 1.0, 1.1),
              _span("t2", "d", None, "router:admit", 11, 2.0, 2.1)]
    rep = [_span("t1", "b", "a", "serve:job", 22, 1.2, 3.0),
           _span("t1", "c", "b", "fleet:search", 22, 1.3, 2.9, "pump"),
           _span("t2", "e", "x" if orphan else "d", "serve:job", 33, 2.2,
                 2.5)]
    for name, spans in (("router", router), ("r1", rep)):
        with open(obs / ("%s.spans.jsonl" % name), "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
            f.write("not json\n")
    return str(fleet)


@pytest.mark.parametrize("orphan", [False, True])
def test_trace_merge_equals_jax(tmp_path, capsys, orphan):
    fleet = _streams(tmp_path, orphan)
    jtool = _load_tool("trace_merge")
    outs = {}
    for name, tool in (("jax", jtool), ("port", trace_merge)):
        out = str(tmp_path / ("%s.perfetto.json" % name))
        rc = tool.main(["-fleet", fleet, "-o", out, "-trace", "t1"])
        text = capsys.readouterr()
        with open(out) as f:
            outs[name] = (rc, json.load(f), text.out.replace(out, "OUT"),
                          text.err)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == (1 if orphan else 0)
    assert len([e for e in outs["port"][1]["traceEvents"]
                if e["ph"] == "X"]) == 5


def test_trace_merge_needs_input(capsys):
    with pytest.raises(SystemExit):
        trace_merge.main([])


# ---------------------------------------------------------------------------
# profile_accel
# ---------------------------------------------------------------------------

def test_accel_input_is_bench_pys():
    import bench
    want = bench.make_accel_input()
    got = profile_accel.make_accel_input()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert profile_accel.ACCEL_T == bench.ACCEL_T
    assert (profile_accel.ACCEL_NUMBINS, profile_accel.ACCEL_ZMAX,
            profile_accel.ACCEL_NUMHARM) == (
        bench.WORKLOAD["accel_numbins"], bench.WORKLOAD["accel_zmax"],
        bench.WORKLOAD["accel_numharm"])
    small = profile_accel.make_accel_input(1 << 15)
    assert small.shape == (1 << 15, 2)
    assert small[12345].tolist() == [300.0, 0.0]


@pytest.mark.parametrize("zmax, numharm", [(20, 2), (200, 8)])
def test_stages_give_the_searchs_candidates(zmax, numharm):
    """At 2^15 bins on the CPU (the plain versions), the stage split's
    candidate list is search()'s, and the tone below 2^15 is found."""
    nbins = 1 << 15
    s = profile_accel.searcher(nbins, zmax, numharm, device="cpu")
    pairs = torch.as_tensor(profile_accel.make_accel_input(nbins))
    st = profile_accel.Stages(s, pairs)
    got = profile_accel._cand_rows(st.candidates())
    want = profile_accel._cand_rows(s.search(pairs))
    assert got == want and len(got) > 0
    assert any(abs(r[1] - 12345) <= 1.0 for r in got)
    b = profile_accel.stage_bounds(st)
    assert b["e2e"]["bytes"] > b["plane_build"]["bytes"] > 0
    assert b["stage_reduce"]["bound_ms"] > 0


def test_bounds_at_the_headline_geometry():
    """The headline's plane is the main path's (208 x 4,239,360, fftlen
    8192), and its kernel bounds are PERF.md's (1.027 ms, 1.058 ms);
    the geometry and counts only, no plane is built."""
    s = profile_accel.searcher(device="cpu")
    st = profile_accel.Stages(s, torch.zeros((1, 2)))
    assert st.m == 2048
    assert (s.numz_pad, st.numr, s.kern.fftlen) == (208, 4239360, 8192)
    assert len(st.start_cols) == 4 and st.slab == 1 << 20
    b = profile_accel.stage_bounds(st)
    assert round(b["plane_build"]["bound_ms"], 3) == 1.027
    assert round(b["stage_reduce"]["bound_ms"], 3) == 1.058


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

SCRIPT = r"""
import sys
import torch
from presto_tpu_torch import lint
from presto_tpu_torch.lint import (atomicwrite, core, fence, imports, locks,
                                   obscoverage, purity)
from presto_tpu_torch.apps import (obs_lint, perf_gate, presto_lint,
                                   profile_accel, trace_merge)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu", "tools"))
assert not bad, bad
assert not torch.cuda.is_available()
for call in (lambda: perf_gate.main(["--measure", "--ledger", sys.argv[1]]),
             lambda: profile_accel.main(["--reps", "1"]),
             lambda: profile_accel.profile(1 << 15, 20, 2, reps=1)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("an entry point ran without CUDA")
try:
    profile_accel.profile(1 << 15, 20, 2, reps=1, device="cpu")
except ValueError as e:
    assert "CUDA" in str(e), e
else:
    raise AssertionError("profile_accel timed on the CPU")
print("DEVTOOLS ISOLATED", len(core.registered_checks()))
"""


def test_new_modules_stand_alone_and_need_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
               HOME=str(tmp_path))
    ledger = str(tmp_path / "ledger.json")
    r = subprocess.run([sys.executable, "-c", SCRIPT, ledger], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DEVTOOLS ISOLATED 7" in r.stdout
    assert not os.path.exists(ledger)
