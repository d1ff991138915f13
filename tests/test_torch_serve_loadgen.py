"""The port's serve_loadgen (presto_tpu_torch/apps/serve_loadgen.py)
against the JAX package's tools/serve_loadgen.py on the CPU.

make_beams writes the JAX tool's bytes; run_loadgen against an
in-process port service (device="cpu") finishes every job and its
report has the JAX report's keys (the JAX tool's own run_loadgen, a pure
HTTP client, run against the same service); the -stacked arms at N = 1,
2 give the same digests stacked and per-job, the reference's, and the
verdict's checks have the JAX record's keys; -commit writes under
records/torch/ and leaves the JAX record untouched; every JAX flag is a
flag of the port's CLI, beside -device, and without a card the CLI
raises.  The heavy verdict modes (-dag, -obs, -slo, -supervisor,
-campaign) are held here through the pieces they assemble their checks
from, and whole only on the card (chip_smoke.py --loadgen-only)."""

import ast
import hashlib
import importlib.util
import json
import os
import random

import pytest
import torch

from presto_tpu_torch.apps import serve_loadgen as slg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "serve_loadgen.py")


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location("jax_serve_loadgen",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("geom", [dict(nsamp=4096, nchan=8),
                                  dict(nsamp=2048, nchan=16, f0=17.0,
                                       dm=30.0)])
def test_make_beams_bytes_equal_jax(tmp_path, jtool, geom):
    """Two beams (seeds 100 and 101) at two geometries, byte for byte."""
    got = slg.make_beams(str(tmp_path / "port"), 2, **geom)
    want = jtool.make_beams(str(tmp_path / "jax"), 2, **geom)
    assert [os.path.relpath(p, str(tmp_path / "port")) for p in got] == \
        [os.path.relpath(p, str(tmp_path / "jax")) for p in want]
    assert [_sha(p) for p in got] == [_sha(p) for p in want]
    assert _sha(got[0]) != _sha(got[1])


def test_run_loadgen_on_a_port_service(tmp_path, jtool):
    """run_loadgen against an in-process port service on the CPU
    finishes every job; its report has the keys of the JAX tool's
    report on the same service."""
    from presto_tpu_torch.serve.server import SearchService, start_http
    beams = slg.make_beams(str(tmp_path), 2, nsamp=4096)
    svc = SearchService(str(tmp_path / "serve"), device="cpu").start()
    httpd = start_http(svc)
    url = "http://%s:%d" % httpd.server_address[:2]
    try:
        rep = slg.run_loadgen(url, beams, rate=20.0, timeout=120.0)
        jrep = jtool.run_loadgen(url, beams[:1], rate=20.0, timeout=120.0)
    finally:
        httpd.shutdown()
        svc.stop()
    assert rep["done"] == rep["submitted"] == 2
    assert rep["failed"] == rep["unfinished"] == 0
    assert rep["p99_s"] >= rep["p50_s"] > 0
    assert jrep["done"] == 1
    assert set(rep) == set(jrep)


def test_stacked_arms_equal_and_checks_keys(tmp_path, monkeypatch):
    """-stacked at N = 1, 2 on the CPU: every job's digests equal the
    reference run_survey's, stacked and per-job; the stacked arm ran its
    pair as one batch; the checks' keys are the JAX record's."""
    monkeypatch.setenv("PRESTO_TORCH_DISABLE_MESH", "1")
    rep = slg.run_stacked_loadgen(str(tmp_path), Ns=(1, 2), device="cpu")
    assert rep["verdict"] == "PASS", rep["checks"]
    with open(os.path.join(ROOT, "SERVE_BATCH_r10.json")) as f:
        jrec = json.load(f)
    assert [set(c) for c in rep["checks"]] == \
        [set(jrec["checks"][0])] * 2
    assert set(rep) - {"device"} == set(jrec)
    n2 = rep["runs"][1]
    assert n2["stacked"]["stacked_jobs"] == 2
    assert n2["stacked"]["dispatches"] < n2["per_job"]["dispatches"]
    assert all(c["byte_equal_reference"] for c in rep["checks"])


def test_commit_writes_records_torch_only(tmp_path, monkeypatch, capsys):
    """-stacked -commit writes records/torch/SERVE_BATCH_r10.json of the
    checkout it is told of, and never the JAX tool's record."""
    monkeypatch.setenv("PRESTO_TORCH_DISABLE_MESH", "1")
    record = os.path.join(ROOT, "SERVE_BATCH_r10.json")
    before = _sha(record)
    root = tmp_path / "checkout"
    monkeypatch.setattr(slg, "REPO", str(root))
    rc = slg.main(["-stacked", "-Ns", "1", "-commit", "-device", "cpu",
                   "-workdir", str(tmp_path / "w")])
    assert rc == 0
    out = root / "records" / "torch" / "SERVE_BATCH_r10.json"
    assert str(out) in capsys.readouterr().out
    with open(out) as f:
        assert json.load(f)["verdict"] == "PASS"
    assert sorted(os.listdir(root)) == ["records"]
    assert _sha(record) == before


def _flags(tree):
    """Every option string of every add_argument call in a module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)}
    return out


def test_cli_has_every_jax_flag_and_device():
    with open(JAX_TOOL) as f:
        want = _flags(ast.parse(f.read()))
    got = {o for a in slg.build_parser()._actions
           for o in a.option_strings}
    assert want <= got
    assert got - want - {"-h", "--help"} == {"-device", "--device"}
    assert slg.build_parser().parse_args([]).device == "cuda"


def test_constants_are_the_jax_tools(jtool):
    for name in ("DEFAULT_FLEET_CONFIG", "STACKED_CFG", "DAG_CFG",
                 "SLO_CFG", "SLO_LATENCY_S", "SLO_SPECS", "SLO_WINDOWS",
                 "CAMPAIGN_GOLD_OBJECTIVE_S", "CAMPAIGN_OBS_SPEC"):
        assert getattr(slg, name) == getattr(jtool, name), name
    assert slg.slo_specs() == jtool.SLO_SPECS


@pytest.mark.parametrize("argv", [["-selfhost"], ["-stacked"],
                                  ["-replicas", "2"], ["-supervisor"]])
def test_cli_needs_a_card(tmp_path, argv):
    """The default device is the card; without one the CLI raises
    before it starts anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        slg.main(argv + ["-workdir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_cli_argv_passes_the_device():
    """-dag's CLI reference: python -m for a CLI without a device, the
    module's main(argv, device=) in a process of its own otherwise."""
    assert slg._cli_argv("presto_tpu_torch.apps.accel_sift", ["-o", "x"]
                         )[1:] == ["-m", "presto_tpu_torch.apps.accel_sift",
                                   "-o", "x"]
    argv = slg._cli_argv("presto_tpu_torch.apps.prepfold", ["a.dat"], "cpu")
    assert argv[1] == "-c" and argv[3:] == ["a.dat"]
    assert "from presto_tpu_torch.apps.prepfold import main" in argv[2]
    assert "device='cpu'" in argv[2]
    env = slg._subprocess_env()
    assert env["PYTHONPATH"].split(os.pathsep)[0] == slg.REPO


class _Ledger:
    def __init__(self, jobs):
        self.jobs = jobs

    def read(self):
        return {"jobs": self.jobs}


def test_dag_and_obs_pieces_equal_jax(tmp_path, jtool):
    """-dag and -obs (whole on the card) assemble their byte-equality
    surface from committed attempt dirs: _dag_artifact_bytes and
    _committed equal the JAX tool's on the same fleet directory, and the
    ledger p99 is the JAX tool's nearest-rank p99."""
    fleet = tmp_path / "fleet"
    jobs = {}
    for jid, files in (("d1-search", ["x_ACCEL_0", "x.dat"]),
                       ("d1-sift", ["cands_sifted.txt"]),
                       ("d1-fold-001", ["fold_cand1.pfd",
                                        "fold_cand1.pfd.bestprof"]),
                       ("d1-toa", ["toas.tim"]), ("other", ["toas.tim"])):
        adir = fleet / "jobs" / jid / "a0001"
        adir.mkdir(parents=True)
        for name in files:
            (adir / name).write_bytes(("%s/%s" % (jid, name)).encode())
        (fleet / "jobs" / jid / "result.json").write_text(
            json.dumps({"attempt_dir": "a0001"}))
        jobs[jid] = {"dag": "d1" if jid.startswith("d1") else None,
                     "state": "done"}
    led = _Ledger(jobs)
    got = slg._dag_artifact_bytes(str(fleet), "d1", led)
    assert got == jtool._dag_artifact_bytes(str(fleet), "d1", led)
    assert sorted(got) == ["fold-001", "search", "sift", "toa"]
    assert slg._committed(str(fleet), "d1-toa", "toas.tim") == \
        b"d1-toa/toas.tim"
    rng = random.Random(5)
    for n in (1, 2, 7, 100, 101):
        totals = sorted(rng.random() for _ in range(n))
        want = totals[min(len(totals) - 1,
                          max(0, (len(totals) * 99 + 99) // 100 - 1))]
        assert slg._ledger_p99(totals) == want
    assert slg._ledger_p99([]) is None


def test_slo_supervisor_campaign_pieces(jtool):
    """-slo, -supervisor and -campaign (whole on the card): their p99 is
    the JAX tool's; the SLO arm's objective is the JAX tool's 2 s unless
    the reference arm's fastest job is faster, and its specs parse as
    the router parses them; the SLO checks' keys are the JAX record's
    with reference_arm_had_no_slo for unmetered_arm_wrote_no_usage (the
    port meters usage always)."""
    from presto_tpu_torch.obs import slo
    rng = random.Random(7)
    for n in (0, 1, 3, 10, 57):
        xs = [rng.random() for _ in range(n)]
        assert slg._p99(xs) == jtool._p99(xs)
    assert slg.slo_objective({"job_e2e_s": {"a": 3.0, "b": None}}) == 2.0
    assert slg.slo_objective({"job_e2e_s": {"a": 0.41234, "b": 0.9}}) \
        == 0.412
    specs = [slo.parse_spec(s) for s in slg.slo_specs(0.412)]
    assert [(s.tenant, s.objective, s.latency_s) for s in specs] == \
        [("gold", 0.999, 0.412), ("bronze", 0.5, 0.412)]
    with open(os.path.join(ROOT, "SLO_r14.json")) as f:
        jchecks = set(json.load(f)["checks"])
    with open(slg.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_slo_loadgen")
    checks = next(n.value for n in ast.walk(fn)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "checks")
    keys = {k.value for k in checks.keys}
    assert keys == jchecks - {"unmetered_arm_wrote_no_usage"} | {
        "reference_arm_had_no_slo"}
