"""presto_tpu_torch/apps/{fleet_chaos, fed_chaos, stream_chaos} against
the JAX tools (tools/fleet_chaos.py, tools/fed_chaos.py,
tools/stream_chaos.py) on the CPU.

  * Every chaos app keeps its JAX tool's flags and adds the device.
  * fleet_chaos: one classic in-process trial at the tool's defaults
    (seed 9: a timed kill, 2 replicas, 3 jobs of 4096 x 8) passes, its
    checks those of FLEET_CHAOS.json's timed trials; -commit writes
    records/torch/FLEET_CHAOS.json and leaves the root records alone.
  * fed_chaos: committed_artifacts reads what the JAX function reads,
    the report has FED_CHAOS.json's keys, and each fleet runs the port's
    router and replica modules with the device.

The heavy modes (fleet_chaos -supervisor, -dag and -campaign, the
federation's fleet-dead and partition-zombie trials and -verdict) spawn
replica processes or run whole DAGs and campaigns: they are held here
through the pieces above and run whole on the card (chip_smoke.py's
chaos phase and --chaos-only).
"""

import hashlib
import json
import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))

import chaos_survey as jcs  # noqa: E402
import fed_chaos as jfd  # noqa: E402
import fleet_chaos as jfc  # noqa: E402
import multihost_chaos as jmh  # noqa: E402
import stream_chaos as jsc  # noqa: E402

from presto_tpu_torch.apps import chaos_survey as pcs  # noqa: E402
from presto_tpu_torch.apps import fed_chaos as pfd  # noqa: E402
from presto_tpu_torch.apps import fleet_chaos as pfc  # noqa: E402
from presto_tpu_torch.apps import multihost_chaos as pmh  # noqa: E402
from presto_tpu_torch.apps import serve_loadgen  # noqa: E402
from presto_tpu_torch.apps import stream_chaos as psc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX tools' committed records, which no port run may touch
ROOT_RECORDS = ("FLEET_CHAOS.json", "DAG_CHAOS.json", "CAMPAIGN_CHAOS.json",
                "FED_CHAOS.json", "FED_r19.json", "MULTIHOST_CHAOS.json",
                "STREAM_CHAOS.json")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small surveys on one intra-op thread: where several
    test workers share the host, each spinning torch's default pool
    slows them several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(main, capsys):
    """The option strings a CLI's --help lists."""
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])(--?[a-zA-Z][\w-]*)",
                          capsys.readouterr().out))


@pytest.mark.parametrize("jax_mod, port_mod", [
    (jcs, pcs), (jsc, psc), (jmh, pmh), (jfc, pfc), (jfd, pfd)],
    ids=["chaos_survey", "stream_chaos", "multihost_chaos", "fleet_chaos",
         "fed_chaos"])
def test_flags_are_the_jax_tools_plus_device(jax_mod, port_mod, capsys):
    """Each app takes every flag of its JAX tool, and -device/--device
    beside them (the heavy modes behind the flags run whole on the
    card)."""
    jflags = _flags(jax_mod.main, capsys)
    pflags = _flags(port_mod.main, capsys)
    assert jflags - pflags == set()
    assert pflags - jflags == {"-device", "--device"}


def test_the_tools_constants_carry_over():
    """The kill points, crash seams, kill modes and survey configurations
    of the JAX tools (the -dag, -campaign and federation trials' draws
    run whole on the card)."""
    assert pfc.KILL_POINTS == jfc.KILL_POINTS
    assert pfc.DAG_KILL_POINTS == jfc.DAG_KILL_POINTS
    assert pfc.CAMPAIGN_KILL_POINTS == jfc.CAMPAIGN_KILL_POINTS
    assert (pfc.TINY_CFG, pfc.DAG_CFG) == (jfc.TINY_CFG, jfc.DAG_CFG)
    assert (pfd.TINY_CFG, pfd.KILL_MODES) == (jfd.TINY_CFG, jfd.KILL_MODES)
    assert list(psc.TRIALS) == ["stall", "truncation", "ring-drop",
                                "beam-stall", "beam-truncation",
                                "beam-handoff"]


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_classic_trial_at_the_tools_defaults(tmp_path, monkeypatch):
    """fleet_chaos --fast -commit -device cpu: the classic trial of seed
    9 (a timed kill of rep1 at 1.304 s) passes with FLEET_CHAOS.json's
    checks of a timed trial and its report keys; the report lands in
    records/torch/ of the checkout (here a stand-in root) and the JAX
    tool's records at the root keep their bytes."""
    before = {n: _digest(os.path.join(ROOT, n)) for n in ROOT_RECORDS}
    monkeypatch.setattr(serve_loadgen, "REPO", str(tmp_path / "checkout"))
    rc = pfc.main(["--fast", "-commit", "-device", "cpu", "-workdir",
                   str(tmp_path / "w")])
    path = tmp_path / "checkout" / "records" / "torch" / "FLEET_CHAOS.json"
    rep = json.loads(path.read_text())
    with open(os.path.join(ROOT, "FLEET_CHAOS.json")) as f:
        jrep = json.load(f)
    assert rc == 0 and (rep["passed"], rep["failed"]) == (1, 0)
    trial = rep["trials"][0]
    assert (trial["kill_point"], trial["victim"]) == ("timed", "rep1")
    timed = [t for t in jrep["trials"] if t.get("kill_point") == "timed"]
    assert timed and sorted(trial["checks"]) == sorted(timed[0]["checks"])
    assert sorted(trial) == sorted(timed[0])
    assert sorted(rep) == sorted(k for k in jrep if k != "supervisor_trial")
    assert {n: _digest(os.path.join(ROOT, n)) for n in ROOT_RECORDS} == \
        before


def _fleet_tree(base, name, item, artifacts):
    d = os.path.join(str(base), name, "fleet", "jobs", item)
    os.makedirs(d)
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump({"artifacts": artifacts, "replica": name + "-r1"}, f)


def test_committed_artifacts_equal_jax(tmp_path):
    """The digest table of a federated result, read from whichever
    member landed it, as the JAX function reads it (a missing or foreign
    fleet gives none)."""
    _fleet_tree(tmp_path, "A", "fj-00", {"x.dat": {"sha256": "a"}})
    _fleet_tree(tmp_path, "B", "fj-01", {"x.dat": {"sha256": "b"}})
    pf = [pfd.SubFleet(str(tmp_path), n, device="cpu") for n in "AB"]
    jf = [jfd.SubFleet(str(tmp_path), n) for n in "AB"]
    for res in ({"fleet": "A", "item": "fj-00"},
                {"fleet": "B", "item": "fj-01"},
                {"fleet": "B", "item": "fj-00"},
                {"fleet": "C", "item": "fj-00"}, {}, None):
        assert pfd.committed_artifacts(pf, res) == \
            jfd.committed_artifacts(jf, res)
    assert pfd.committed_artifacts(pf, {"fleet": "B", "item": "fj-01"}) \
        == {"x.dat": {"sha256": "b"}}


def test_subfleets_run_the_ports_modules(tmp_path, monkeypatch):
    """A fleet's router and replica argv are the JAX tool's with the
    port's modules, and the replica takes the device."""
    spawned = []
    monkeypatch.setattr(jfd.SubFleet, "_spawn",
                        lambda self, tag, argv: spawned.append(argv))
    monkeypatch.setattr(jfd, "_wait", lambda *a, **k: True)
    jfleet = jfd.SubFleet(str(tmp_path / "j"), "A").start()
    pfleet = pfd.SubFleet(str(tmp_path / "p"), "A", device="cpu")
    pfleet.port = jfleet.port

    def normal(argv, fleet):
        out = [a.replace(fleet.fleetdir, "F").replace(fleet.logdir, "L")
               for a in argv[1:]]
        if "-port" in out and "-replica" in out:
            out[out.index("-port") + 1] = "P"
        return out
    router, replica = (normal(a, jfleet) for a in spawned)
    assert normal(pfleet.router_argv(), pfleet) == \
        [a.replace("presto_tpu.serve", "presto_tpu_torch.serve")
         for a in router]
    assert normal(pfleet.replica_argv(), pfleet) == \
        [a.replace("presto_tpu.apps", "presto_tpu_torch.apps")
         for a in replica] + ["-device", "cpu"]


def test_fed_report_keys_are_the_jax_tools(tmp_path):
    """fed_chaos's report (here of no trials: the trials spawn fleets and
    run whole on the card) has FED_CHAOS.json's keys, over the reference
    survey of make_beams' first beam."""
    args = pfd.build_parser().parse_args(["-trials", "0"])
    report, verdict = pfd.run(args, str(tmp_path), "cpu")
    with open(os.path.join(ROOT, "FED_CHAOS.json")) as f:
        jrep = json.load(f)
    assert verdict is None
    assert sorted(report) == sorted(jrep)
    assert report["reference_artifacts"] > 0
    assert (report["passed"], report["failed"], report["trials"]) == \
        (0, 0, [])
