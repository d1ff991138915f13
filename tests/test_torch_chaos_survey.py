"""presto_tpu_torch/apps/{chaos_survey, multihost_chaos} against the JAX
tools (tools/chaos_survey.py, tools/multihost_chaos.py) on the CPU.

  * The kill points: on chaos_survey's observation (8192 x 16, the JAX
    tool's bytes) a recording FaultInjector sees every point of a fresh
    run and of a resumed one, in order, the same in both packages'
    run_survey: each of the nine KILL_POINTS fires once on a fresh run
    (fold-cand never: the tool's survey folds nothing), and the resumed
    run passes the stage points again without its chunk points.
  * chaos_survey: one port trial at seed 0 converges to the reference;
    _corrupt_random_artifact picks the same file and operation as the
    JAX function for the same random state, with the same bytes after.
  * multihost_chaos: the schedule draw (victim, point, nth, mode) equals
    the JAX tool's for three seeds; the members run the port's
    prepsubband with the JAX tool's argv plus the device, and the victim
    alone carries PRESTO_TORCH_ELASTIC_KILL.  The two-process trial runs
    whole on the card (chip_smoke.py's chaos phase), not here.
"""

import collections
import glob
import os
import random
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))

import chaos_survey as jcs  # noqa: E402
import multihost_chaos as jmh  # noqa: E402

from presto_tpu.pipeline.survey import run_survey as jrun_survey  # noqa: E402
from presto_tpu.testing import chaos as jchaos  # noqa: E402

from presto_tpu_torch.apps import chaos_survey as pcs  # noqa: E402
from presto_tpu_torch.apps import multihost_chaos as pmh  # noqa: E402
from presto_tpu_torch.apps import prepsubband  # noqa: E402
from presto_tpu_torch.parallel import elastic  # noqa: E402
from presto_tpu_torch.pipeline.survey import run_survey  # noqa: E402
from presto_tpu_torch.testing import chaos  # noqa: E402

#: each KILL_POINT's hits (substring matches, as FaultInjector counts
#: them) on a fresh run of the tool's survey, both packages
FRESH_HITS = {"pre-rfifind": 1, "post-rfifind": 1, "prepsubband-method": 1,
              "post-prepsubband": 1, "fused-chunk": 1, "pre-sift": 1,
              "post-sift": 1, "fold-cand": 0, "pre-singlepulse": 1}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's small surveys on one intra-op thread: where several
    test workers share the host, each spinning torch's default pool
    slows them several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    """chaos_survey's observation written by each package."""
    d = tmp_path_factory.mktemp("chaos_obs")
    os.makedirs(str(d / "jax"))
    os.makedirs(str(d / "port"))
    return (jcs._make_obs(str(d / "jax"), 8192, 16),
            pcs._make_obs(str(d / "port"), 8192, 16))


def _hits(points):
    return {k: sum(k in p for p in points) for k in pcs.KILL_POINTS}


def test_kill_points_fire_alike(obs, tmp_path, monkeypatch, capsys):
    """Every kill point of a fresh and of a resumed run, in order, equal
    in both packages; the nine KILL_POINTS' fresh counts are
    FRESH_HITS."""
    monkeypatch.setenv("PRESTO_TPU_DISABLE_MESH", "1")
    jraw, praw = obs
    with open(jraw, "rb") as a, open(praw, "rb") as b:
        assert a.read() == b.read()
    assert pcs.KILL_POINTS == jcs.KILL_POINTS
    seen = {}
    for run in ("fresh", "resumed"):
        ji = jchaos.FaultInjector(mode="off")
        pi = chaos.FaultInjector(mode="off")
        jrun_survey([jraw], jcs._cfg(None, ji), workdir=str(tmp_path / "j"))
        run_survey([praw], pcs._cfg(None, pi), workdir=str(tmp_path / "p"),
                   device="cpu")
        seen[run] = (ji.points_seen, pi.points_seen)
    with capsys.disabled():
        for run, (jp, pp) in seen.items():
            print("\n%s run, KILL_POINTS hits (JAX, port): %s"
                  % (run, {k: (_hits(jp)[k], _hits(pp)[k])
                           for k in pcs.KILL_POINTS}))
    for jp, pp in seen.values():
        assert pp == jp
    assert _hits(seen["fresh"][1]) == FRESH_HITS
    resumed = collections.Counter(seen["resumed"][1])
    assert resumed["fused-chunk"] == 0 and resumed["pre-sift"] == 1


def test_one_trial_converges(obs, tmp_path, capsys):
    """chaos_survey's first trial of seed 0 on the CPU: killed and
    resumed (with a corruption where the draw asks), the artifacts equal
    the uninterrupted run's."""
    import presto_tpu_torch.apps.chaos_survey as cs
    raw, provider, ref = cs.reference(str(tmp_path), 8192, 16, "cpu")
    rec = cs.run_trial(0, random.Random(0), raw, provider, ref,
                       str(tmp_path), "cpu")
    with capsys.disabled():
        print("\nchaos_survey seed 0: %s, kills fired %s"
              % (" -> ".join(rec["schedule"]), rec["hits"]))
    assert ref and rec["ok"], rec["detail"]
    assert rec["hits"]


def _victims(d):
    os.makedirs(d)
    names = ["psr_DM5.00.dat", "psr_DM5.00.fft", "psr_DM5.30.dat",
             "psr_DM5.30_ACCEL_0", "psr_DM5.30_ACCEL_0.cand",
             "psr_DM5.00.inf", "psr_rfifind.mask", "cands_sifted.txt"]
    for i, n in enumerate(names):
        with open(os.path.join(d, n), "wb") as f:
            f.write(bytes(range(256)) * (4 + i))
    return d


def _tree(d):
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "*"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_corruption_choice_equals_jax(tmp_path, seed):
    """The same victim, operation and bytes after, from the same random
    state on the same files, and the same state left behind."""
    jd = _victims(str(tmp_path / "jax"))
    pd = _victims(str(tmp_path / "port"))
    jr, pr = random.Random(seed), random.Random(seed)
    assert pcs._corrupt_random_artifact(pd, pr) == \
        jcs._corrupt_random_artifact(jd, jr)
    assert _tree(pd) == _tree(jd)
    assert pr.random() == jr.random()
    shutil.rmtree(jd)
    os.makedirs(jd)
    assert pcs._corrupt_random_artifact(jd, pr) is None


class _FakePopen:
    """Records each member's argv and environment; the member fails at
    once, so run_trial returns its draw without a cluster."""
    calls = []

    def __init__(self, argv, env=None, **kw):
        _FakePopen.calls.append((argv, env))
        self.returncode = 1
        self.pid = 0

    def communicate(self, timeout=None):
        return "", "fake member"

    def kill(self):
        pass


def _draws(mod, seed, tmp, monkeypatch, **kw):
    _FakePopen.calls = []
    monkeypatch.setattr(mod.subprocess, "Popen", _FakePopen)
    rng = random.Random(seed)
    outs = [mod.run_trial(t, rng, "x.fil", str(tmp), 8, 16, 2, 10.0, 8.0,
                          5.0, **kw) for t in range(3)]
    monkeypatch.undo()
    return outs, list(_FakePopen.calls)


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_multihost_draws_and_members_equal_jax(tmp_path, monkeypatch,
                                               seed):
    """Three trials' (victim, point, nth, mode) equal the JAX tool's;
    each member runs the port's prepsubband with the JAX tool's flags and
    the device, and only the victim has PRESTO_TORCH_ELASTIC_KILL."""
    jout, _ = _draws(jmh, seed, tmp_path / "j", monkeypatch)
    pout, calls = _draws(pmh, seed, tmp_path / "p", monkeypatch,
                         device="cpu")
    key = ("victim", "point", "nth", "mode")
    assert [tuple(o[k] for k in key) for o in pout] == \
        [tuple(o[k] for k in key) for o in jout]
    assert [o["stage"] for o in pout] == ["survivor-failed"] * 3
    for t, out in enumerate(pout):
        members = calls[2 * t:2 * t + 2]
        kills = [env.get(elastic.KILL_ENV) for _, env in members]
        want = "%s:%d:%s" % (out["point"], out["nth"], out["mode"])
        assert kills[out["victim"]] == want
        assert kills[1 - out["victim"]] is None
        assert not any("PRESTO_TPU_ELASTIC_KILL" in env
                       for _, env in members)
        for procid, (argv, env) in enumerate(members):
            assert argv[-1] == str(procid)
            assert "presto_tpu_torch.apps import prepsubband" in argv[2]
            assert "import jax" not in argv[2]
            assert env["PYTHONPATH"].split(os.pathsep)[0] == pmh.REPO


def _member(code, parser):
    """A member program's prepsubband arguments parsed by ``parser``
    (its process id 1) and its run call's keyword arguments."""
    import ast
    tree = ast.parse(code)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)]
    argv = eval(compile(ast.Expression(next(
        c for c in calls if c.func.attr == "parse_args").args[0]),
        "<member>", "eval"), {"pid": 1})
    run = next(c for c in calls if c.func.attr == "run")
    return vars(parser.parse_args(argv)), {
        k.arg: ast.literal_eval(k.value) for k in run.keywords}


def test_multihost_member_argv_is_the_jax_tools():
    """The port member's parsed prepsubband arguments equal the JAX
    member's in every flag both CLIs have (the coordinator, the elastic
    knobs, the DM grid), and its run gets the device."""
    from presto_tpu.apps import prepsubband as jprep
    kw = dict(coord="localhost:5", out="/w/mh", numdms=8, nsub=16,
              raw="/w/m.fil", shard_rows=2, ttl=10.0, bto=8.0)
    pa, pkw = _member(pmh.child_code(device="cuda:0", **kw),
                      prepsubband.build_parser())
    ja, jkw = _member(jmh.CHILD % dict(kw, repo=jmh.REPO, nproc=2),
                      jprep.build_parser())
    assert pkw == {"device": "cuda:0"} and jkw == {}
    common = sorted(set(pa) & set(ja))
    assert {k for k in common if pa[k] != ja[k]} == set()
    for k in ("coordinator", "nproc", "procid", "elastic", "shard_rows",
              "lease_ttl", "barrier_timeout", "heartbeat_interval",
              "numdms", "nsub", "lodm", "dmstep", "nobary"):
        assert k in common, k
    assert (pa["coordinator"], pa["procid"], pa["elastic"]) == \
        ("localhost:5", 1, True)


def test_reports_go_under_records_torch():
    """multihost_chaos's report defaults to records/torch/ of this
    checkout, never the JAX tool's record at the root."""
    out = pmh.build_parser().parse_args([]).json_out
    assert out == os.path.join(pmh.REPO, "records", "torch",
                               "MULTIHOST_CHAOS.json")


def test_apps_need_a_card_unless_cpu(tmp_path):
    """Without a card every chaos app raises on its default device,
    before any work, and nothing falls back."""
    from presto_tpu_torch.apps import (fed_chaos, fleet_chaos,
                                       stream_chaos)
    for mod, argv in ((pcs, ["--workdir", str(tmp_path / "cs")]),
                      (pmh, ["--workdir", str(tmp_path / "mh")]),
                      (stream_chaos, []),
                      (fleet_chaos, ["-workdir", str(tmp_path / "fc")]),
                      (fed_chaos, ["-workdir", str(tmp_path / "fd")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
    assert os.listdir(str(tmp_path)) == []
