"""The port's presto-lint (presto_tpu_torch/lint) against the JAX
package's: on every shared fixture of tests/test_presto_lint.py each
family gives the JAX findings, with the paths mapped to the port's tree
(presto_tpu/ -> presto_tpu_torch/, tools/ -> presto_tpu_torch/apps/, the
port's tools); the port-only rules (trace-purity's kernel entry points
and torch RNG, the jax / presto_tpu import rule) bite with exact lines;
the real port tree is clean against a short, noted baseline; the CLI
and the obs_lint shim work."""

import json
import os
import textwrap

import pytest

from presto_tpu.lint import core as jcore

from presto_tpu_torch import lint as plint
from presto_tpu_torch.apps import obs_lint, presto_lint
from presto_tpu_torch.lint import core as pcore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX path prefix -> the port's
PREFIXES = (("presto_tpu/", "presto_tpu_torch/"),
            ("tools/", "presto_tpu_torch/apps/"))


def _map(text):
    for old, new in PREFIXES:
        if text.startswith(old):
            return new + text[len(old):]
    return text


def _map_msg(msg):
    return msg.replace("presto_tpu/", "presto_tpu_torch/")


def _rows(findings, mapped=False):
    return [((f.check, _map(f.path), f.line, _map_msg(f.message))
             if mapped else (f.check, f.path, f.line, f.message))
            for f in findings]


# ---------------------------------------------------------------------------
# the JAX package's fixtures (tests/test_presto_lint.py), verbatim
# ---------------------------------------------------------------------------

BAD_WRITER = '''
import os

def dump(path, data):
    with open(path, "w") as f:
        f.write(data)

def dump_bin(fd):
    with os.fdopen(fd, "wb") as f:
        f.write(b"x")
'''

TOFILE = '''
import os
import numpy as np

def scratch(d, arr):
    dst = os.path.join(d, "x.dat")
    arr.tofile(dst)

def into_file_object(f, arr):
    arr.tofile(f)       # a managed file handle: not flagged
'''

IDIOMS = '''
import os
import tempfile

def tmp_replace(path, data):
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)

def fence_staged(ledger, lease, final, data):
    fd, tmp = tempfile.mkstemp(dir=".")
    with os.fdopen(fd, "w") as f:
        f.write(data)
    ledger.complete(lease, "host", {final: tmp})
'''

READS = '''
def reader(path):
    with open(path) as f:
        return f.read()

def logline(path, ev):
    with open(path, "a") as f:
        f.write(ev + "\\n")
'''

SNEAKY = '''
import os

def poke(ledger, row):
    state = ledger._load()
    state["items"]["x"] = row
    ledger._save(state)

def clobber(tmp, jobdir):
    os.replace(tmp, os.path.join(jobdir, "result.json"))
'''

MONITOR = '''
import os, json

def monitor(ledger):
    return ledger.read()            # public, read-only: fine

def locate(jobdir):
    return os.path.join(jobdir, "result.json")   # not a write
'''

GUARDED = '''
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()  # presto-lint: guards(_state)
        self._cv = threading.Condition(self._lock)
        self._state = {}

    def locked_read(self):
        with self._lock:
            return len(self._state)

    def cv_read(self):
        with self._cv:                 # condition aliases the lock
            return len(self._state)

    def racy_read(self):
        return len(self._state)

    def racy_thread(self):
        def worker():
            self._state["x"] = 1
        with self._lock:
            return worker

    def helper(self):  # presto-lint: holds(_lock)
        return list(self._state)
'''

CYCLE = '''
import threading

class D:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            with self._a:
                pass
'''

UNUSED = '''
import os
import os
import sys

def f():
    return os.getpid()
'''

EXEMPT = '''
import unusedbutnoqa  # noqa
import urllib.error
import urllib.request

try:
    import optionaldep
except ImportError:
    optionaldep = None

def f(u):
    return urllib.request.urlopen(u), urllib.error, optionaldep
'''

DOC = '''
import math

def f(x):
    """Uses math.pi conceptually: math."""
    return x
'''

PRAGMAS = '''
def dump(path, data):
    with open(path, "w") as f:  # presto-lint: allow(atomic-write)
        f.write(data)

def dump2(path, data):
    # presto-lint: allow(atomic-write)
    with open(path, "w") as f:
        f.write(data)

def dump3(path, data):
    with open(path, "w") as f:  # presto-lint: allow(other-check)
        f.write(data)
'''

#: (sources keyed by JAX path, families) — every shared fixture case
CASES = {
    "atomic_write_lines": ({"presto_tpu/pipeline/bad.py": BAD_WRITER},
                           ["atomic-write"]),
    "atomic_write_tofile": ({"presto_tpu/serve/t.py": TOFILE},
                            ["atomic-write"]),
    "atomic_write_idioms": ({"presto_tpu/pipeline/ok.py": IDIOMS},
                            ["atomic-write"]),
    "atomic_write_reads": ({"presto_tpu/obs/r.py": READS},
                           ["atomic-write"]),
    "atomic_write_out_of_scope": ({"presto_tpu/apps/w.py": BAD_WRITER},
                                  ["atomic-write"]),
    "fence_lines": ({"presto_tpu/serve/sneaky.py": SNEAKY},
                    ["fence-discipline"]),
    "fence_commit_path": ({"presto_tpu/serve/jobledger.py": SNEAKY},
                          ["fence-discipline"]),
    "fence_reads": ({"tools/mon.py": MONITOR}, ["fence-discipline"]),
    "fence_tools_write": ({"tools/mon.py": SNEAKY}, ["fence-discipline"]),
    "lock_guard": ({"presto_tpu/serve/c.py": GUARDED}, ["lock-guard"]),
    "lock_guard_undeclared": (
        {"presto_tpu/serve/c.py":
         GUARDED.replace("  # presto-lint: guards(_state)", "")},
        ["lock-guard"]),
    "lock_order_cycle": ({"presto_tpu/serve/d.py": CYCLE}, ["lock-order"]),
    "lock_order_acyclic": (
        {"presto_tpu/serve/d.py": CYCLE.replace(
            "        with self._b:\n            with self._a:",
            "        with self._a:\n            with self._b:")},
        ["lock-order"]),
    "import_unused_duplicate": ({"presto_tpu/utils/u.py": UNUSED},
                                ["import-hygiene"]),
    "import_exemptions": ({"presto_tpu/utils/v.py": EXEMPT},
                          ["import-hygiene"]),
    "import_init_reexports": ({"presto_tpu/sub/__init__.py": "import os\n"},
                              ["import-hygiene"]),
    "import_docstring_mention": ({"presto_tpu/utils/w.py": DOC},
                                 ["import-hygiene"]),
    "import_tools": ({"tools/u.py": UNUSED}, ["import-hygiene"]),
    "pragmas": ({"presto_tpu/pipeline/p.py": PRAGMAS}, ["atomic-write"]),
    "syntax_error": ({"presto_tpu/pipeline/x.py": "def broken(:\n"}, []),
    "all_families": ({"presto_tpu/serve/c.py": GUARDED,
                      "presto_tpu/serve/d.py": CYCLE,
                      "presto_tpu/serve/sneaky.py": SNEAKY,
                      "presto_tpu/pipeline/bad.py": BAD_WRITER,
                      "presto_tpu/utils/u.py": UNUSED},
                     ["atomic-write", "fence-discipline", "import-hygiene",
                      "lock-guard", "lock-order"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_findings_equal_jax(case):
    """The port's families give the JAX package's findings as (check,
    path, line, message), with the paths mapped."""
    sources, checks = CASES[case]
    want = _rows(jcore.run_checks(jcore.Tree.from_sources(sources),
                                  checks=checks), mapped=True)
    got = _rows(pcore.run_checks(pcore.Tree.from_sources(
        {_map(p): src for p, src in sources.items()}), checks=checks))
    assert got == want
    # the JAX tests' own expectations hold on the port's side too
    if case == "atomic_write_lines":
        assert [r[2] for r in got] == [5, 9]
    if case == "fence_lines":
        assert [r[2] for r in got] == [5, 7, 10]
    if case == "lock_guard":
        assert [r[2] for r in got] == [19, 23]
    if case == "lock_order_cycle":
        assert len(got) == 1 and "cycle" in got[0][3]


@pytest.mark.parametrize("entries", ["match", "stale", "none"])
def test_baseline_equals_jax(entries, tmp_path):
    """apply_baseline splits the same findings the same way (kept,
    suppressed, stale) in both packages, and save/load round-trips."""
    jentry = {"check": "atomic-write", "path": "presto_tpu/pipeline/b.py",
              "context": 'with open(path, "w") as f:'}
    dead = {"check": "atomic-write", "path": "presto_tpu/pipeline/b.py",
            "context": "with open(gone, 'w') as f:"}
    jentries = {"match": [jentry], "stale": [jentry, dead],
                "none": []}[entries]
    pentries = [dict(e, path=_map(e["path"])) for e in jentries]
    jtree = jcore.Tree.from_sources({"presto_tpu/pipeline/b.py": BAD_WRITER})
    ptree = pcore.Tree.from_sources(
        {"presto_tpu_torch/pipeline/b.py": BAD_WRITER})
    want = jcore.apply_baseline(jtree, jcore.run_checks(
        jtree, checks=["atomic-write"]), jentries)
    got = pcore.apply_baseline(ptree, pcore.run_checks(
        ptree, checks=["atomic-write"]), pentries)
    assert [_rows(g) for g in got] == [_rows(w, mapped=True) for w in want]
    p = str(tmp_path / "base.json")
    pcore.save_baseline(p, pentries)
    assert pcore.load_baseline(p) == pentries


def test_whole_file_findings_baseline_by_message():
    """A line-0 finding's baseline entry matches its message, so one
    grandfathered obs-coverage problem does not hide another."""
    tree = pcore.Tree.from_sources({"presto_tpu_torch/obs/taxonomy.py": ""})
    a = pcore.Finding("obs-coverage", "presto_tpu_torch/obs/taxonomy.py", 0,
                      "problem a")
    b = pcore.Finding("obs-coverage", "presto_tpu_torch/obs/taxonomy.py", 0,
                      "problem b")
    entry = pcore.baseline_entry(tree, a, note="why")
    assert entry["context"] == "problem a"
    kept, suppressed, stale = pcore.apply_baseline(tree, [a, b], [entry])
    assert (kept, suppressed, stale) == ([b], [a], [])


# ---------------------------------------------------------------------------
# port-only rules
# ---------------------------------------------------------------------------

KERNEL_MODULE = '''
import time

import numpy as np
import torch

from presto_tpu_torch import cuda_build
from presto_tpu_torch.ops.helpers import noisy


def op_plain(x):
    return x + torch.rand(3)


def seeded_plain(x, gen):
    return x + torch.randn(3, generator=gen)


def reseeding_plain(x):
    torch.manual_seed(0)
    return x


def op(x):
    if x.device.type == "cpu":
        return op_plain(x)
    return _launch(x)


def _launch(x):
    t = time.time()
    cuda_build.launch(None, x.device, noisy(t))
    return x


def host_side():
    return time.time(), np.random.normal()
'''

HELPERS = '''
import numpy as np


def noisy(x):
    return np.random.normal() + x


def quiet(x):
    return x + 1
'''


def test_purity_kernel_entry_points_and_torch_rng():
    """Entry points are the launch's callers, their callers in the module
    and the *_plain versions; reachable impure calls are flagged (the
    global torch generator too), a draw with generator= and code no
    entry reaches are not."""
    fs = pcore.run_checks(pcore.Tree.from_sources({
        "presto_tpu_torch/search/k_cuda.py": KERNEL_MODULE,
        "presto_tpu_torch/ops/helpers.py": HELPERS}),
        checks=["trace-purity"])
    got = [(f.path.rsplit("/", 1)[1], f.line) for f in fs]
    assert got == [("helpers.py", 6), ("k_cuda.py", 12), ("k_cuda.py", 20),
                   ("k_cuda.py", 31)], got
    msgs = [f.message for f in fs]
    assert "numpy.random.normal" in msgs[0] and "_launch" in msgs[0]
    assert "torch.rand without generator=" in msgs[1]
    assert "torch.manual_seed" in msgs[2]
    assert "time.time" in msgs[3]


def test_purity_module_without_launch_has_no_entry():
    src = KERNEL_MODULE.replace("cuda_build.launch(None, x.device, "
                                "noisy(t))", "noisy(t)")
    assert pcore.run_checks(pcore.Tree.from_sources({
        "presto_tpu_torch/search/k_cuda.py": src,
        "presto_tpu_torch/ops/helpers.py": HELPERS}),
        checks=["trace-purity"]) == []


FOREIGN = '''
import numpy as np
import presto_tpu_torch.io

try:
    import jax
except ImportError:
    jax = None


def f():
    from presto_tpu.io import sigproc
    import jax.numpy as jnp
    return sigproc, jnp, np, jax, presto_tpu_torch.io
'''


@pytest.mark.parametrize("path", ["presto_tpu_torch/utils/f.py",
                                  "presto_tpu_torch/utils/__init__.py",
                                  "chip_smoke.py"])
def test_imports_of_jax_or_the_jax_package_are_flagged(path):
    """Everywhere in the port, __init__.py and try blocks included."""
    fs = pcore.run_checks(pcore.Tree.from_sources({path: FOREIGN}),
                          checks=["import-hygiene"])
    assert [(f.line, f.message.split()[0]) for f in fs] == [
        (6, "'jax'"), (12, "'presto_tpu.io'"), (13, "'jax.numpy'")]
    assert all(f.check == "import-hygiene" and f.path == path for f in fs)


# ---------------------------------------------------------------------------
# the real tree, the CLI, the shim
# ---------------------------------------------------------------------------

def test_real_port_tree_is_clean():
    """Seven families, no live finding, no stale entry; the baseline is
    at most 10 entries, each with a note, each suppressing a finding."""
    assert set(pcore.registered_checks()) == set(jcore.registered_checks())
    assert len(pcore.registered_checks()) == 7
    kept, suppressed, stale = plint.run_lint(ROOT, plint.BASELINE)
    assert kept == [], "\n".join(f.format() for f in kept)
    assert stale == [], "\n".join(f.format() for f in stale)
    entries = pcore.load_baseline(plint.BASELINE)
    assert len(entries) <= 10
    assert all(len(e.get("note", "")) > 20 for e in entries)
    assert len(suppressed) == len(entries)
    tree = pcore.Tree.collect(ROOT)
    assert "chip_smoke.py" in tree.files
    assert not any(p.startswith(("presto_tpu/", "tools/"))
                   for p in tree.files)


def _tree(tmp_path, files):
    root = tmp_path / "repo"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def test_cli_json_clean_and_exit_1_on_violation(tmp_path, capsys):
    clean = _tree(tmp_path / "a", {"presto_tpu_torch/pipeline/ok.py": IDIOMS})
    assert presto_lint.main(["--root", clean, "--no-baseline",
                             "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is True and out["findings"] == []
    assert len(out["checks"]) == 7
    bad = _tree(tmp_path / "b",
                {"presto_tpu_torch/pipeline/bad.py": BAD_WRITER})
    assert presto_lint.main(["--root", bad, "--no-baseline", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is False
    assert [f["line"] for f in out["findings"]] == [5, 9]
    assert presto_lint.main(["--root", bad, "--no-baseline"]) == 1
    assert "[atomic-write]" in capsys.readouterr().out
    # --write-baseline grandfathers them, and the next run passes
    base = str(tmp_path / "base.json")
    assert presto_lint.main(["--root", bad, "--baseline", base,
                             "--write-baseline"]) == 0
    assert len(pcore.load_baseline(base)) == 2
    capsys.readouterr()
    assert presto_lint.main(["--root", bad, "--baseline", base]) == 0
    assert "2 finding(s) grandfathered" in capsys.readouterr().out
    assert presto_lint.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == pcore.registered_checks()


def test_obs_lint_shim(capsys):
    """apps/obs_lint re-exports obs-coverage's API; its main honours the
    baseline, whose one obs-coverage entry is the only problem."""
    entries = [e["context"] for e in pcore.load_baseline(plint.BASELINE)
               if e["check"] == "obs-coverage"]
    assert obs_lint.lint() == entries
    assert obs_lint.STAGE_RE.findall('timer.mark("sift")') == ["sift"]
    assert obs_lint.main() == 0
    assert "OK" in capsys.readouterr().out


def test_lock_guard_reads_the_ports_declarations():
    """Every class of the port that declares guards is enforced: a method
    added to it that reads a guarded attribute without its lock is
    reported, one finding a class."""
    import ast
    from presto_tpu_torch.lint import locks
    tree = pcore.Tree.collect(ROOT)
    classes = []
    for sf in tree.under("presto_tpu_torch/"):
        for cls in [n for n in ast.walk(sf.tree)
                    if isinstance(n, ast.ClassDef)]:
            decl = locks._ClassLocks()
            decl.scan(cls, sf)
            if decl.guards:
                classes.append((sf.path, cls, sorted(decl.guards)[0]))
    assert len(classes) >= 13
    for path, cls, attr in classes:
        lines = tree.files[path].lines[:]
        lines.insert(cls.lineno, "    def racy_probe(self):\n"
                                 "        return self.%s\n" % attr)
        fs = pcore.run_checks(pcore.Tree.from_sources(
            {path: "\n".join(lines)}), checks=["lock-guard"])
        assert [f.message.split()[0] for f in fs] == ["self." + attr], \
            (path, cls.name, fs)


# ---------------------------------------------------------------------------
# the first run's repairs (obs-coverage, atomic-write)
# ---------------------------------------------------------------------------

def _enabled_obs():
    from presto_tpu_torch.obs import ObsConfig, Observability
    return Observability(ObsConfig(enabled=True))


def _kinds(obs):
    return [r["kind"] for r in obs.flightrec.records()]


def test_beam_ledger_records_its_events_as_the_jax_one(tmp_path):
    """stream/beams.BeamLedger declares the JAX package's EV_* kinds, so
    a lease, a commit and a reap reach the flight recorder, in the JAX
    ledger's order."""
    from presto_tpu.obs import ObsConfig as JObsConfig
    from presto_tpu.obs import Observability as JObservability
    from presto_tpu.stream.beams import BeamLedger as JBeamLedger
    from presto_tpu_torch.obs import taxonomy
    from presto_tpu_torch.stream.beams import BeamLedger
    runs = {}
    for name, cls, obs in (
            ("jax", JBeamLedger, JObservability(JObsConfig(enabled=True))),
            ("port", BeamLedger, _enabled_obs())):
        led = cls(str(tmp_path / name), obs=obs)
        led.join("r1", now=100.0)
        led.ensure_items([("b0", {"triggers": []}), ("b1", {"triggers": []})])
        lease = led.lease("r1", 5.0, now=100.0)
        led.advance({lease.item_id: lease}, "r1",
                    {lease.item_id: {"triggers": [{"t": 1}]}}, 5.0,
                    now=101.0)
        led.lease("r1", 5.0, now=101.0)
        led.reap(1.0, now=200.0)
        runs[name] = [k for k in (r["kind"] for r in
                                  obs.flightrec.records())
                      if k.startswith("beam-")]
    assert runs["port"] == runs["jax"]
    assert {"beam-lease", "beam-replica-dead", "beam-redo",
            "beam-epoch-bump"} <= set(runs["port"]) <= taxonomy.BEAM_EVENTS


@pytest.mark.parametrize("handle", ["given", "process"])
def test_elastic_cluster_records_its_events(tmp_path, monkeypatch, handle):
    """parallel/elastic.ElasticCluster flight-records its joins and chaos
    points and its ledger's lease/commit events, as the JAX package's
    cluster does, on a handle it is given or, given none, on the
    process's once that is enabled; and nothing on the process's
    disabled default."""
    from presto_tpu_torch import obs as port_obs
    from presto_tpu.obs import ObsConfig as JObsConfig
    from presto_tpu.obs import Observability as JObservability
    from presto_tpu.parallel import elastic as jelastic
    from presto_tpu.pipeline.shardledger import make_dm_shards as jshards
    from presto_tpu_torch.obs import taxonomy
    from presto_tpu_torch.parallel import elastic
    from presto_tpu_torch.pipeline.shardledger import make_dm_shards

    def compute(mod, work):
        def fn(lease):
            staged = {}
            for i in range(*lease.rows):
                final = os.path.join(work, "row%03d.dat" % i)
                tmp = mod.stage_path(final, "h0", lease.epoch)
                with open(tmp, "wb") as f:
                    f.write(b"row")
                staged[final] = tmp
            return staged
        return fn

    cfg = dict(barrier_timeout=2.0, lease_ttl=5.0, heartbeat_interval=0.1,
               idle_poll=0.02)
    monkeypatch.setattr(port_obs, "_default", None)
    kinds = {}
    for name, mod, shards, obs in (
            ("jax", jelastic, jshards,
             JObservability(JObsConfig(enabled=True))),
            ("port", elastic, make_dm_shards, _enabled_obs()
             if handle == "given" else
             port_obs.configure(port_obs.ObsConfig(enabled=True)))):
        work = str(tmp_path / name)
        kw = {} if name == "port" and handle == "process" else {"obs": obs}
        c = mod.ElasticCluster(work, "h0", mod.ElasticConfig(**cfg), **kw)
        assert c.obs is obs and c.ledger.obs is obs
        c.join()
        try:
            c.run(shards(4, 2), compute(mod, work))
        finally:
            c.close()
        kinds[name] = [k for k in (r["kind"] for r in
                                   obs.flightrec.records())
                       if k in taxonomy.CLUSTER_EVENTS]
    assert kinds["port"] == kinds["jax"]
    assert {"cluster-join", "chaos-point", "shard-lease",
            "shard-done"} <= set(kinds["port"])
    monkeypatch.setattr(port_obs, "_default", None)
    quiet = elastic.ElasticCluster(str(tmp_path / "quiet"), "h0",
                                   elastic.ElasticConfig(**cfg))
    assert quiet.obs.enabled is False


def _seam_block(tmp_path, nrows=3, n=64, mesh=None):
    import numpy as np
    from presto_tpu_torch.io.infodata import InfoData
    from presto_tpu_torch.pipeline import fusion
    host = np.arange(nrows * n, dtype=np.float32).reshape(nrows, n)
    kw = dict(names=[str(tmp_path / ("t%d" % i)) for i in range(nrows)],
              infos=[InfoData(N=n, dt=1e-3) for _ in range(nrows)],
              dms=[float(i) for i in range(nrows)], series_dev=None,
              series_host=host, valid=n, numout=n, dt=1e-3)
    if mesh is None:
        return fusion.SeamBlock(**kw)
    return fusion.ShardedSeamBlock(row_ranges=[(0, nrows)], mesh=mesh, **kw)


@pytest.mark.parametrize("sharded", [False, True])
def test_stage_seam_spans_and_counters(tmp_path, sharded):
    """pipeline/fusion.StageSeam opens the seam spans and counts the
    trials handed over and the bytes spilled, as the JAX seam does."""
    import torch
    from presto_tpu_torch.pipeline import fusion
    obs = _enabled_obs()
    seam = fusion.StageSeam(str(tmp_path), durable=False, obs=obs)
    block = _seam_block(tmp_path, mesh=object() if sharded else None)
    seam.add_block(block)
    assert seam.ensure_dat(block.names[1] + ".dat")
    name = "pipeline:shard-seam" if sharded else "pipeline:seam"
    spans = [(s.name, s.attrs.get("op")) for s in obs.tracer.finished()]
    assert spans == [(name, "handoff"), (name, "spill")]

    def value(metric):
        fam = obs.metrics.get(metric)
        return None if fam is None else sum(c.value for _l, c in
                                            fam.children())
    assert value("survey_fused_trials_total") == 3
    assert value("survey_fused_shard_trials_total") == (3 if sharded
                                                        else None)
    assert value("survey_fused_bytes_spilled_total") == 64 * 4
    # the sharded seam's download is counted where it is made
    parts = [torch.ones((2, 8)), torch.ones((1, 8))]
    fusion.gather_shards(parts, [(0, 2), (2, 3)], obs=obs)
    assert value("survey_fused_shard_gather_bytes_total") == 3 * 8 * 4


def test_staged_fft_fires_fft_chunk_and_resumes(tmp_path):
    """The staged rFFT (the zaplist flow) fires kill point fft-chunk after
    each chunk's .fft files; a run killed there resumes to the bytes of
    an uninterrupted run."""
    import numpy as np
    from presto_tpu_torch.io.datfft import write_dat
    from presto_tpu_torch.io.infodata import InfoData
    from presto_tpu_torch.pipeline import survey
    from presto_tpu_torch.testing import chaos
    series = {"a": 1024, "b": 1024, "c": 2048}
    runs = {}
    for run in ("clean", "killed"):
        d = tmp_path / run
        d.mkdir()
        dats = []
        for name, n in series.items():
            p = str(d / (name + ".dat"))
            write_dat(p, np.random.default_rng(len(name) + n).normal(
                size=n).astype(np.float32), InfoData(N=n, dt=1e-3))
            dats.append(p)
        if run == "killed":
            fi = chaos.FaultInjector(kill_at="fft-chunk")
            with pytest.raises(chaos.SimulatedCrash):
                survey._staged_fft(dats, survey.SurveyConfig(
                    fault_injector=fi), "cpu", None)
            done = sorted(f for f in os.listdir(d) if f.endswith(".fft"))
            assert 0 < len(done) < len(series)
            assert fi.fired == "fft-chunk"
        survey._staged_fft(dats, survey.SurveyConfig(), "cpu", None)
        runs[run] = {f: open(d / f, "rb").read()
                     for f in sorted(os.listdir(d)) if f.endswith(".fft")}
    assert runs["killed"] == runs["clean"] and len(runs["clean"]) == 3


def test_cost_model_counts_a_kind_without_formula():
    from presto_tpu_torch.obs import costmodel
    obs = _enabled_obs()
    with pytest.raises(KeyError):
        costmodel.probe(obs, "no_such_kind", n=1)
    costmodel.probe(obs, "rfft_batch", rows=2, n=1024)
    snap = costmodel.snapshot(obs)
    assert snap["unavailable"] == {"KeyError": 1}
    assert "rfft_batch" in snap["kinds"]


def test_tune_scratch_input_is_written_atomically(tmp_path, monkeypatch):
    """tune/space's out-of-core FFT scratch input goes through
    io/atomic.atomic_open: the seeded series, no temp file left."""
    import numpy as np
    from presto_tpu_torch.io.atomic import TMP_PREFIX
    from presto_tpu_torch.tune import space
    monkeypatch.setattr(space, "_scratch", str(tmp_path))
    space._oocfft_bench({"n": 4096}, {"max_mem": 1 << 14}, "cpu")
    got = np.fromfile(str(tmp_path / "tune_4096.dat"), dtype=np.float32)
    want = np.random.default_rng(9).normal(size=4096).astype(np.float32)
    assert got.tobytes() == want.tobytes()
    assert not [f for f in os.listdir(tmp_path) if f.startswith(TMP_PREFIX)]
