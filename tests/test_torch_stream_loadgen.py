"""The port's stream_loadgen (presto_tpu_torch/apps/stream_loadgen.py)
against the JAX package's tools/stream_loadgen.py on the CPU.

make_feed gives the JAX tool's header, wire bytes and truth, and
make_beam_feeds its per-beam spectra and truth, at two seeds; run_trial
(burst mode, a short feed) gives the JAX run_trial's pulse times with
none missed, duplicated or unmatched, and its report has the JAX
report's keys beside the device; run_beam_trial at 2 beams passes
(byte-equal to independent streams, one dispatch a tick, the veto's
precision and recall); --out writes where it is told and nowhere else;
every JAX flag is a flag of the port's CLI, beside --device, and
without a card the CLI raises."""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from presto_tpu_torch.apps import stream_loadgen as stl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "stream_loadgen.py")

#: a short feed at the tool's dt and band: 12 s, two pulses, 32
#: channels (the tool's nsub), the tool's 9 DM trials
TRIAL = dict(mode="burst", seconds=12.0, npulses=2, nchan=32)


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location("jax_stream_loadgen",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 3])
def test_make_feed_equals_jax(jtool, seed):
    kw = dict(seed=seed, seconds=6.0, npulses=2, nchan=16, t_margin=1.5)
    hdr, wire, truth = stl.make_feed(**kw)
    jhdr, jwire, jtruth = jtool.make_feed(**kw)
    assert wire == jwire
    assert truth == jtruth and len(truth) == 2
    assert {k: getattr(hdr, k) for k in ("nbits", "nchans", "tsamp", "fch1",
                                         "foff", "tstart", "N")} == \
        {k: getattr(jhdr, k) for k in ("nbits", "nchans", "tsamp", "fch1",
                                       "foff", "tstart", "N")}


@pytest.mark.parametrize("seed", [0, 5])
def test_make_beam_feeds_equal_jax(jtool, seed):
    kw = dict(seed=seed, seconds=4.0, nchan=16, t_margin=0.5,
              pulse_beams=(1,))
    hdr, datas, t_sig, t_rfi = stl.make_beam_feeds(3, **kw)
    jhdr, jdatas, jt_sig, jt_rfi = jtool.make_beam_feeds(3, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(datas, jdatas))
    assert len(datas) == 3 and (t_sig, t_rfi) == (jt_sig, jt_rfi)
    assert hdr.N == jhdr.N and hdr.nchans == jhdr.nchans


def test_run_trial_burst_equals_jax(tmp_path, jtool):
    """A burst feed through the port's stream on the CPU: every pulse
    triggers once at the right DM, as in the JAX tool's run on the same
    arguments."""
    got = stl.run_trial(str(tmp_path / "port"), device="cpu", **TRIAL)
    want = jtool.run_trial(str(tmp_path / "jax"), **TRIAL)
    assert got["ok"] and want["ok"], (got, want)
    assert got["pulse_times"] == want["pulse_times"]
    assert got["missed"] == got["duplicated"] == got["unmatched"] == []
    assert got["triggers"] == want["triggers"] == 2
    assert got["source"]["dropped_spectra"] == 0
    assert got["latency_samples"] >= 2
    assert set(got) - {"device"} == set(want) and got["device"] == "cpu"


def test_run_beam_trial_two_beams(tmp_path):
    v = stl.run_beam_trial(str(tmp_path), nbeams=2, beam_counts=(2,),
                           seconds=8.0, nchan=32, device="cpu")
    assert v["ok"], v
    assert v["byte_equal"] and v["o1_dispatch"]
    assert v["veto"]["recall"] == v["veto"]["precision"] == 1.0
    assert v["veto"]["signal_kept"] == 2 and not v["veto"]["rfi_leaked"]


def test_out_writes_only_where_told(tmp_path, capsys):
    before = sorted(os.listdir(ROOT))
    out = tmp_path / "verdict.json"
    rc = stl.main(["--mode", "burst", "--seconds", "12", "--pulses", "2",
                   "--nchan", "32", "--device", "cpu", "--workdir",
                   str(tmp_path / "w"), "--out", str(out)])
    assert rc == 0
    with open(out) as f:
        v = json.load(f)
    assert v["ok"] and v == json.loads(capsys.readouterr().out)
    assert sorted(os.listdir(ROOT)) == before


def test_cli_has_every_jax_flag_and_device():
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    want = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            want |= {a.value for a in node.args
                     if isinstance(a, ast.Constant)}
    got = {o for a in stl.build_parser()._actions for o in a.option_strings}
    assert want <= got
    assert got - want - {"-h", "--help"} == {"--device", "-device"}
    assert stl.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("argv", [[], ["--beams", "2"]])
def test_cli_needs_a_card(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        stl.main(argv + ["--workdir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
