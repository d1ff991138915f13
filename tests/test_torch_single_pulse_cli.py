"""The port's single_pulse_search CLI against the JAX package's.

Seeded .dat/.inf inputs (two with onoff padding, one with a padding gap
inside the data, one at another dt, so the CLI batches three (length,
dt) groups) are searched by each package's CLI in a directory of its
own, across -f, -b, -d 2, -s/-e and -m/-t.  Each .singlepulse pair and
the returned event lists are held by singlepulse.agreement (files
byte-equal where no line is near a boundary); .singlepulse inputs are
read back alike.  A run that finds events draws the summary plot, and is
refused where matplotlib is missing.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from presto_tpu.apps import single_pulse_search as japp
from presto_tpu.io.datfft import write_dat
from presto_tpu.io.infodata import InfoData
from presto_tpu_torch.apps import single_pulse_search as tapp
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.search.singlepulse import agreement, file_agreement

# (name, N, dt, DM, onoff): padding after 30000 samples; a gap at
# 15000-18000 plus the tail; no padding; another dt
INPUTS = (("a_DM30.00", 40000, 1e-3, 30.0, [(0, 29999), (39999, 39999)]),
          ("b_DM31.50", 40000, 1e-3, 31.5,
           [(0, 14999), (18000, 29999), (39999, 39999)]),
          ("c_DM33.00", 40000, 1e-3, 33.0, []),
          ("d_DM60.00", 20000, 2e-3, 60.0, []))


def _series(i, n, onoff):
    rng = np.random.default_rng(40 + i)
    x = rng.normal(100.0, 3.0, n).astype(np.float32)
    x += np.linspace(0, 9, n).astype(np.float32)
    for p, w, a in ((2345, 3, 15.0), (5000, 1, 24.0), (7001, 12, 6.0),
                    (9500, 6, 9.0), (12000, 27, 4.5),
                    (25000 - 1000 * i, 1, 25.0), (27000, 4, 12.0),
                    (29990, 20, 5.0)):
        if p + w <= n:
            x[p:p + w] += a
    x[21000:22000] *= 1.0 + 6.0 * (i == 2)     # a noisy block
    for (_on, off), (on2, _off2) in zip(onoff[:-1], onoff[1:]):
        x[int(off) + 1:int(on2)] = 100.0             # padding values
    if onoff:
        x[int(onoff[-2][1]) + 1:] = 100.0
    return x


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spin")
    for i, (name, n, dt, dm, onoff) in enumerate(INPUTS):
        info = InfoData(telescope="GBT", dt=dt, dm=dm, N=n,
                        numonoff=max(len(onoff), 1),
                        onoff=[(float(a), float(b)) for a, b in onoff],
                        freq=1300.0, chan_wid=1.0, num_chan=64,
                        freqband=64.0)
        write_dat(str(d / (name + ".dat")), _series(i, n, onoff), info)
    return d


def _copy(inputs, dest):
    os.makedirs(dest)
    for name, *_r in INPUTS:
        for ext in (".dat", ".inf"):
            shutil.copy(os.path.join(inputs, name + ext), dest)
    return [os.path.join(dest, name + ".dat") for name, *_r in INPUTS]


def _run_both(tmp_path, inputs, flags):
    jdats = _copy(inputs, str(tmp_path / "j"))
    tdats = _copy(inputs, str(tmp_path / "t"))
    want = japp.run(japp.build_parser().parse_args(flags + ["-p"] + jdats))
    got = tapp.run(tapp.build_parser().parse_args(flags + ["-p"] + tdats),
                   device="cpu")
    return jdats, tdats, want, got


def test_input_plans_match_jax(inputs):
    from presto_tpu.io.infodata import read_inf as jread
    jinfos = [jread(str(inputs / name)) for name, *_r in INPUTS]
    tinfos = [read_inf(str(inputs / name)) for name, *_r in INPUTS]
    for (name, n, *_r), ji, ti in zip(INPUTS, jinfos, tinfos):
        assert tapp.sp_input_plan(ti, n) == japp.sp_input_plan(ji, n)
    assert tapp.sp_input_plan(tinfos[0], 40000)[0] == 30000
    for sel in ([0], [0, 1], [2, 3], [0, 3]):
        assert tapp.sp_block_plan([tinfos[i] for i in sel], 40000) == \
            japp.sp_block_plan([jinfos[i] for i in sel], 40000)


@pytest.mark.parametrize("flags", [[], ["-f"], ["-b"], ["-d", "2"],
                                   ["-s", "5.0", "-e", "25.0"],
                                   ["-m", "0.005", "-t", "4.5"]],
                         ids=["default", "fast", "nobadblocks", "detrend2",
                              "start_end", "maxwidth_threshold"])
def test_cli_matches_jax(tmp_path, inputs, flags):
    jdats, tdats, want, got = _run_both(tmp_path, inputs, flags)
    thr = float(flags[flags.index("-t") + 1]) if "-t" in flags else 5.0
    r = agreement(want, got, thr)
    assert r["ok"], r
    assert len(got) >= 8
    same = 0
    for a, b in zip(jdats, tdats):
        fa = file_agreement(a[:-4] + ".singlepulse", b[:-4] + ".singlepulse",
                            thr)
        assert fa["ok"], fa
        assert fa["same_bytes"] or fa["boundary"] or fa["one_sided"], fa
        same += fa["same_bytes"]
    assert same >= 3
    if "-s" in flags:
        assert all(5.0 <= c.time <= 25.0 for c in got)


def test_cli_reads_singlepulse_inputs_like_jax(tmp_path, inputs):
    """.singlepulse inputs are read back (no search): the events within
    -s/-e at or above -t, mixed with a .dat input."""
    jdats, tdats, _w, _g = _run_both(tmp_path, inputs, [])
    flags = ["-p", "-t", "6", "-s", "2", "-e", "28"]
    want = japp.run(japp.build_parser().parse_args(
        flags + [p[:-4] + ".singlepulse" for p in jdats[:3]] + jdats[3:]))
    got = tapp.run(tapp.build_parser().parse_args(
        flags + [p[:-4] + ".singlepulse" for p in tdats[:3]] + tdats[3:]),
        device="cpu")
    assert [str(c) for c in got] == [str(c) for c in want]
    assert len(got) >= 3


def test_cli_refuses_a_run_that_would_plot(tmp_path, inputs, monkeypatch):
    """Where matplotlib is missing, a run without -p that finds events is
    refused with ImportError naming matplotlib (after writing its
    .singlepulse files); a run without events has nothing to plot, and
    -p runs.  With matplotlib the summary plot is drawn beside the first
    input (tests/test_torch_plots.py holds it to the JAX CLI's)."""
    tdats = _copy(inputs, str(tmp_path / "t"))
    png = tdats[0][:-4] + "_singlepulse.png"
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules
                     if k.startswith("matplotlib.")] + ["matplotlib"]:
            m.setitem(sys.modules, name, None)
        with pytest.raises(ImportError, match="matplotlib"):
            tapp.main(tdats, device="cpu")
        assert all(os.path.exists(p[:-4] + ".singlepulse") for p in tdats)
        assert tapp.main(["-t", "1000"] + tdats, device="cpu") == 0
        assert tapp.main(["-p"] + tdats, device="cpu") == 0
        assert not os.path.exists(png)
    assert tapp.main(tdats, device="cpu") == 0
    with open(png, "rb") as f:
        assert f.read(4) == b"\x89PNG"
