"""The port's PSRFITS CLIs and multi-file drift prep against the JAX
package's, on the CPU.

psrfits2fil (8-, 4- and 32-bit output, --noweights),
psrfits_quick_bandpass and the four fitsutils commands (dumparrays,
weight, delrow, delcol) write the JAX apps' bytes from the same
PSRFITS files; split_drift_scan and the drift_prep CLI cut a PSRFITS
pair and a .fil pair into the JAX package's pointing files, byte for
byte.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from presto_tpu.apps import drift_prep as jdrift_app
from presto_tpu.apps import fitsutils as jfu
from presto_tpu.apps import psrfits2fil as jp2f
from presto_tpu.apps import psrfits_quick_bandpass as jbp
from presto_tpu.io import psrfits as jpsr
from presto_tpu.io import sigproc as jsig
from presto_tpu.pipeline import driftprep as jdrift
from presto_tpu_torch.apps import drift_prep as tdrift_app
from presto_tpu_torch.apps import fitsutils as tfu
from presto_tpu_torch.apps import psrfits2fil as tp2f
from presto_tpu_torch.apps import psrfits_quick_bandpass as tbp
from presto_tpu_torch.pipeline import driftprep as tdrift

NCHAN, DT, NSBLK, MJD0 = 16, 5e-4, 512, 59000.0
FREQS = 1338.0 + 4.0 * np.arange(NCHAN)[::-1]
CRAB = ("'05:34:31.97'", "'+22:00:52.1'")


def _data(nspec, seed=3):
    rng = np.random.default_rng(seed)
    x = 100.0 + 20.0 * rng.normal(size=(nspec, NCHAN))
    return np.clip(np.round(x), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two PSRFITS files of one observation (the first's scales and
    weights not unity, a dropped row in the second) at the Crab's
    position."""
    d = tmp_path_factory.mktemp("pair")
    data = _data(1 << 14)
    half = 1 << 13
    paths = [str(d / "p1.fits"), str(d / "p2.fits")]
    wts = np.ones(NCHAN, np.float32)
    wts[4] = 0.5
    jpsr.write_psrfits(paths[0], data[:half], DT, FREQS, nsblk=NSBLK,
                       start_mjd=MJD0, weights=wts,
                       scales=np.full(NCHAN, 1.5, np.float32))
    jpsr.write_psrfits(paths[1], data[half:], DT, FREQS, nsblk=NSBLK,
                       start_mjd=MJD0 + half * DT / 86400.0, drop_rows=[3])
    for p in paths:
        hdus = tfu.read_hdus(p)
        hdus[0].set("RA", CRAB[0])
        hdus[0].set("DEC", CRAB[1])
        tfu.write_hdus(p, hdus)
    return paths


def _read(p):
    return open(p, "rb").read()


@pytest.mark.parametrize("extra", [[], ["-n", "4"], ["-n", "32"],
                                   ["--noweights"]],
                         ids=["8bit", "4bit", "32bit", "noweights"])
def test_psrfits2fil_equals_jax(pair, tmp_path, extra):
    a, b = str(tmp_path / "j.fil"), str(tmp_path / "t.fil")
    assert jp2f.main(extra + ["-o", a] + pair) == 0
    assert tp2f.main(extra + ["-o", b] + pair) == 0
    assert _read(b).replace(b"t.fil", b"j.fil") == _read(a)
    assert os.path.getsize(b) > NCHAN * (1 << 14) * 4 // 8


@pytest.mark.parametrize("nsub", ["16", "3"])
def test_quick_bandpass_equals_jax(pair, tmp_path, nsub):
    a, b = str(tmp_path / "j.bandpass"), str(tmp_path / "t.bandpass")
    assert jbp.main(["-nsub", nsub, "-o", a] + pair) == 0
    assert tbp.main(["-nsub", nsub, "-o", b] + pair) == 0
    assert _read(b) == _read(a) and _read(b).count(b"\n") == NCHAN + 1


def test_quick_bandpass_plot_is_refused(pair, tmp_path, monkeypatch):
    """-plot is refused with ImportError naming matplotlib, before any
    file is read, where matplotlib is missing; with it the plot is the
    JAX CLI's, byte for byte."""
    out = str(tmp_path / "t.bandpass")
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules
                     if k.startswith("matplotlib.")] + ["matplotlib"]:
            m.setitem(sys.modules, name, None)
        with pytest.raises(ImportError, match="matplotlib"):
            tbp.main(["-plot", "-o", out] + pair)
        assert not os.path.exists(out)
    ref = str(tmp_path / "j.bandpass")
    assert jbp.main(["-plot", "-o", ref] + pair) == 0
    assert tbp.main(["-plot", "-o", out] + pair) == 0
    assert _read(out) == _read(ref)
    assert _read(out + ".png") == _read(ref + ".png")


@pytest.mark.parametrize("cmd", ["dumparrays", "weight", "delrow",
                                 "delcol"])
def test_fitsutils_equal_jax(pair, tmp_path, cmd):
    outs = []
    for mod, side in ((jfu, "j"), (tfu, "t")):
        d = tmp_path / side
        d.mkdir()
        src = str(d / "in.fits")
        open(src, "wb").write(_read(pair[0]))
        out = str(d / "out.fits")
        argv = {"dumparrays": ["dumparrays", "-rows", "0,2", src],
                "weight": ["weight", "-wts", str(d / "w.txt"), src],
                "delrow": ["delrow", "2", "4", src, "-o", out],
                "delcol": ["delcol", "DAT_OFFS", src, "-o", out]}[cmd]
        np.savetxt(str(d / "w.txt"), np.column_stack(
            [np.arange(NCHAN), np.linspace(0.0, 1.0, NCHAN)]))
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main(argv) == 0
        outs.append((buf.getvalue().replace(str(d), ""),
                     _read(out if os.path.exists(out) else src)))
    assert outs[1] == outs[0]
    if cmd == "dumparrays":
        assert "DAT_WTS[row 2]" in outs[1][0]


def _fil_pair(d):
    data = _data(1 << 14, seed=9)
    paths = [str(d / "s1.fil"), str(d / "s2.fil")]
    for p, lo, hi in ((paths[0], 0, 6000), (paths[1], 6000, 1 << 14)):
        jsig.write_filterbank(p, jsig.FilterbankHeader(
            nchans=NCHAN, nbits=8, tsamp=DT, fch1=FREQS[0], foff=-4.0,
            tstart=MJD0 + lo * DT / 86400.0, telescope_id=6,
            src_raj=53431.97, src_dej=220052.1), data[lo:hi, ::-1])
    return paths


@pytest.mark.parametrize("kind", ["psrfits", "fil"])
def test_split_drift_scan_of_a_pair_equals_jax(pair, tmp_path, kind):
    scan = pair if kind == "psrfits" else _fil_pair(tmp_path)
    kw = dict(orig_N=4096, overlap_factor=0.5, prefix="drift")
    want = jdrift.split_drift_scan(scan, outdir=str(tmp_path / "j"), **kw)
    got = tdrift.split_drift_scan(scan, outdir=str(tmp_path / "t"), **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == (1 << 14) // 2048 - 1
    for a, b in zip(want, got):
        assert _read(b) == _read(a)
    outs = []
    for app in (jdrift_app, tdrift_app):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert app.main(["-nmax", "-orign", "4096"] + scan) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0].splitlines()[0] == "6"
