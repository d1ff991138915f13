"""The port's prepdata (apps/prepdata.py) against the JAX package's, on
the CPU.

Both CLIs run with the same arguments, each in its own directory under
the same output name, on a small seeded filterbank (2^15 spectra x 32
channels, a dispersed pulsar, the Crab's position so barycentring
runs).  Tolerance: none.  The .dat (or .sdat) and .inf files are
byte-equal, for every case: the channel-ordered float32 shift-and-sum
is the JAX package's add order, and the clip, mask, downsample,
resample and pad are the same host NumPy code.
"""

import os

import numpy as np
import pytest
import torch

from presto_tpu.apps import prepdata as japp
from presto_tpu.apps import rfifind as jrfi
from presto_tpu.io import psrfits as jpsr
from presto_tpu.io import sigproc as jsig
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu_torch.apps import fitsutils
from presto_tpu_torch.apps import prepdata as tapp

N, NCHAN, DT, LOFREQ, CW = 1 << 15, 32, 5e-4, 1338.0, 4.0
F0, DM = 41.3, 49.0


def _in(d, fn, *a, **kw):
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        return fn(*a, **kw)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """{"fil": the .fil, "fits": the same samples as one PSRFITS file at
    the Crab's position, "pair": the .fil cut into two .fil files,
    "mask": a JAX rfifind -time 1 mask of the .fil}."""
    d = tmp_path_factory.mktemp("prepdata_raw")
    fil = str(d / "psr.fil")
    fake_filterbank_file(fil, N, DT, NCHAN, LOFREQ, CW,
                         FakeSignal(f=F0, dm=DM, shape="gauss", width=0.04,
                                    amp=1.0), noise_sigma=6.0, seed=31)
    with jsig.FilterbankFile(fil) as fb:
        hdr = fb.header
    samples = np.fromfile(fil, np.uint8, offset=hdr.headerlen).reshape(
        hdr.N, hdr.nchans)
    freqs = hdr.fch1 + np.arange(hdr.nchans) * hdr.foff
    fits = str(d / "psr.fits")
    jpsr.write_psrfits(fits, samples, hdr.tsamp, freqs, nsblk=1024,
                       start_mjd=hdr.tstart, src_name="FAKEPSR")
    hdus = fitsutils.read_hdus(fits)
    hdus[0].set("RA", "'05:34:31.97'")
    hdus[0].set("DEC", "'+22:00:52.1'")
    hdus[0].set("TELESCOP", "'GBT'")
    fitsutils.write_hdus(fits, hdus)
    # the .fil as two files: ascending-frequency samples, header as is
    data = samples[:, ::-1].astype(np.float32)
    half = hdr.N // 2 + 333
    pair = []
    for k, (lo, hi) in enumerate(((0, half), (half, hdr.N))):
        h = jsig.FilterbankHeader(**{**hdr.__dict__})
        h.tstart = hdr.tstart + lo * hdr.tsamp / 86400.0
        p = str(d / ("part%d.fil" % k))
        jsig.write_filterbank(p, h, data[lo:hi])
        pair.append(p)
    _in(str(d / "mask"), jrfi.main, ["-time", "1", "-noplot", "-o", "m",
                                     fil])
    return {"fil": fil, "fits": fits, "pair": pair,
            "mask": str(d / "mask" / "m_rfifind.mask")}


CASES = {
    "plain": [],
    "nobary": ["-nobary"],
    "mask": ["-mask", "{mask}"],
    "zerodm_downsamp": ["-zerodm", "-downsamp", "4"],
    "ignorechan": ["-ignorechan", "0:3,17"],
    "shorts": ["-shorts", "-nobary"],
    "numout": ["-numout", "20000", "-nobary"],
    "start": ["-start", "0.3"],
    "psrfits": ["-psrfits"],
    "two_files": [],
}


def _outputs(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if f.endswith((".dat", ".sdat", ".inf"))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepdata_equals_jax(raw, tmp_path, case):
    argv = ["-dm", "%.1f" % DM, "-o", "psr"] + [
        a.format(**raw) for a in CASES[case]]
    files = ([raw["fits"]] if case == "psrfits" else
             raw["pair"] if case == "two_files" else [raw["fil"]])
    _in(str(tmp_path / "j"), japp.main, argv + files)
    _in(str(tmp_path / "t"), tapp.main, argv + files, device="cpu")
    want = _outputs(str(tmp_path / "j"))
    got = _outputs(str(tmp_path / "t"))
    suffix = ".sdat" if case == "shorts" else ".dat"
    assert sorted(got) == sorted(["psr.inf", "psr" + suffix])
    assert got == want
    inf = got["psr.inf"].decode()
    bary = [ln for ln in inf.splitlines() if "Barycentered" in ln][0]
    assert bary.rstrip().endswith("0" if "-nobary" in argv else "1")


def test_resume_skips_a_journaled_run(raw, tmp_path, capsys):
    argv = ["-dm", "%.1f" % DM, "-nobary", "-o", "psr", "-resume",
            raw["fil"]]
    _in(str(tmp_path), tapp.main, argv, device="cpu")
    first = _outputs(str(tmp_path))
    capsys.readouterr()
    _in(str(tmp_path), tapp.main, argv, device="cpu")
    assert "skipping" in capsys.readouterr().out
    assert _outputs(str(tmp_path)) == first


def test_prepdata_without_device_needs_cuda(raw, tmp_path, monkeypatch):
    """No device argument means CUDA: without a card it raises before
    writing anything (there is no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _in(str(tmp_path), tapp.main, ["-dm", "1", "-o", "x",
                                       raw["fil"]])
    assert not os.path.exists(str(tmp_path / "x.dat"))
