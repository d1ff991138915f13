"""The port on a two-file PSRFITS beam against the JAX package, on the CPU.

The beam of tests/test_torch_survey_slice.py (2^16 8-bit spectra of 32
channels, a 41.3 Hz pulsar at DM 49) is written as two PSRFITS files of
2^15 spectra each (rows of 1024 spectra, the .fil's descending band,
unit scales), the second starting where the first ends.  Under 8-bit
samples and unit scales the decoded spectra are the .fil's, so the
port's products of the pair equal the JAX package's, byte for byte:
rfifind's .mask, .inf and quality report (-time and -blocks), and
prepsubband's .dat/.inf (topocentric; barycentred once the header
carries the Crab's position at GBT, patched in with the port's
fitsutils), masked, and its -sub .sub####/.sub.inf.  A raw prepfold of
the first file with -mask and -ignorechan holds its .pfd bytes to the
JAX package's, and its .bestprof by tests/test_torch_prepfold.py's rule
(a searched one: its chi2 surfaces within MASKED_SURFACE_RTOL of their
peak).  run_survey on the
pair gives the JAX run's .dat bytes, its ACCEL candidates within the
polish tolerances (tests/test_torch_polish.py) and its sifted list
within 2e-3 bins (tests/test_torch_survey_slice.py), and the .dat bytes
of the port's own run on the .fil.
"""

import glob
import os

import numpy as np
import pytest

from presto_tpu.apps import prepfold as jfold
from presto_tpu.apps import prepsubband as jprep
from presto_tpu.apps import rfifind as jrfi
from presto_tpu.io import psrfits as jpsr
from presto_tpu.io import sigproc as jsig
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.pipeline import survey as jsurvey
from presto_tpu.serve import plancache as jplan
from presto_tpu_torch.apps import fitsutils
from presto_tpu_torch.apps import prepfold as tfold
from presto_tpu_torch.apps import prepsubband as tprep
from presto_tpu_torch.apps import rfifind as trfi
from presto_tpu_torch.parallel import mesh
from presto_tpu_torch.pipeline import survey as tsurvey
from presto_tpu_torch.serve import plancache as tplan
from test_torch_prepfold import assert_bestprof_agree
from test_torch_survey_slice import (_accel_agree, _config, _jax_tpu_path,
                                     assert_sifted_agree)

N, NCHAN, DT, LOFREQ, CW = 1 << 16, 32, 5e-4, 1338.0, 4.0
F0, DM = 41.3, 49.0
NSBLK = 1024
PREP = ["-lodm", "46", "-dmstep", "1.5", "-numdms", "4", "-nsub", "8"]


def write_pair(fil, d, nsblk=NSBLK):
    """The .fil's samples as two PSRFITS files (the first half, then the
    second starting where it ends), its band order and start MJD."""
    with jsig.FilterbankFile(fil) as fb:
        hdr = fb.header
    raw = np.fromfile(fil, np.uint8, offset=hdr.headerlen).reshape(
        hdr.N, hdr.nchans)
    freqs = hdr.fch1 + np.arange(hdr.nchans) * hdr.foff
    half = hdr.N // 2
    paths = [os.path.join(d, "a.fits"), os.path.join(d, "b.fits")]
    for p, lo, hi in ((paths[0], 0, half), (paths[1], half, hdr.N)):
        jpsr.write_psrfits(p, raw[lo:hi], hdr.tsamp, freqs, nsblk=nsblk,
                           start_mjd=hdr.tstart + lo * hdr.tsamp / 86400.0,
                           src_name="FAKEPSR")
    return paths


def position(paths, d):
    """Copies of ``paths`` in ``d`` whose primary headers carry the
    Crab's position and GBT."""
    out = []
    for p in paths:
        hdus = fitsutils.read_hdus(p)
        hdus[0].set("RA", "'05:34:31.97'")
        hdus[0].set("DEC", "'+22:00:52.1'")
        hdus[0].set("TELESCOP", "'GBT'")
        out.append(os.path.join(d, os.path.basename(p)))
        fitsutils.write_hdus(out[-1], hdus)
    return out


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    d = tmp_path_factory.mktemp("psrfits_beam")
    fil = str(d / "psr.fil")
    fake_filterbank_file(fil, N, DT, NCHAN, LOFREQ, CW,
                         FakeSignal(f=F0, dm=DM, shape="gauss", width=0.04,
                                    amp=1.0), noise_sigma=6.0, seed=21)
    pair = write_pair(fil, str(d))
    (d / "pos").mkdir()
    return fil, pair, position(pair, str(d / "pos"))


def _files(d, suffixes):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(suffixes)}


def _in(d, fn, *a, **kw):
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        return fn(*a, **kw)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def masks(beam, tmp_path_factory):
    """rfifind -time 1 of the pair by each package: {side: directory}."""
    _fil, pair, _pos = beam
    d = tmp_path_factory.mktemp("masks")
    out = {}
    for side, run in (("j", jrfi.main),
                      ("t", lambda a: trfi.main(a, device="cpu"))):
        out[side] = str(d / side)
        _in(out[side], run, ["-time", "1", "-noplot", "-o", "m"] + pair)
    return out


@pytest.mark.parametrize("flags", [["-time", "1"], ["-blocks", "3"]],
                         ids=["time", "blocks"])
def test_rfifind_on_the_pair_equals_jax(beam, masks, tmp_path, flags):
    _fil, pair, _pos = beam
    if flags[0] == "-time":
        dirs = masks
    else:
        dirs = {"j": str(tmp_path / "j"), "t": str(tmp_path / "t")}
        _in(dirs["j"], jrfi.main, flags + ["-noplot", "-o", "m"] + pair)
        _in(dirs["t"], trfi.main, flags + ["-noplot", "-o", "m"] + pair,
            device="cpu")
    outs = (".mask", ".inf", "_quality.json")
    want, got = _files(dirs["j"], outs), _files(dirs["t"], outs)
    assert sorted(got) == ["m_rfifind.inf", "m_rfifind.mask",
                           "m_rfifind_quality.json"]
    assert got == want
    from presto_tpu_torch.io.maskfile import read_mask
    m = read_mask(os.path.join(dirs["t"], "m_rfifind.mask"))
    per = 3 * NSBLK if flags[0] == "-blocks" else int(1.0 / DT + 0.5)
    assert m.numint == N // per
    inf = open(os.path.join(dirs["t"], "m_rfifind.inf")).read()
    assert "FAKE_SCOPE" in inf and "FAKEPSR" in inf


@pytest.mark.parametrize("case", ["topo", "bary", "mask", "flags"])
def test_prepsubband_psrfits_equals_jax(beam, masks, tmp_path, monkeypatch,
                                        case):
    """.dat/.inf bytes of -psrfits on the pair: topocentric (-nobary, a
    header with no position), barycentred (the positioned pair), with
    the pair's rfifind mask, and with -noscales -noweights."""
    _fil, pair, pos = beam
    monkeypatch.setenv("PRESTO_TPU_DISABLE_MESH", "1")
    argv = PREP + ["-o", "psr", "-psrfits"]
    files = pos if case == "bary" else pair
    if case != "bary":
        argv += ["-nobary"]
    if case == "mask":
        argv += ["-mask", os.path.join(masks["j"], "m_rfifind.mask")]
    if case == "flags":
        argv += ["-noscales", "-noweights", "-nooffsets"]
    _in(str(tmp_path / "j"), jprep.main, argv + files)
    _in(str(tmp_path / "t"), tprep.main, argv + files, device="cpu")
    want = _files(str(tmp_path / "j"), (".dat", ".inf"))
    got = _files(str(tmp_path / "t"), (".dat", ".inf"))
    assert len(got) == 8 and got == want
    inf = got["psr_DM49.00.inf"].decode()
    bary = [ln for ln in inf.splitlines() if "Barycentered" in ln][0]
    assert bary.rstrip().endswith("1" if case == "bary" else "0")
    if case == "bary":
        assert "GBT" in inf and "05:34:31.97" in inf


@pytest.mark.parametrize("case", ["topo", "bary", "mesh"])
def test_sub_equals_jax(beam, tmp_path, monkeypatch, case):
    """-sub -subdm 49: the truncated int16 subbands and the .sub.inf
    byte-equal (barycentred: the diffbins applied to every subband); a
    mesh of logical shards leaves -sub on one device."""
    _fil, pair, pos = beam
    monkeypatch.setenv("PRESTO_TPU_DISABLE_MESH", "1")
    argv = PREP + ["-sub", "-subdm", "49", "-o", "psr"]
    files = pos if case == "bary" else pair
    if case != "bary":
        argv += ["-nobary"]
    _in(str(tmp_path / "j"), jprep.main, argv + files)
    if case == "mesh":
        monkeypatch.delenv("PRESTO_TPU_DISABLE_MESH")
        with mesh.set_logical_devices(2, "cpu"):
            _in(str(tmp_path / "t"), tprep.main, argv + files, device="cpu")
    else:
        _in(str(tmp_path / "t"), tprep.main, argv + files, device="cpu")
    want = _files(str(tmp_path / "j"), tuple(
        [".sub.inf"] + [".sub%04d" % k for k in range(8)]))
    got = _files(str(tmp_path / "t"), tuple(
        [".sub.inf"] + [".sub%04d" % k for k in range(8)]))
    assert len(got) == 9 and got == want
    assert len(got["psr_DM49.00.sub0000"]) >= 2 * (N - 200)


def test_elastic_sub_is_refused(beam, tmp_path):
    _fil, pair, _pos = beam
    with pytest.raises(SystemExit, match="-elastic does not support -sub"):
        _in(str(tmp_path), tprep.main,
            PREP + ["-sub", "-elastic", "-nobary", "-o", "psr"] + pair,
            device="cpu")


# a searched fold of masked data: the mask's padding values are not
# integers, so the chi2 sums round in each package's order; surfaces are
# held within this fraction of their peak (the integer samples of
# tests/test_torch_prepfold.py sum exactly, within its 1e-5)
MASKED_SURFACE_RTOL = 1e-4


@pytest.mark.parametrize("case", ["mask_ignorechan", "mask", "ignorechan",
                                  "searched"])
def test_raw_prepfold_mask_ignorechan_equals_jax(beam, masks, tmp_path,
                                                 case):
    """prepfold -psrfits of the first file with -mask and/or -ignorechan:
    with -nosearch the .pfd bytes are equal and the .bestprof agrees by
    the prepfold rule; with the DM and (p, pd) search the same best
    trial and .pfd bytes, the surfaces within MASKED_SURFACE_RTOL of
    their peak."""
    _fil, pair, _pos = beam
    argv = ["-f", str(F0), "-dm", "48.0", "-n", "32", "-npart", "16",
            "-nsub", "8", "-npfact", "1", "-ndmfact", "1", "-noplot",
            "-psrfits", "-o", "fold"]
    if case != "searched":
        argv += ["-nosearch"]
    if "ignorechan" in case or case == "searched":
        argv += ["-ignorechan", "3,17:18"]
    if "mask" in case or case == "searched":
        argv += ["-mask", os.path.join(masks["j"], "m_rfifind.mask")]
    argv += [pair[0]]
    outs = ["fold.pfd", "fold.pfd.bestprof"]
    jres = _in(str(tmp_path), jfold.run, jfold.build_parser().parse_args(
        list(argv)))
    want = {o: open(os.path.join(tmp_path, o), "rb").read() for o in outs}
    for o in outs:
        os.remove(os.path.join(tmp_path, o))
    tres = _in(str(tmp_path), tfold.run, tfold.build_parser().parse_args(
        list(argv)), device="cpu")
    got = {o: open(os.path.join(tmp_path, o), "rb").read() for o in outs}
    assert got["fold.pfd"] == want["fold.pfd"]
    if case != "searched":
        assert_bestprof_agree(want["fold.pfd.bestprof"],
                              got["fold.pfd.bestprof"])
        return
    for a in ("dm_chi2", "ppd_chi2"):
        w, g = np.asarray(getattr(jres, a)), np.asarray(getattr(tres, a))
        np.testing.assert_allclose(
            g, w, rtol=0, atol=MASKED_SURFACE_RTOL * np.abs(w).max())
    for a in ("best_dm", "best_f", "best_fd"):
        assert getattr(tres, a) == getattr(jres, a), a


@pytest.fixture(scope="module")
def surveys(beam, tmp_path_factory):
    """run_survey on the pair by each package (rfifind on), and the
    port's survey_head on the .fil."""
    fil, pair, _pos = beam
    d = tmp_path_factory.mktemp("surveys")
    jwork, twork, fwork = str(d / "jax"), str(d / "torch"), str(d / "fil")
    cfg = dict(skip_rfifind=False, rfi_time=1.0)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jres = jsurvey.run_survey(pair, _config(jsurvey, **cfg), jwork)
    tres = tsurvey.run_survey(pair, _config(tsurvey, **cfg), twork,
                              device="cpu")
    tsurvey.survey_head([fil], _config(tsurvey, **cfg), fwork,
                        device="cpu")
    return jwork, twork, fwork, jres, tres


def test_run_survey_on_the_pair_equals_jax(surveys):
    """The same artifacts; .dat and .mask byte-equal to the JAX run's and
    the .dat to the port's run on the .fil; ACCEL tables by the polish
    tolerances; the sifted list by the survey slice's rule, the pulsar
    on top."""
    jwork, twork, fwork, jres, tres = surveys
    kinds = (".dat", ".inf", ".fft", "_ACCEL_20", ".cand", ".singlepulse",
             ".mask", ".stats", "cands_sifted.txt")
    names = sorted(n for n in os.listdir(jwork) if n.endswith(kinds))
    assert names == sorted(n for n in os.listdir(twork)
                           if n.endswith(kinds))
    dats = sorted(n for n in names if n.endswith(".dat"))
    assert len(dats) == 8 and dats[0].startswith("a_DM")
    for n in dats + ["a_rfifind.mask"]:
        assert open(os.path.join(twork, n), "rb").read() == \
            open(os.path.join(jwork, n), "rb").read(), n
    for n in dats:
        assert open(os.path.join(twork, n), "rb").read() == open(
            os.path.join(fwork, "psr" + n[1:]), "rb").read(), n
    accs = sorted(glob.glob(os.path.join(twork, "*_ACCEL_20.cand")))
    assert len(accs) == 8
    for a in accs:
        _accel_agree(os.path.join(jwork, os.path.basename(a)), a)
    assert_sifted_agree(jres.sifted, tres.sifted)
    assert tres.sifted[0].DM == DM
    inf = open(os.path.join(twork, dats[0][:-4] + ".inf")).read()
    assert "FAKE_SCOPE" in inf and "FAKEPSR" in inf


def test_bucket_key_of_the_pair_equals_jax(beam):
    _fil, pair, _pos = beam
    want = jplan.bucket_key(pair, _config(jsurvey))
    got = tplan.bucket_key(pair, _config(tsurvey))
    assert (got.kind, got.nchan, got.nsamp, got.dtype, got.dm_block,
            got.zmax, got.numharm) == (want.kind, want.nchan, want.nsamp,
                                       want.dtype, want.dm_block,
                                       want.zmax, want.numharm)
    assert got.dtype == "uint8" and got.nchan == NCHAN
