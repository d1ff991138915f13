"""The port's DM-sharded survey against the JAX package's, on 8 logical
CPU shards.

A seeded synthetic pulsar filterbank (test_torch_survey_slice's beam)
goes through the JAX package's run_survey on its 8-device CPU mesh (its
TPU search engine in interpret mode; the Pallas kernels inside its
shard_map need the map's varying-axes check off, set on the JAX module's
own shard_map handle in this test only), and through the port's
run_survey on a mesh of 8 logical CPU shards and on one device.  The
.dat files are byte-equal, the ACCEL files, sifted lists and
.singlepulse files agree by test_torch_survey_slice's rules.  The
sharded run's .dat and .singlepulse bytes equal the one-device run's;
its spectra come from per-shard FFTs, whose batches differ from the
one-device run's, so its ACCEL files agree by the polish rule.
"""

import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from presto_tpu.apps import prepsubband as jprep
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.parallel import sharded as jsharded
from presto_tpu.pipeline import survey as jsurvey
from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas, build_pallas
from presto_tpu_torch.apps import prepsubband as tprep
from presto_tpu_torch.parallel import mesh as tmesh
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.pipeline import survey as tsurvey
from presto_tpu_torch.search.singlepulse import file_agreement
from test_torch_survey_slice import (DMS, N, SP_THRESHOLD, _accel_agree,
                                     _config, assert_sifted_agree)

NSHARD = 8


def _jax_sharded_path(mp):
    """The JAX package's TPU search engine on the CPU, on its 8-device
    mesh."""
    assert len(jax.devices()) == NSHARD, "conftest forces 8 CPU devices"
    mp.setattr(accel_pallas, "pallas_available", lambda: True)
    mp.setattr(jaccel, "_use_mxu_engine", lambda fftlen: fftlen % 256 == 0)
    mp.setattr(build_pallas, "make_plane_builder",
               functools.partial(build_pallas.make_plane_builder,
                                 interpret=True))
    mp.setattr(accel_pallas, "make_stage_reducer",
               functools.partial(accel_pallas.make_stage_reducer,
                                 interpret=True))
    mp.setattr(jsharded, "_shard_map",
               functools.partial(jax.shard_map, check_vma=False))
    mp.delenv("PRESTO_TPU_DISABLE_MESH", raising=False)


def _sharded():
    return tmesh.set_logical_devices(NSHARD, "cpu")


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, N, 5e-4, 32, 1338.0, 4.0,
                         FakeSignal(f=41.3, dm=49.0, shape="gauss",
                                    width=0.04, amp=1.0),
                         noise_sigma=6.0, seed=21)
    return raw


@pytest.fixture(scope="module")
def runs(beam, tmp_path_factory):
    """(JAX sharded workdir, port sharded workdir, port one-device
    workdir, their three results)."""
    d = tmp_path_factory.mktemp("survey")
    jwork, swork, uwork = (str(d / x) for x in ("jax", "sharded", "one"))
    with pytest.MonkeyPatch.context() as mp:
        _jax_sharded_path(mp)
        jres = jsurvey.run_survey([beam], _config(jsurvey), jwork)
    with _sharded():
        sres = tsurvey.run_survey([beam], _config(tsurvey), swork,
                                  device="cpu")
    ures = tsurvey.run_survey([beam], _config(tsurvey), uwork, device="cpu")
    return jwork, swork, uwork, jres, sres, ures


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("downsamp", [1, 2])
def test_prepsubband_mesh_bytes_equal_unsharded_and_jax(beam, tmp_path,
                                                        monkeypatch,
                                                        downsamp):
    """prepsubband on the mesh (16 DMs over 8 shards) writes .dat and .inf
    bytes equal to the port's one-device run and the JAX package's
    sharded run (each run in its own directory, -o relative, so the .inf
    names match)."""
    argv = ["-lodm", "40", "-dmstep", "1.5", "-numdms", "16", "-nsub", "8",
            "-downsamp", str(downsamp), "-nobary", "-o", "psr", beam]
    dirs = {k: tmp_path / k for k in ("mesh", "one", "jax")}
    for k, p in dirs.items():
        p.mkdir()
        monkeypatch.chdir(p)
        if k == "mesh":
            with _sharded():
                tprep.main(argv, device="cpu")
        elif k == "one":
            tprep.main(argv, device="cpu")
        else:
            with pytest.MonkeyPatch.context() as mp:
                _jax_sharded_path(mp)
                jprep.main(argv)
    names = sorted(os.listdir(dirs["mesh"]))
    assert len([n for n in names if n.endswith(".dat")]) == 16
    for k in ("one", "jax"):
        assert sorted(os.listdir(dirs[k])) == names
    for n in names:
        got = _bytes(dirs["mesh"] / n)
        assert got == _bytes(dirs["one"] / n), n
        assert got == _bytes(dirs["jax"] / n), n


def test_mesh_refuses_what_it_cannot_split(beam, tmp_path, monkeypatch,
                                           capsys):
    """numdms that does not divide the shards, or the disable variable,
    runs on one device and says why; a multi-process run would raise
    instead (test_torch_elastic)."""
    monkeypatch.chdir(tmp_path)
    argv = ["-lodm", "40", "-dmstep", "1.5", "-numdms", "12", "-nsub", "8",
            "-nobary", "-o", "psr", beam]
    with _sharded():
        tprep.main(argv, device="cpu")
        assert "numdms=12 is not divisible by 8" in capsys.readouterr().out
        monkeypatch.setenv(tprep.DISABLE_MESH_ENV, "1")
        tprep.main(argv[:5] + ["16"] + argv[6:], device="cpu")
        assert "%s is set" % tprep.DISABLE_MESH_ENV in \
            capsys.readouterr().out


def test_seam_block_is_sharded_and_gathers_the_same_bytes(beam, tmp_path):
    """The mesh's seam block holds one [1, numout] tensor a shard in its
    row range; gather_shards of them, the block's host copy and the
    one-device block's host copy are the same bytes; ensure_dat, spill
    and release work on it as on a one-device block."""
    cfg = _config(tsurvey, durable_stages=False)
    with _sharded():
        seam = tsurvey.survey_head(beam, cfg, str(tmp_path / "s"),
                                   device="cpu")
    one = tsurvey.survey_head(beam, cfg, str(tmp_path / "o"), device="cpu")
    (block,), (ref,) = seam.blocks, one.blocks
    assert fusion.is_sharded(block) and not fusion.is_sharded(ref)
    assert block.mesh.size == NSHARD
    assert block.row_ranges == [(k, k + 1) for k in range(NSHARD)]
    assert [tuple(p.shape) for p in block.series_dev] == \
        [(1, block.numout)] * NSHARD
    host = fusion.gather_shards(block.series_dev, block.row_ranges)
    assert host.tobytes() == block.series_host.tobytes() == \
        ref.series_host.tobytes() == ref.series_dev.numpy().tobytes()
    for r in range(NSHARD):
        assert torch.equal(block.row_on(r, "cpu"), ref.series_dev[r])
    assert not any(n.endswith(".dat") for n in os.listdir(tmp_path / "s"))
    # the non-durable tier spills one trial on demand from the host copy
    name = os.path.basename(block.names[3]) + ".dat"
    assert seam.ensure_dat(str(tmp_path / "s" / name))
    assert one.ensure_dat(str(tmp_path / "o" / name))
    assert _bytes(tmp_path / "s" / name) == _bytes(tmp_path / "o" / name)
    assert seam.spill(block) == block.series_host.nbytes
    seam.release(block)
    assert block.series_dev is None


def test_sharded_survey_matches_jax_sharded(runs):
    """The same artifact set as the JAX package's sharded run; .dat
    byte-equal; every ACCEL file by the polish rules; the sifted list;
    every .singlepulse by singlepulse.agreement."""
    jwork, swork, _u, jres, sres, _ures = runs
    names = sorted(os.listdir(jwork))
    assert names == sorted(os.listdir(swork))
    for n in names:
        if n.endswith(".dat"):
            assert _bytes(os.path.join(jwork, n)) == \
                _bytes(os.path.join(swork, n)), n
    for dm in DMS:
        name = "psr_DM%s_ACCEL_20.cand" % dm
        _accel_agree(os.path.join(jwork, name), os.path.join(swork, name))
        sp = "psr_DM%s.singlepulse" % dm
        r = file_agreement(os.path.join(jwork, sp), os.path.join(swork, sp),
                           SP_THRESHOLD)
        assert r["ok"], (sp, r)
    assert_sifted_agree(jres.sifted, sres.sifted)
    assert sres.sp_events == jres.sp_events
    top = sres.sifted[0]
    assert top.DM == 49.0


def test_sharded_survey_matches_one_device(runs):
    """.dat and .singlepulse bytes equal to the one-device run's; ACCEL
    files by the polish rule; the same sifted list."""
    _j, swork, uwork, _jr, sres, ures = runs
    for dm in DMS:
        for ext in (".dat", ".singlepulse"):
            n = "psr_DM%s%s" % (dm, ext)
            assert _bytes(os.path.join(swork, n)) == \
                _bytes(os.path.join(uwork, n)), n
        n = "psr_DM%s_ACCEL_20.cand" % dm
        _accel_agree(os.path.join(uwork, n), os.path.join(swork, n))
    assert_sifted_agree(ures.sifted, sres.sifted)
    assert sres.sp_events == ures.sp_events


def test_partially_resumed_sharded_block(beam, runs, tmp_path,
                                         monkeypatch):
    """A non-durable sharded run whose workdir lost some trials' ACCEL
    and .singlepulse files: the rerun dedisperses onto the mesh again,
    and the seam's sharded block, partly done, moves the lost trials'
    rows to one device (its FFT without a mesh) and redoes only them, to
    files that agree with the first run's."""
    first = str(tmp_path / "first")
    cfg = _config(tsurvey, durable_stages=False)
    with _sharded():
        tsurvey.run_survey([beam], cfg, first, device="cpu")
    work = str(tmp_path / "again")
    shutil.copytree(first, work)
    lost = ["psr_DM%s" % d for d in DMS[2:5]]
    for name in lost:
        for ext in ("_ACCEL_20", "_ACCEL_20.cand", ".singlepulse"):
            os.remove(os.path.join(work, name + ext))
    calls = []
    real = fusion.fused_rfft_batch

    def record(series, mesh=None):
        calls.append((mesh is not None, len(series)))
        return real(series, mesh=mesh)
    monkeypatch.setattr(fusion, "fused_rfft_batch", record)
    before = {n: os.stat(os.path.join(work, n)).st_mtime_ns
              for n in os.listdir(work)}
    with _sharded():
        tsurvey.run_survey([beam], cfg, work, device="cpu")
    assert calls == [(False, len(lost))]
    for name in lost:
        _accel_agree(os.path.join(first, name + "_ACCEL_20.cand"),
                     os.path.join(work, name + "_ACCEL_20.cand"))
        sp = name + ".singlepulse"
        assert _bytes(os.path.join(first, sp)) == \
            _bytes(os.path.join(work, sp))
    kept = [n for n in before if n.endswith("_ACCEL_20")]
    assert len(kept) == len(DMS) - len(lost)
    for n in kept:
        assert os.stat(os.path.join(work, n)).st_mtime_ns == before[n], n


@pytest.mark.parametrize("durable", [True, False])
def test_sharded_durable_tiers(beam, runs, tmp_path, durable):
    """The durable tier writes each trial's .dat (byte-equal to the
    one-device run's) and .fft from the shards; the non-durable tier
    writes neither, and its ACCEL files are the durable sharded run's."""
    _j, swork, uwork, _jr, _sr, _ur = runs
    work = str(tmp_path / "w")
    with _sharded():
        tsurvey.run_survey([beam], _config(tsurvey, durable_stages=durable),
                           work, device="cpu")
    names = os.listdir(work)
    dats = sorted(n for n in names if n.endswith(".dat"))
    ffts = sorted(n for n in names if n.endswith(".fft"))
    if durable:
        assert dats == ["psr_DM%s.dat" % d for d in DMS]
        assert ffts == ["psr_DM%s.fft" % d for d in DMS]
        for n in dats + ffts:
            assert _bytes(os.path.join(work, n)) == \
                _bytes(os.path.join(swork, n)), n
        for n in dats:
            assert _bytes(os.path.join(work, n)) == \
                _bytes(os.path.join(uwork, n)), n
    else:
        assert dats == ffts == []
    for dm in DMS:
        n = "psr_DM%s_ACCEL_20" % dm
        assert _bytes(os.path.join(work, n)) == \
            _bytes(os.path.join(swork, n)), n
    np.testing.assert_equal(
        _bytes(os.path.join(work, "cands_sifted.txt")),
        _bytes(os.path.join(swork, "cands_sifted.txt")))
