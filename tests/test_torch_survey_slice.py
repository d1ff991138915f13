"""The port's survey end to end against the JAX package's.

A seeded synthetic pulsar filterbank goes through the JAX package's
run_survey (its TPU search path on the CPU, as in test_torch_accel, and
one device: the DM-sharded mesh is off) and the port's run_survey on the
CPU, both with the JAX default singlepulse=True.  The .dat files are
byte-equal; every ACCEL file's strong candidates agree within the polish
tolerances (tests/test_torch_polish.py); the sifted lists agree in DM,
numharm and r within 2e-3 bins, with the pulsar on top; every trial's
.singlepulse agrees by singlepulse.agreement.  A rerun on the same
workdir rewrites nothing; a second accel pass runs over the .fft files
on disk when added on a rerun, and over the seam-resident spectra from
a fresh workdir; a lost .singlepulse is redone through stage 9's disk
path.
"""

import functools
import glob
import os
import shutil

import numpy as np
import pytest

from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.pipeline import survey as jsurvey
from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas, build_pallas
from presto_tpu_torch.apps.accelsearch import read_cand_file
from presto_tpu_torch.models import synth as tsynth
from presto_tpu_torch.pipeline import survey as tsurvey
from test_torch_polish import assert_polish_agrees

N, NCHAN, DT, LOFREQ, CW = 1 << 16, 32, 5e-4, 1338.0, 4.0
F0, DM, WIDTH = 41.3, 49.0, 0.04
DMS = ["%.2f" % (40.0 + 3.0 * i) for i in range(8)]
# the beam has no single pulse at the JAX default sp_threshold of 5; at
# 3.5 each trial has ~60 noise events to compare
SP_THRESHOLD = 3.5


def _config(mod, **kw):
    kw = {"fold_top": 0, "durable_stages": True, "skip_rfifind": True,
          "sp_threshold": SP_THRESHOLD, **kw}
    return mod.SurveyConfig(lodm=40.0, hidm=60.0, nsub=8, zmax=20,
                            numharm=8, **kw)


def _jax_tpu_path(mp):
    """The JAX package's TPU search engine on the CPU, on one device
    (see test_torch_accel.jax_tpu_path)."""
    mp.setattr(accel_pallas, "pallas_available", lambda: True)
    mp.setattr(jaccel, "_use_mxu_engine", lambda fftlen: fftlen % 256 == 0)
    mp.setattr(build_pallas, "make_plane_builder",
               functools.partial(build_pallas.make_plane_builder,
                                 interpret=True))
    mp.setattr(accel_pallas, "make_stage_reducer",
               functools.partial(accel_pallas.make_stage_reducer,
                                 interpret=True))
    mp.setenv("PRESTO_TPU_DISABLE_MESH", "1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(raw filterbank, JAX workdir, port workdir, the two results) after
    one run_survey of each package."""
    d = tmp_path_factory.mktemp("survey")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, N, DT, NCHAN, LOFREQ, CW,
                         FakeSignal(f=F0, dm=DM, shape="gauss",
                                    width=WIDTH, amp=1.0),
                         noise_sigma=6.0, seed=21)
    jwork, twork = str(d / "jax"), str(d / "torch")
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jres = jsurvey.run_survey([raw], _config(jsurvey), jwork)
    res = tsurvey.run_survey([raw], _config(tsurvey), twork, device="cpu")
    assert res.candfile == os.path.join(twork, "cands_sifted.txt")
    return raw, jwork, twork, jres, res


def test_synth_filterbank_bytes_equal(tmp_path):
    sig = FakeSignal(f=F0, dm=DM, shape="gauss", width=0.1, amp=1.0)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a, b = str(tmp_path / "a" / "x.fil"), str(tmp_path / "b" / "x.fil")
    fake_filterbank_file(a, 4096, DT, NCHAN, LOFREQ, CW, sig,
                         noise_sigma=2.0, seed=3)
    tsynth.fake_filterbank_file(b, 4096, DT, NCHAN, LOFREQ, CW,
                                tsynth.FakeSignal(f=F0, dm=DM,
                                                  shape="gauss", width=0.1,
                                                  amp=1.0),
                                noise_sigma=2.0, seed=3)
    assert open(a, "rb").read() == open(b, "rb").read()


def _accel_agree(want_path, got_path):
    """Strong candidates (sigma above 5) of two ACCEL .cand files agree
    in order, numharm and the polish tolerances."""
    want = [c for c in read_cand_file(want_path) if c.sigma > 5.0]
    got = [c for c in read_cand_file(got_path) if c.sigma > 5.0]
    assert want, want_path
    assert [c.numharm for c in got] == [c.numharm for c in want]
    assert_polish_agrees(want, got)


def test_survey_slice_matches_jax(tmp_path, runs):
    """The lower-level entry points, survey_head + seam_fft_search with
    no journal: .dat byte-equal to the JAX run's, and the final lists
    they return are the ones the JAX run wrote, within tolerance; the
    strongest candidate above flo is the pulsar, at its DM."""
    raw, jwork, _twork, _js, _ts = runs
    tcfg = _config(tsurvey)
    twork = str(tmp_path / "torch")
    seam = tsurvey.survey_head(raw, tcfg, twork, device="cpu")
    jdats = sorted(glob.glob(os.path.join(jwork, "psr_DM*.dat")))
    tdats = sorted(glob.glob(os.path.join(twork, "psr_DM*.dat")))
    assert len(jdats) == 8
    assert [os.path.basename(p) for p in jdats] == \
        [os.path.basename(p) for p in tdats]
    for a, b in zip(jdats, tdats):
        assert open(a, "rb").read() == open(b, "rb").read(), a
    got = tsurvey.seam_fft_search(seam, tcfg, device="cpu")
    assert sorted(os.path.basename(k) for k in got) == \
        ["psr_DM%s_ACCEL_20" % d for d in DMS]
    for acc, cands in got.items():
        back = read_cand_file(acc + ".cand")
        assert [(c.r, c.z, c.numharm) for c in back] == \
            [(c.r, c.z, c.numharm) for c in cands]
        assert os.path.exists(acc[:-len("_ACCEL_20")] + ".fft")
        _accel_agree(os.path.join(jwork, os.path.basename(acc)) + ".cand",
                     acc + ".cand")
    T = N * DT
    best_name, best = max(((k, c) for k, cs in got.items() for c in cs
                           if c.r / T > tcfg.flo),
                          key=lambda kc: kc[1].sigma)
    assert os.path.basename(best_name) == "psr_DM49.00_ACCEL_20"
    f = best.r / T
    assert abs(f / F0 - round(f / F0)) < 0.01 and round(f / F0) >= 1


def test_run_survey_artifacts_match_jax(runs):
    """The same artifact set; .dat byte-equal."""
    _raw, jwork, twork, _js, _ts = runs
    names = sorted(os.listdir(jwork))
    assert names == sorted(os.listdir(twork))
    assert len([n for n in names if n.endswith("_ACCEL_20")]) == 8
    for n in names:
        if n.endswith(".dat"):
            assert open(os.path.join(jwork, n), "rb").read() == \
                open(os.path.join(twork, n), "rb").read(), n


@pytest.mark.parametrize("dm", DMS)
def test_run_survey_accel_files_match_jax(runs, dm):
    _raw, jwork, twork, _js, _ts = runs
    name = "psr_DM%s_ACCEL_20.cand" % dm
    _accel_agree(os.path.join(jwork, name), os.path.join(twork, name))


def assert_sifted_agree(want, got):
    """Sifted lists: the same candidates (file, DM, numharm) in the same
    order, r within 2e-3 bins, the same DM hits."""
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert (g.filename, g.DM, g.numharm) == (w.filename, w.DM,
                                                 w.numharm)
        assert abs(g.r - w.r) <= 2e-3
        assert sorted(h[0] for h in g.hits) == sorted(h[0] for h in w.hits)


def test_run_survey_sifted_list_matches_jax(runs):
    _raw, _jwork, _twork, jres, res = runs
    got = res.sifted
    assert_sifted_agree(jres.sifted, got)
    top = got[0]
    assert top.DM == DM
    f = top.r / (N * DT)
    assert abs(f / F0 - round(f / F0)) < 0.01 and round(f / F0) >= 1
    assert len(top.hits) >= 2


def _sp_files(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".singlepulse"))


def test_run_survey_singlepulse_matches_jax(runs):
    """Stage 9a on the seam: every trial's .singlepulse agrees with the
    JAX run's by singlepulse.agreement, byte-equal where no line is near
    a boundary; res.sp_events is equal."""
    from presto_tpu_torch.search.singlepulse import (file_agreement,
                                                     read_singlepulse)
    _raw, jwork, twork, jres, res = runs
    names = _sp_files(jwork)
    assert names == _sp_files(twork) == ["psr_DM%s.singlepulse" % d
                                         for d in DMS]
    same = 0
    for n in names:
        r = file_agreement(os.path.join(jwork, n), os.path.join(twork, n),
                           SP_THRESHOLD)
        assert r["ok"], (n, r)
        assert r["same_bytes"] or r["boundary"] or r["one_sided"], (n, r)
        same += r["same_bytes"]
        assert r["matched"] >= 20
    assert same >= len(names) - 2
    assert res.sp_events == jres.sp_events == sum(
        len(read_singlepulse(os.path.join(twork, n))) for n in names)


@pytest.mark.parametrize("how", ["durable_rerun", "non_durable_seam"])
def test_lost_singlepulse_redone_on_disk(tmp_path, runs, how):
    """A trial's lost .singlepulse goes through stage 9's disk path
    (single_pulse_search on its .dat) to the same bytes: on a rerun of a
    finished durable workdir (whose .dat verify, so the seam is empty),
    and on a non-durable seam after stage 9a, where ensure_dat first
    spills the trial's .dat from the seam's host copy."""
    raw, _jwork, twork, _jr, res = runs
    lost = "psr_DM%s.singlepulse" % DMS[3]
    work = str(tmp_path / how)
    if how == "durable_rerun":
        shutil.copytree(twork, work)
        os.remove(os.path.join(work, lost))
        again = tsurvey.run_survey([raw], _config(tsurvey), work,
                                   device="cpu")
        assert again.sp_events == res.sp_events
    else:
        cfg = _config(tsurvey, durable_stages=False)
        seam = tsurvey.survey_head(raw, cfg, work, device="cpu")
        tsurvey.seam_singlepulse(seam, cfg, device="cpu")
        assert not any(n.endswith(".dat") for n in os.listdir(work))
        os.remove(os.path.join(work, lost))
        dats = [os.path.join(work, "psr_DM%s.dat" % d) for d in DMS]
        assert tsurvey.disk_singlepulse(dats, cfg, seam,
                                        device="cpu") == res.sp_events
        assert [n for n in os.listdir(work) if n.endswith(".dat")] == \
            [lost.replace(".singlepulse", ".dat")]
    for n in _sp_files(twork):
        assert open(os.path.join(work, n), "rb").read() == \
            open(os.path.join(twork, n), "rb").read(), n


def _stamps(d):
    return {n: (os.stat(os.path.join(d, n)).st_mtime_ns,
                open(os.path.join(d, n), "rb").read())
            for n in sorted(os.listdir(d))}


def test_run_survey_resume_rewrites_nothing(tmp_path, runs):
    """A second run_survey on a finished workdir verifies every artifact
    against the journal and rewrites none; only the sift reruns (as in
    the JAX package), to the same bytes."""
    raw, _jwork, twork, _js, _ts = runs
    work = str(tmp_path / "again")
    shutil.copytree(twork, work)
    before = _stamps(work)
    assert len(_sp_files(work)) == len(DMS)
    tsurvey.run_survey([raw], _config(tsurvey), work, device="cpu")
    after = _stamps(work)
    assert sorted(after) == sorted(before)
    for n, (mtime, data) in before.items():
        assert after[n][1] == data, n
        if n not in ("cands_sifted.txt", "manifest.json"):
            assert after[n][0] == mtime, n


def test_run_survey_resume_redoes_lost_spectra(tmp_path, runs):
    """A rerun on a workdir whose .fft and ACCEL files of some trials
    are gone (a run killed after prepsubband): those trials' .dat files
    verify, so they go through the disk path (batched rFFT of the .dat,
    search, polish).  The rFFT of a different batch may differ in the
    last float32 bits (within 1e-6 of the spectrum's peak), so the new
    ACCEL files agree with the first run's within the polish tolerances,
    and the sifted list as the JAX comparison does."""
    raw, _jwork, twork, _js, first = runs
    first = first.sifted
    work = str(tmp_path / "again")
    shutil.copytree(twork, work)
    lost = ["psr_DM%s" % d for d in DMS[2:5]]
    for name in lost:
        for ext in (".fft", "_ACCEL_20", "_ACCEL_20.cand"):
            os.remove(os.path.join(work, name + ext))
    res = tsurvey.run_survey([raw], _config(tsurvey), work, device="cpu")
    for name in lost:
        a = np.fromfile(os.path.join(twork, name + ".fft"), np.complex64)
        b = np.fromfile(os.path.join(work, name + ".fft"), np.complex64)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * abs(a).max())
        _accel_agree(os.path.join(twork, name + "_ACCEL_20.cand"),
                     os.path.join(work, name + "_ACCEL_20.cand"))
    assert_sifted_agree(first, res.sifted)


@pytest.mark.parametrize("start", ["rerun", "fresh"])
def test_run_survey_second_pass_matches_jax(tmp_path, runs, start):
    """accel_passes adds a zmax-0, numharm-4 pass.  On a rerun of both
    finished workdirs each package searches its .fft files on disk; from
    a fresh workdir both passes run over the seam-resident spectra.
    Either way each writes _ACCEL_0 files and sifts both passes; the new
    files and the sifted lists agree."""
    raw, jwork, twork, _js, _ts = runs
    j2, t2 = str(tmp_path / "jax"), str(tmp_path / "torch")
    if start == "rerun":
        shutil.copytree(jwork, j2)
        shutil.copytree(twork, t2)
    passes = ((0, 4, 4.0),)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jres = jsurvey.run_survey([raw],
                                  _config(jsurvey, accel_passes=passes), j2)
    res = tsurvey.run_survey([raw], _config(tsurvey, accel_passes=passes),
                             t2, device="cpu")
    for dm in DMS:
        for zmax in (20, 0):
            name = "psr_DM%s_ACCEL_%d.cand" % (dm, zmax)
            _accel_agree(os.path.join(j2, name), os.path.join(t2, name))
    assert any(c.filename.endswith("_ACCEL_0") for c in res.sifted)
    assert_sifted_agree(jres.sifted, res.sifted)


def test_run_survey_times_its_stages(tmp_path, runs):
    """The StageTimer run_survey reports: the marked stages in order, the
    polish and the ACCEL writes timed once per trial inside the FFT +
    search stage and reported under it."""
    from presto_tpu_torch.utils.timing import StageTimer
    raw = runs[0]
    timer = StageTimer()
    tsurvey.run_survey([raw], _config(tsurvey), str(tmp_path / "t"),
                       timer=timer, device="cpu")
    assert list(timer.stages)[:3] == ["prepsubband", "single_pulse",
                                      "polish"]
    # stage 9a before the FFT, stage 9 (verify, nothing left) after the
    # folds, as the JAX package marks them
    assert len(timer.samples["single_pulse"]) == 2
    assert len(timer.samples["polish"]) == len(DMS)
    assert len(timer.samples["accel writes"]) == len(DMS)
    lines = [ln.split()[0:3] for ln in timer.report().splitlines()[1:]]
    fused = lines.index(["realfft+accelsearch", "(fused)", "%.2f"
                         % timer.stages["realfft+accelsearch (fused)"]])
    assert lines[fused + 1][:3] == ["of", "which", "polish"]
    assert lines[fused + 2][:3] == ["of", "which", "accel"]
    assert lines[fused + 3][0] == "sift"


def _pfd_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if ".pfd" in n}


def test_run_survey_folds_byte_equal_to_jax(tmp_path, runs):
    """fold_top=2 on the JAX run's finished workdir, by each package in
    turn at the same path (so the embedded paths are equal): the same
    two candidates folded from the same .dat and .cand files, .pfd
    byte-equal and .bestprof within the rule of test_torch_prepfold.
    The JAX survey also writes a .png of each fold; the port's runs with
    -noplot."""
    from test_torch_prepfold import assert_bestprof_agree
    raw, jwork, _twork, _js, _ts = runs
    work = str(tmp_path / "fold")
    shutil.copytree(jwork, work)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jres = jsurvey.run_survey([raw], _config(jsurvey, fold_top=2), work)
    want = _pfd_bytes(work)
    shutil.rmtree(work)
    shutil.copytree(jwork, work)
    res = tsurvey.run_survey([raw], _config(tsurvey, fold_top=2), work,
                             device="cpu")
    got = _pfd_bytes(work)
    assert res.folded == jres.folded == [
        os.path.join(work, "fold_cand%d.pfd" % i) for i in (1, 2)]
    assert sorted(want) == sorted(list(got) + ["fold_cand1.pfd.png",
                                               "fold_cand2.pfd.png"])
    for n in got:
        if n.endswith(".pfd"):
            assert got[n] == want[n], n
        else:
            assert_bestprof_agree(want[n], got[n])


def test_run_survey_own_folds_agree_with_jax(tmp_path, runs):
    """The port's own finished run, rerun with fold_top=2, folds only:
    the same candidates as the JAX run's folds, at fold frequencies
    within the polish's 2e-3 bins, the pulsar first with a strong
    profile; a third rerun verifies the journaled .pfd files and
    rewrites none."""
    from presto_tpu_torch.io.pfd import read_pfd
    raw, jwork, twork, _js, _ts = runs
    j2, t2 = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(jwork, j2)
    shutil.copytree(twork, t2)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jsurvey.run_survey([raw], _config(jsurvey, fold_top=2), j2)
    res = tsurvey.run_survey([raw], _config(tsurvey, fold_top=2), t2,
                             device="cpu")
    assert len(res.folded) == 2
    T = N * DT
    for i in (1, 2):
        w = read_pfd(os.path.join(j2, "fold_cand%d.pfd" % i))
        g = read_pfd(os.path.join(t2, "fold_cand%d.pfd" % i))
        assert (g.candnm, g.proflen, g.npart, g.bestdm) == \
            (w.candnm, w.proflen, w.npart, w.bestdm)
        assert os.path.basename(g.filenm) == os.path.basename(w.filenm)
        assert abs(g.fold_p1 - w.fold_p1) * T <= 2e-3
    top = read_pfd(res.folded[0])
    h = round(top.fold_p1 / F0)
    assert h >= 1 and abs(top.fold_p1 / h - F0) < 0.01
    before = _stamps(t2)
    tsurvey.run_survey([raw], _config(tsurvey, fold_top=2), t2,
                       device="cpu")
    after = _stamps(t2)
    for n in ("fold_cand1.pfd", "fold_cand2.pfd"):
        assert after[n] == before[n]


def test_non_durable_survey_folds_through_ensure_dat(tmp_path, runs):
    """With durable_stages=False no .dat is written by prepsubband; the
    fold stage spills each folded trial's .dat from the seam's host
    copy on demand (journaled), byte-equal to the durable run's, and
    the folds equal the durable run's but for the paths they embed."""
    from presto_tpu_torch.io.pfd import read_pfd
    raw, _jwork, twork, _js, _ts = runs
    dur = str(tmp_path / "durable")
    shutil.copytree(twork, dur)
    tsurvey.run_survey([raw], _config(tsurvey, fold_top=2), dur,
                       device="cpu")
    work = str(tmp_path / "lazy")
    res = tsurvey.run_survey(
        [raw], _config(tsurvey, fold_top=2, durable_stages=False), work,
        device="cpu")
    dats = sorted(n for n in os.listdir(work) if n.endswith(".dat"))
    folded_dats = sorted({os.path.basename(read_pfd(p).filenm)
                          for p in res.folded})
    assert dats == folded_dats and 1 <= len(dats) < len(DMS)
    from presto_tpu_torch.pipeline.manifest import SurveyManifest
    man = SurveyManifest.load(work)
    for n in dats:
        assert open(os.path.join(work, n), "rb").read() == \
            open(os.path.join(twork, n), "rb").read()
        assert man.valid(os.path.join(work, n))
    for i in (1, 2):
        w = read_pfd(os.path.join(dur, "fold_cand%d.pfd" % i))
        g = read_pfd(os.path.join(work, "fold_cand%d.pfd" % i))
        np.testing.assert_array_equal(g.profs, w.profs)
        np.testing.assert_array_equal(g.stats, w.stats)
        assert (g.fold_p1, g.fold_p2, g.bestdm) == \
            (w.fold_p1, w.fold_p2, w.bestdm)


def test_seam_releases_device_series(tmp_path, runs):
    """After seam_fft_search no block holds its device series, and the
    ACCEL .cand files equal the journaled durable run's."""
    raw, _jwork, twork, _js, _ts = runs
    cfg = _config(tsurvey)
    work = str(tmp_path / "seam")
    seam = tsurvey.survey_head(raw, cfg, work, device="cpu")
    assert seam.blocks and all(b.series_dev is not None
                               for b in seam.blocks)
    got = tsurvey.seam_fft_search(seam, cfg, device="cpu")
    assert all(b.series_dev is None for b in seam.blocks)
    assert len(got) == len(DMS)
    for acc in got:
        name = os.path.basename(acc) + ".cand"
        assert open(acc + ".cand", "rb").read() == \
            open(os.path.join(twork, name), "rb").read()


# ---- stage 1: rfifind and the mask (skip_rfifind=False) ----------------

RFI_NARROW, RFI_PERIODIC = 5, 20


def _rfi_beam(path):
    """The slice's pulsar beam with narrowband RFI (the kinds of
    test_torch_rfifind at this beam's 8-bit scale: baseline 128, noise
    24): channel RFI_NARROW +60, channel RFI_PERIODIC a 50 Hz sinusoid
    of amplitude 16.  No broadband burst: the beam is one prepsubband
    block, and check_mask blanks a whole block that overlaps a zapped
    interval."""
    from presto_tpu.io import sigproc as jsig
    fake_filterbank_file(path, N, DT, NCHAN, LOFREQ, CW,
                         FakeSignal(f=F0, dm=DM, shape="gauss",
                                    width=WIDTH, amp=1.0),
                         noise_sigma=6.0, seed=21)
    with jsig.FilterbankFile(path) as fb:
        hdr = fb.header
        data = fb.read_spectra(0, hdr.N).astype(np.float64)
    t = np.arange(hdr.N) * DT
    data[:, RFI_NARROW] += 60.0
    data[:, RFI_PERIODIC] += 16.0 * np.sin(2 * np.pi * 50.0 * t)
    jsig.write_filterbank(path, hdr, np.clip(np.round(data), 0, 255))
    return path


@pytest.fixture(scope="module")
def rfi_runs(tmp_path_factory):
    """(raw, JAX workdir, port workdir, JAX result, port result) of one
    run_survey of each package with stage 1 on (skip_rfifind=False, the
    JAX default) over the RFI beam."""
    d = tmp_path_factory.mktemp("rfisurvey")
    raw = _rfi_beam(str(d / "psr.fil"))
    jwork, twork = str(d / "jax"), str(d / "torch")
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jres = jsurvey.run_survey([raw], _config(jsurvey,
                                                 skip_rfifind=False), jwork)
    res = tsurvey.run_survey([raw], _config(tsurvey, skip_rfifind=False),
                             twork, device="cpu")
    return raw, jwork, twork, jres, res


def test_prepsubband_mask_dat_matches_jax(tmp_path, rfi_runs, monkeypatch):
    """prepsubband -mask (padding values from the .stats beside it) and
    -ignorechan: .dat bytes equal to the JAX CLI's."""
    from presto_tpu.apps import prepsubband as jprep
    from presto_tpu_torch.apps import prepsubband as tprep
    raw, jwork, _twork, _jr, _tr = rfi_runs
    monkeypatch.setenv("PRESTO_TPU_DISABLE_MESH", "1")
    mask = os.path.join(jwork, "psr_rfifind.mask")
    for extra in (["-mask", mask], ["-mask", mask, "-ignorechan", "0:1,17"]):
        argv = ["-lodm", "45", "-dmstep", "2", "-numdms", "4", "-nsub", "8",
                "-nobary"] + extra
        jprep.main(argv + ["-o", str(tmp_path / "j"), raw])
        tprep.main(argv + ["-o", str(tmp_path / "t"), raw], device="cpu")
        for dm in ("45.00", "47.00", "49.00", "51.00"):
            a = open(str(tmp_path / ("j_DM%s.dat" % dm)), "rb").read()
            b = open(str(tmp_path / ("t_DM%s.dat" % dm)), "rb").read()
            assert a == b, (extra, dm)


def test_run_survey_with_rfifind_matches_jax(rfi_runs):
    """Stage 1 on: the same _rfifind.mask and quality report bytes (the
    mask holds the RFI), the masked .dat byte-equal, every ACCEL file's
    strong candidates (as _accel_agree) and the sifted list within
    tolerance, the pulsar on top; the result carries the mask path and
    the quality report."""
    raw, jwork, twork, jres, res = rfi_runs
    for n in ("psr_rfifind.mask", "psr_rfifind_quality.json"):
        assert open(os.path.join(jwork, n), "rb").read() == \
            open(os.path.join(twork, n), "rb").read(), n
    from presto_tpu_torch.io.maskfile import read_mask
    m = read_mask(res.maskfile)
    assert res.maskfile == os.path.join(twork, "psr_rfifind.mask")
    assert {RFI_NARROW, RFI_PERIODIC} <= set(m.zap_chans.tolist())
    assert res.quality is not None and res.quality.clean
    jdats = sorted(glob.glob(os.path.join(jwork, "psr_DM*.dat")))
    assert len(jdats) == len(DMS)
    for a in jdats:
        b = os.path.join(twork, os.path.basename(a))
        assert open(a, "rb").read() == open(b, "rb").read(), a
    strong = 0
    for dm in DMS:
        name = "psr_DM%s_ACCEL_20.cand" % dm
        if any(c.sigma > 5.0 for c in read_cand_file(os.path.join(jwork,
                                                                  name))):
            _accel_agree(os.path.join(jwork, name), os.path.join(twork, name))
            strong += 1
        else:
            assert all(c.sigma <= 5.0 for c in read_cand_file(
                os.path.join(twork, name))), name
    assert strong >= 3
    assert_sifted_agree(jres.sifted, res.sifted)
    top = res.sifted[0]
    f = top.r / (N * DT)
    assert top.DM == DM and abs(f / F0 - round(f / F0)) < 0.01


def test_run_survey_with_rfifind_resume_rewrites_nothing(tmp_path, rfi_runs):
    """A rerun verifies the rfifind products with the rest and rewrites
    none of them."""
    from presto_tpu_torch.utils.timing import StageTimer
    raw, _jwork, twork, _jr, _tr = rfi_runs
    work = str(tmp_path / "again")
    shutil.copytree(twork, work)
    before = _stamps(work)
    timer = StageTimer()
    tsurvey.run_survey([raw], _config(tsurvey, skip_rfifind=False), work,
                       timer=timer, device="cpu")
    assert list(timer.stages)[:2] == ["rfifind", "prepsubband"]
    after = _stamps(work)
    assert sorted(after) == sorted(before)
    for n, (mtime, data) in before.items():
        assert after[n][1] == data, n
        if n not in ("cands_sifted.txt", "manifest.json"):
            assert after[n][0] == mtime, n
