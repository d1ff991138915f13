"""zapbirds in the port (apps/zapbirds) and the survey's zaplist path
against the JAX package's, on the CPU.

Zapping is host NumPy on both sides, so a zapped spectrum is byte-equal
to the JAX package's zap of the same spectrum: the CLI's -zap (-zapfile,
-defaultbirds, -baryv) and -in/-out files, and zap_pairs_batch.  The
survey (barycentred, the default birdie list, the synth beam): its .dat
byte-equal to the JAX survey's; each spilled .fft byte-equal to the
port's rFFT of the .dat zapped by the JAX package's zap_pairs_batch
(the two packages' FFTs round differently), on the seam path and on
the disk path (elastic prepsubband: rFFT -> zapbirds -> accelsearch),
which agree with each other; the strong ACCEL candidates within the
polish tolerances of the JAX survey's.  A rerun zaps nothing twice.
SearchService jobs that name bary and zaplist run stacked: two of one
observation, and two of two observations (bucketed together, as the
JAX package buckets them), each byte-equal to its own run_survey.
"""

import glob
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from presto_tpu.apps import zapbirds as jzap
from presto_tpu.io import datfft as jdatfft
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.pipeline import survey as jsurvey
from presto_tpu.serve.fleet import artifact_digests
from presto_tpu.serve.plancache import bucket_key as jbucket_key
from presto_tpu_torch.apps import zapbirds as tzap
from presto_tpu_torch.io import datfft
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.pipeline import survey as tsurvey
from presto_tpu_torch.serve.plancache import bucket_key
from presto_tpu_torch.serve.server import SearchService
from presto_tpu_torch.utils.catalog import default_birds_path
from test_torch_survey_slice import _accel_agree, _jax_tpu_path

N, NCHAN, DT = 1 << 16, 32, 5e-4
BIRDS = default_birds_path()


@pytest.fixture
def fftdir(tmp_path, monkeypatch):
    """x.fft/.inf: noise with mains birdies (60 Hz and harmonics, 50 Hz)
    and a 41.3 Hz tone, 2^16 samples at 0.5 ms; the cwd is the
    directory."""
    rng = np.random.default_rng(17)
    t = np.arange(N) * DT
    x = rng.normal(size=N) + 0.3 * np.sin(2 * np.pi * 41.3 * t)
    for f, a in ((60.0, 2.0), (120.0, 1.0), (180.0, 0.7), (50.0, 1.5)):
        x += a * np.sin(2 * np.pi * f * t + f)
    amps = np.fft.rfft(x.astype(np.float32))[:N // 2].astype(np.complex64)
    jdatfft.write_fft(str(tmp_path / "x.fft"), amps)
    write_inf(InfoData(name="x", N=float(N), dt=DT, telescope="GBT"),
              str(tmp_path / "x.inf"))
    (tmp_path / "m.birds").write_text("# freq numharm\n60.0 4\n50.0 2\n"
                                      "41.3 1\n")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _both(argv, outs):
    """Each package's main on its own copy of x.fft/.inf in the cwd:
    ({output: bytes} of each, (JAX stdout, port stdout))."""
    got, said = [], []
    for app in (jzap, tzap):
        shutil.copy("x.fft.orig", "x.fft")
        buf = io.StringIO()
        with redirect_stdout(buf):
            app.main(list(argv))
        said.append(buf.getvalue())
        got.append({o: open(o, "rb").read() for o in outs})
    return got, said


@pytest.mark.parametrize("argv", [
    ["-zap", "-zapfile", BIRDS, "x.fft"],
    ["-zap", "-defaultbirds", "x.fft"],
    ["-zap", "-zapfile", BIRDS, "-baryv", "3e-5", "x.fft"],
    ["-zap", "-zapfile", "m.zap", "-baryv=-1e-4", "x.fft"],
    ["-in", "m.birds", "-out", "m.meas", "x.fft"],
    ["-in", "m.birds", "-out", "m.meas", "-baryv", "2e-4", "x.fft"],
], ids=["zapfile", "defaultbirds", "baryv", "bary-lines", "measure",
        "measure-baryv"])
def test_zapbirds_cli_equal(fftdir, argv):
    shutil.copy("x.fft", "x.fft.orig")
    open("m.zap", "w").write("# measured\n60.0 0.2\nB41.3 0.05\n"
                             "  120.0  0.3\n")
    outs = ["m.meas"] if "-in" in argv else ["x.fft"]
    (want, got), (jsaid, tsaid) = _both(argv, outs)
    assert got == want and tsaid == jsaid
    if "-zap" in argv:
        assert got["x.fft"] != open("x.fft.orig", "rb").read()
        assert "zapped" in tsaid
    else:
        rows = [ln for ln in got["m.meas"].decode().splitlines()
                if not ln.startswith("#")]
        assert len(rows) >= 4      # 60 Hz x 3 harmonics, 50, 41.3


def test_zapbirds_cli_refusals(fftdir):
    for argv in (["x.fft"], ["-zap", "x.fft"], ["-in", "m.birds", "x.fft"]):
        with pytest.raises(SystemExit):
            tzap.main(argv)


def test_zap_pairs_batch_equal():
    rng = np.random.default_rng(3)
    pairs = rng.normal(size=(5, 4096, 2)).astype(np.float32)
    pairs[:, 1966:1970] *= 40.0          # a birdie at 60 Hz (T 32.768 s)
    T, n = 32.768, 8192
    for baryv in (0.0, 2.6e-5):
        a = jzap.zap_pairs_batch(pairs.copy(), BIRDS, T, n, baryv)
        b = tzap.zap_pairs_batch(pairs.copy(), BIRDS, T, n, baryv)
        assert a.tobytes() == b.tobytes()
        assert not np.array_equal(b, pairs)
    amps = fftpack.np_pairs_to_complex64(pairs[0])
    (za, na), (zb, nb) = (m.zap_amps(amps, BIRDS, T, n) for m in (jzap, tzap))
    assert na == nb > 0 and za.tobytes() == zb.tobytes()


def _cfg(mod, **kw):
    kw = {"singlepulse": False, **kw}
    return mod.SurveyConfig(lodm=40.0, hidm=60.0, nsub=8, zmax=0,
                            numharm=4, fold_top=0, skip_rfifind=True,
                            durable_stages=True, bary=True, zaplist=BIRDS,
                            **kw)


@pytest.fixture(scope="module")
def zruns(tmp_path_factory):
    """The synth beam through the JAX survey and the port's, barycentred
    and zapped: the port on the seam path and on the disk path."""
    d = tmp_path_factory.mktemp("zap_survey")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, N, DT, NCHAN, 1338.0, 4.0,
                         FakeSignal(f=41.3, dm=49.0, shape="gauss",
                                    width=0.04, amp=1.0),
                         noise_sigma=6.0, seed=21)
    with pytest.MonkeyPatch.context() as mp:
        _jax_tpu_path(mp)
        jsurvey.run_survey([raw], _cfg(jsurvey), str(d / "jax"))
    seam = tsurvey.run_survey([raw], _cfg(tsurvey), str(d / "seam"),
                              device="cpu")
    disk = tsurvey.run_survey([raw], _cfg(tsurvey, elastic=True),
                              str(d / "disk"), device="cpu")
    return raw, d, seam, disk


def _names(work, pat):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(work, pat)))


def test_zaplist_survey_seam_and_disk_match(zruns):
    raw, d, seam, disk = zruns
    jwork, swork, dwork = (str(d / w) for w in ("jax", "seam", "disk"))
    dats = _names(jwork, "psr_DM*.dat")
    assert len(dats) == 8
    assert _names(swork, "psr_DM*.dat") == dats == _names(dwork,
                                                          "psr_DM*.dat")
    for f in dats:
        ref = open(os.path.join(jwork, f), "rb").read()
        assert open(os.path.join(swork, f), "rb").read() == ref, f
        assert open(os.path.join(dwork, f), "rb").read() == ref, f
    # the port's rFFT of the fan-out, zapped by the JAX package
    arr = np.stack([datfft.read_dat(os.path.join(swork, f)) for f in dats])
    n = arr.shape[1] & ~1
    pairs = fftpack.realfft_packed_pairs(torch.from_numpy(arr[:, :n]))
    T = n * DT
    want = jzap.zap_pairs_batch(pairs.numpy().copy(), BIRDS, T, n)
    for i, f in enumerate(dats):
        fft = f[:-4] + ".fft"
        w = fftpack.np_pairs_to_complex64(want[i]).tobytes()
        assert open(os.path.join(swork, fft), "rb").read() == w, fft
        assert open(os.path.join(dwork, fft), "rb").read() == w, fft
        for work in (swork, dwork):
            acc = os.path.join(work, f[:-4] + "_ACCEL_0")
            assert open(acc, "rb").read() == open(
                os.path.join(swork, f[:-4] + "_ACCEL_0"), "rb").read()
        _accel_agree(os.path.join(jwork, f[:-4] + "_ACCEL_0.cand"),
                     os.path.join(swork, f[:-4] + "_ACCEL_0.cand"))
    for work in (swork, dwork):
        entries = json.load(open(os.path.join(work, "manifest.json")))
        stages = {k: v["stage"] for k, v in entries["artifacts"].items()
                  if k.endswith(".fft")}
        assert sorted(stages.values()) == ["zapbirds"] * 8
    assert seam.sifted[0].DM == pytest.approx(49.0, abs=3.1)


def test_zaplist_survey_rerun_zaps_nothing_twice(zruns, tmp_path):
    """A rerun of either path rewrites no .fft; with one trial's ACCEL
    files lost, the trial is searched again from its zapped .fft on
    disk, not zapped again."""
    raw, d, _seam, _disk = zruns
    for path, kw in (("seam", {}), ("disk", {"elastic": True})):
        work = str(tmp_path / path)
        shutil.copytree(str(d / path), work)
        before = {f: open(f, "rb").read()
                  for f in glob.glob(os.path.join(work, "*"))
                  if os.path.isfile(f) and not f.endswith("manifest.json")}
        lost = os.path.join(work, "psr_DM49.00_ACCEL_0")
        os.remove(lost)
        os.remove(lost + ".cand")
        tsurvey.run_survey([raw], _cfg(tsurvey, **kw), work, device="cpu")
        after = {f: open(f, "rb").read() for f in before}
        assert after == before, path


def test_zaplist_seam_without_journal_zaps_once(zruns, tmp_path):
    """With no journal (verify_resume=False) the staged sweep leaves out
    the trials the seam zapped and searched, so their spilled .fft are
    zapped once: byte-equal to the journaled seam run's.  The survey's
    StageTimer books the host resample and the host zap where they ran,
    inside the prepsubband and fused stages."""
    from presto_tpu_torch.utils.timing import StageTimer
    raw, d, _seam, _disk = zruns
    work = str(tmp_path / "w")
    timer = StageTimer()
    tsurvey.run_survey([raw], _cfg(tsurvey, verify_resume=False), work,
                       timer=timer, device="cpu")
    ffts = _names(str(d / "seam"), "psr_DM*.fft")
    assert len(ffts) == 8 and _names(work, "psr_DM*.fft") == ffts
    for f in ffts:
        assert open(os.path.join(work, f), "rb").read() == open(
            str(d / "seam" / f), "rb").read(), f
    assert timer.stages["bary resample (host)"] > 0.0
    assert len(timer.samples["bary resample (host)"]) == 1
    assert timer.stages["zap (host)"] > 0.0
    assert timer._inner["bary resample (host)"] == "prepsubband"
    assert timer._inner["zap (host)"] == "realfft+accelsearch (fused)"


def test_service_jobs_with_bary_and_zaplist(tmp_path):
    """Two jobs of one observation and two of two observations (MJD
    59000 and 59200: different diffbin schedules), bary and zaplist
    named in their specs, each stacked pair byte-equal to its own
    run_survey; the JAX package buckets the two observations' jobs
    together as the port does."""
    raws = []
    for i, mjd in enumerate((59000.0, 59200.0)):
        raw = str(tmp_path / ("obs%d.fil" % i))
        fake_filterbank_file(raw, 1 << 14, DT, 16, 1338.0, 4.0,
                             FakeSignal(f=23.0, dm=55.0, shape="gauss",
                                        width=0.08, amp=0.8),
                             noise_sigma=2.0, tstart_mjd=mjd, seed=100 + i)
        raws.append(raw)
    cfg = {"lodm": 50.0, "hidm": 56.0, "nsub": 8, "zmax": 0, "numharm": 2,
           "fold_top": 0, "singlepulse": True, "skip_rfifind": True,
           "durable_stages": True, "bary": True, "zaplist": BIRDS}
    kj = [jbucket_key([r], jsurvey.SurveyConfig(**cfg)) for r in raws]
    kt = [bucket_key([r], tsurvey.SurveyConfig(**cfg)) for r in raws]
    assert kt[0] == kt[1] and kj[0] == kj[1]
    assert [repr(k) for k in kt] == [repr(k) for k in kj]
    refs = {}
    for raw in raws:
        ref = str(tmp_path / ("ref_" + os.path.basename(raw)))
        tsurvey.run_survey([raw], tsurvey.SurveyConfig(**cfg), ref,
                           device="cpu")
        refs[raw] = artifact_digests(ref)
        assert any(k.endswith(".fft") for k in refs[raw])
    for arm, pair in (("same", [raws[0], raws[0]]), ("two", raws)):
        svc = SearchService(str(tmp_path / arm), stacked=True,
                            device="cpu")
        try:
            ids = [svc.submit({"rawfiles": [r], "config": cfg})["job_id"]
                   for r in pair]
            svc.start()
            assert svc.wait(ids, timeout=300)
            jobs = [svc.get_job(j) for j in ids]
            scheds = [e for e in svc.events.tail(100000)
                      if e["kind"] == "schedule"]
        finally:
            svc.stop()
        assert [j.status for j in jobs] == ["done", "done"], arm
        assert len(scheds) == 1 and scheds[0]["occupancy"] == 2
        for job, raw in zip(jobs, pair):
            assert job.result["stacked"] == 2
            assert artifact_digests(job.workdir) == refs[raw], arm


def test_zaplist_survey_on_two_shards(zruns, tmp_path):
    """The sharded seam (two logical shards, single pulse on): each
    shard's spectra downloaded, zapped and re-uploaded to its device;
    the .fft equal to each shard's rFFT zapped by the JAX package, the
    .dat to the JAX survey's."""
    from presto_tpu_torch.parallel import mesh
    raw, d, _seam, _disk = zruns
    work = str(tmp_path / "w")
    with mesh.set_logical_devices(2, "cpu"):
        res = tsurvey.run_survey([raw], _cfg(tsurvey, singlepulse=True),
                                 work, device="cpu")
    dats = _names(work, "psr_DM*.dat")
    assert dats == _names(str(d / "jax"), "psr_DM*.dat")
    arr = np.stack([datfft.read_dat(os.path.join(work, f)) for f in dats])
    n = arr.shape[1] & ~1
    host = np.concatenate([fftpack.realfft_packed_pairs(
        torch.from_numpy(arr[lo:lo + 4, :n])).numpy() for lo in (0, 4)])
    want = jzap.zap_pairs_batch(host, BIRDS, n * DT, n)
    for i, f in enumerate(dats):
        assert open(os.path.join(work, f), "rb").read() == open(
            str(d / "jax" / f), "rb").read()
        assert open(os.path.join(work, f[:-4] + ".fft"), "rb").read() == \
            fftpack.np_pairs_to_complex64(want[i]).tobytes()
        assert os.path.exists(os.path.join(work, f[:-4] + ".singlepulse"))
    assert res.sifted[0].DM == pytest.approx(49.0, abs=3.1)
