"""Barycentring in the port (astro/{ephem, bary, baryshift, spk,
spkwrite, kernels}, apps/common.make_bary_plan, apps/prepsubband without
-nobary, apps/bary) against the JAX package's, on the CPU.

The astro modules are host NumPy copies, so their numbers are equal, not
close: ephemeris vectors, barycentric times and v/c, diffbin schedules,
resampled series, BaryPlan fields and the builtin SPK kernel's bytes.
prepsubband's barycentred .dat/.inf are byte-equal to the JAX package's
on the synth beam (2^16 samples, 32 channels, the Crab's position at
GBT): plain, with an rfifind -mask, on two logical shards and -elastic.
A tone resampled by a BaryPlan sits at f (1 + avgvoverc): the sign of
the Doppler factor the survey's barycentric frequencies carry.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from presto_tpu.apps import bary as jbary_app
from presto_tpu.apps import prepsubband as jprep
from presto_tpu.apps import rfifind as jrfifind
from presto_tpu.astro import bary as jbary
from presto_tpu.astro import baryshift as jshift
from presto_tpu.astro import ephem as jephem
from presto_tpu.astro import kernels as jkernels
from presto_tpu.astro import spk as jspk
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu_torch.apps import bary as tbary_app
from presto_tpu_torch.apps import prepfold as tfold
from presto_tpu_torch.apps import prepsubband as tprep
from presto_tpu_torch.astro import bary as tbary
from presto_tpu_torch.astro import baryshift as tshift
from presto_tpu_torch.astro import ephem as tephem
from presto_tpu_torch.astro import kernels as tkernels
from presto_tpu_torch.astro import spk as tspk
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.parallel import mesh
from test_torch_prepfold import OUTS, assert_bestprof_agree

CRAB = ("05:34:31.9700", "22:00:52.1000")
# a position whose mean v/c is negative at MJD 59000: its schedule
# inserts bins
OPPOSITE = ("17:34:31.9700", "-22:00:52.1000")
N, NCHAN, DT = 1 << 16, 32, 5e-4
ARGV = ["-lodm", "40", "-dmstep", "3", "-numdms", "8", "-nsub", "8",
        "-o", "psr"]


def test_epv_ephemeris_equal_on_a_grid():
    jd = 2400000.5 + np.linspace(44300.0, 66100.0, 97)
    je, te = jephem.EpvEphemeris(), tephem.EpvEphemeris()
    for a, b in zip(je.earth_posvel(jd), te.earth_posvel(jd)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(te.sun_pos(jd), je.sun_pos(jd))
    # scalar and N-D epochs keep their shape
    assert te.earth_posvel(jd[0])[0].shape == (3,)
    assert te.sun_pos(jd.reshape(97, 1)).shape == (97, 1, 3)


def test_get_ephemeris_names(tmp_path, monkeypatch):
    """DE200/DE405/EPV2000 take the EPV series, KEPLER the Keplerian
    model, .npz a table, .bsp a kernel, AUTO the builtin kernel from the
    cache; a path-like name that is none of these raises."""
    jd = 2400000.5 + np.array([58990.25, 59000.5, 59009.75])
    for name in ("DE200", "DE405", "EPV2000", None):
        assert isinstance(tephem.get_ephemeris(name), tephem.EpvEphemeris)
    kj, kt = jephem.get_ephemeris("KEPLER"), tephem.get_ephemeris("kepler")
    assert isinstance(kt, tephem.AnalyticEphemeris)
    for a, b in zip(kj.earth_posvel(jd), kt.earth_posvel(jd)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(kt.sun_pos(jd), kj.sun_pos(jd))
    pos, vel = tephem.EpvEphemeris().earth_posvel(jd)
    table = str(tmp_path / "eph.npz")
    np.savez(table, jd_tdb=jd, earth_pos=pos, earth_vel=vel,
             sun_pos=tephem.EpvEphemeris().sun_pos(jd))
    q = jd[0] + np.array([0.5, 3.0, 17.25])
    for a, b in zip(jephem.get_ephemeris(table).earth_posvel(q),
                    tephem.get_ephemeris(table).earth_posvel(q)):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="unrecognized ephemeris"):
        tephem.get_ephemeris(str(tmp_path / "de405"))
    # AUTO: the builtin kernel of a narrow range, generated into the
    # cache directory on first use, read through the SPK path
    monkeypatch.setattr(tkernels, "default_cache_dir",
                        lambda: str(tmp_path / "cache"))
    monkeypatch.setattr(tkernels, "BUILTIN_MJD_LO", 58980.0)
    monkeypatch.setattr(tkernels, "BUILTIN_MJD_HI", 59020.0)
    auto = tephem.get_ephemeris("AUTO")
    assert isinstance(auto, tspk.SPKEphemeris)
    assert os.path.dirname(auto.name) == str(tmp_path / "cache")
    assert isinstance(tephem.get_ephemeris(auto.name), tspk.SPKEphemeris)
    np.testing.assert_allclose(auto.earth_posvel(jd)[0], pos, rtol=0,
                               atol=1e-10)


def test_missing_epv_tables_raise(tmp_path, monkeypatch):
    """No fallback: a missing data/epv.npz raises; KEPLER stays an
    explicit choice."""
    monkeypatch.setattr(tephem, "_DEFAULT", None)
    monkeypatch.setattr(tephem, "EPV_PATH", str(tmp_path / "gone.npz"))
    for name in (None, "DE405"):
        with pytest.raises(RuntimeError, match="epv.npz"):
            tephem.get_ephemeris(name)
    with pytest.raises(RuntimeError, match="epv.npz"):
        tbary.barycenter(59000.0, *CRAB)
    assert isinstance(tephem.get_ephemeris("KEPLER"),
                      tephem.AnalyticEphemeris)


@pytest.mark.parametrize("obs", ["GB", "AO", "PK"])
def test_barycenter_and_average_voverc_equal(obs):
    t = 59000.0 + np.linspace(0.0, 400.0, 41)
    for ra, dec in (CRAB, OPPOSITE, ("12:00:00", "+89:00:00")):
        for a, b in zip(jbary.barycenter(t, ra, dec, obs),
                        tbary.barycenter(t, ra, dec, obs)):
            np.testing.assert_array_equal(b, a)
        assert tbary.barycenter(59000.25, ra, dec, obs) == \
            jbary.barycenter(59000.25, ra, dec, obs)
        assert tbary.average_voverc(59000.0, 600.0, ra, dec, obs) == \
            jbary.average_voverc(59000.0, 600.0, ra, dec, obs)
    for s in ("-03:30:00.5", "12 30 15", "+00:00:01"):
        assert tbary.parse_dec(s) == jbary.parse_dec(s)
        assert tbary.parse_ra(s.lstrip("+-")) == jbary.parse_ra(
            s.lstrip("+-"))


@pytest.mark.parametrize("pos", [CRAB, OPPOSITE], ids=["drops", "inserts"])
def test_bary_plan_fields_equal(pos):
    args = (59000.0, 1800.0, 5e-4) + pos + ("GB", "DE405")
    j, t = jshift.BaryPlan(*args), tshift.BaryPlan(*args)
    for f in ("ttoa", "btoa", "diffbins"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ("avgvoverc", "maxvoverc", "minvoverc", "blotoa"):
        assert getattr(t, f) == getattr(j, f)
    assert t.diffbins.size > 10
    assert (t.diffbins > 0).all() if pos is OPPOSITE \
        else (t.diffbins < 0).all()
    grid = tshift.bary_grid(59000.0, 1800.0, *pos)
    for a, b in zip(jshift.bary_grid(59000.0, 1800.0, *pos), grid):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case", ["empty", "inserts", "drops", "mixed",
                                  "at_end", "past_end"])
def test_apply_diffbins_equal(case):
    rng = np.random.default_rng(5)
    x = rng.normal(size=20000).astype(np.float32)
    sched = {"empty": [], "inserts": [10, 700, 701, 12345],
             "drops": [-3, -900, -19000], "mixed": [5, -400, 401, -7000],
             "at_end": [-100, 19998, 19999], "past_end": [300, 25000]}
    d = np.asarray(sched[case], np.int64)
    a, b = jshift.apply_diffbins(x, d), tshift.apply_diffbins(x, d)
    assert b.dtype == np.float32 and a.tobytes() == b.tobytes()
    if case == "empty":
        assert b is x


def test_diffbin_schedule_equal():
    rng = np.random.default_rng(8)
    ttoa = 59000.0 + np.arange(60) * 20.0 / 86400.0
    drift = np.cumsum(rng.normal(scale=3e-4, size=60)) / 86400.0
    btoa = ttoa + 0.3 / 86400.0 + drift
    for dsdt in (5e-4, 1.28e-4, 2e-3):
        np.testing.assert_array_equal(
            tshift.diffbin_schedule(ttoa, btoa, dsdt),
            jshift.diffbin_schedule(ttoa, btoa, dsdt))


def test_resampled_tone_sits_at_f_times_one_plus_voverc():
    """A tone at a constant topocentric f through a BaryPlan's schedule:
    its frequency in the resampled series is f (1 + avgvoverc) within
    0.1 Fourier bins, 1.1 bins from f (1 - avgvoverc)."""
    n, dt, f = 1 << 20, 5e-4, 40.0
    plan = tshift.BaryPlan(59000.0, n * dt, dt, *CRAB)
    x = np.sin(2 * np.pi * f * np.arange(n) * dt).astype(np.float32)
    y = plan.apply(x)
    assert y.tobytes() == jshift.BaryPlan(59000.0, n * dt, dt, *CRAB) \
        .apply(x).tobytes()
    T = y.size * dt
    # a zero-padded transform around the peak, 1/64-bin steps
    r0 = f * T
    rs = r0 + np.arange(-128, 129) / 64.0
    k = np.arange(y.size)
    pw = [abs(np.exp(-2j * np.pi * r * k / y.size) @ y) for r in rs]
    r = rs[int(np.argmax(pw))]
    v = plan.avgvoverc
    assert abs(v * f * T) > 0.5
    assert abs(r - r0 * (1 + v)) < 0.1
    assert abs(r - r0 * (1 - v)) > 1.0


def test_builtin_kernel_bytes_and_spk_reads_equal(tmp_path, monkeypatch):
    monkeypatch.setenv(jkernels.ENV_DIR, str(tmp_path / "j"))
    jpath = jkernels.builtin_kernel(58990.0, 59010.0)
    tpath = tkernels.builtin_kernel(58990.0, 59010.0,
                                    root=str(tmp_path / "t"))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert tkernels.builtin_kernel(58990.0, 59010.0,
                                   root=str(tmp_path / "t")) == tpath
    jd = 2400000.5 + np.linspace(58990.5, 59009.5, 23)
    je, te = jspk.SPKEphemeris(jpath), tspk.SPKEphemeris(tpath)
    for a, b in zip(je.earth_posvel(jd), te.earth_posvel(jd)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(te.sun_pos(jd), je.sun_pos(jd))
    with pytest.raises(ValueError, match="outside"):
        te.earth_posvel(2400000.5 + 59100.0)
    # a DE kernel placed in the cache wins; a broken pin raises
    assert tkernels.find_de_kernel(str(tmp_path / "t")) is None
    de = str(tmp_path / "t" / "de440s.bsp")
    os.link(tpath, de)
    assert tkernels.resolve_kernel(str(tmp_path / "t")) == (de, "de")
    open(de + ".sha256", "w").write("0" * 64 + "\n")
    with pytest.raises(RuntimeError, match="SHA256"):
        tkernels.find_de_kernel(str(tmp_path / "t"))


def test_bary_cli_equal(tmp_path):
    mjds = tmp_path / "mjds.txt"
    mjds.write_text("# topocentric\n58000.5\n59000.25  # two\n60000.0\n")
    for extra in ([], ["-voverc"], ["-inv"], ["-obs", "AO", "-voverc"]):
        argv = ["-ra", "12:34:56.7", "-dec", "-12:34:56.7"] + extra + \
            [str(mjds)]
        outs = []
        for app in (jbary_app, tbary_app):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert app.main(list(argv)) == 0
            outs.append(buf.getvalue())
        assert outs[1] == outs[0] and outs[0].count("\n") == 3


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    """The synth beam (the Crab's position at GBT, MJD 59000), an
    rfifind mask of it, and the JAX package's barycentred prepsubband
    outputs without and with the mask: {case: {file: bytes}}."""
    d = tmp_path_factory.mktemp("bary_beam")
    raw = str(d / "psr.fil")
    fake_filterbank_file(raw, N, DT, NCHAN, 1338.0, 4.0,
                         FakeSignal(f=41.3, dm=49.0, shape="gauss",
                                    width=0.04, amp=1.0),
                         noise_sigma=6.0, seed=21)
    cwd = os.getcwd()
    try:
        os.chdir(str(d))
        jrfifind.main(["-time", "2", "-noplot", "-o", "m", raw])
    finally:
        os.chdir(cwd)
    mask = str(d / "m_rfifind.mask")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRESTO_TPU_DISABLE_MESH", "1")
        for case, extra in (("plain", []), ("mask", ["-mask", mask])):
            mp.chdir(str(tmp_path_factory.mktemp("jax_" + case)))
            jprep.main(ARGV + extra + [raw])
            want[case] = _outputs(".")
    return raw, mask, want


def _outputs(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith((".dat", ".inf"))}


@pytest.mark.parametrize("case", ["plain", "mask", "shards2", "elastic"])
def test_prepsubband_barycentred_byte_equal(beam, case, tmp_path,
                                            monkeypatch):
    """prepsubband without -nobary: every .dat/.inf byte-equal to the
    JAX package's, each .inf barycentred at the plan's epoch."""
    raw, mask, want = beam
    monkeypatch.chdir(tmp_path)
    extra = ["-mask", mask] if case == "mask" else []
    if case == "elastic":
        extra = ["-elastic", "-shard-rows", "3"]
    if case == "shards2":
        with mesh.set_logical_devices(2, "cpu"):
            tprep.main(ARGV + [raw], device="cpu")
    else:
        tprep.main(ARGV + extra + [raw], device="cpu")
    got = _outputs(".")
    ref = want["mask" if case == "mask" else "plain"]
    assert sorted(got) == sorted(ref) and len(got) == 16
    for f in ref:
        assert got[f] == ref[f], f
    from presto_tpu_torch.apps.common import open_raw
    fb = open_raw(raw)
    plan = tshift.BaryPlan(fb.header.tstart, N * DT, DT, *CRAB)
    fb.close()
    info = read_inf("psr_DM49.00")
    assert info.bary == 1 and plan.diffbins.size >= 1
    assert info.mjd_i + info.mjd_f == pytest.approx(plan.blotoa, abs=1e-12)


def test_prepsubband_nobary_and_positionless_header(beam, tmp_path,
                                                   monkeypatch, capsys):
    """-nobary keeps the topocentric epoch; a header without a source
    position warns and stays topocentric, as in the JAX package."""
    from presto_tpu_torch.io.sigproc import (FilterbankFile,
                                             write_filterbank)
    raw = beam[0]
    monkeypatch.chdir(tmp_path)
    tprep.main(ARGV + ["-nobary", raw], device="cpu")
    assert read_inf("psr_DM40.00").bary == 0
    with FilterbankFile(raw) as fb:
        hdr = fb.header
        data = fb.read_spectra(0, N)
    hdr.src_raj = hdr.src_dej = 0.0
    write_filterbank("nopos.fil", hdr, data.astype(np.uint8))
    os.mkdir("t")
    tprep.main(ARGV[:-1] + ["t/psr", "nopos.fil"], device="cpu")
    assert "no source position" in capsys.readouterr().out
    info = read_inf("t/psr_DM40.00")
    assert info.bary == 0 and info.mjd_i + info.mjd_f == 59000.0


def test_fold_of_a_barycentred_dat_matches_jax(beam, tmp_path, monkeypatch):
    """prepfold -nosearch of a barycentred .dat: .pfd byte-equal to the
    JAX package's, the .bestprof's epoch the barycentric one."""
    from presto_tpu.apps import prepfold as jfold
    raw, _mask, want = beam
    monkeypatch.chdir(tmp_path)
    for f in ("psr_DM49.00.dat", "psr_DM49.00.inf"):
        open(f, "wb").write(want["plain"][f])
    argv = ["-f", "41.3", "-dm", "49", "-nosearch", "-noplot", "-o",
            "fold", "psr_DM49.00.dat"]
    jfold.run(jfold.build_parser().parse_args(argv))
    ref = {o: open(o, "rb").read() for o in OUTS}
    for o in OUTS:
        os.remove(o)
    tfold.run(tfold.build_parser().parse_args(argv), device="cpu")
    assert open("fold.pfd", "rb").read() == ref["fold.pfd"]
    got = open("fold.pfd.bestprof", "rb").read()
    assert_bestprof_agree(ref["fold.pfd.bestprof"], got)
    epoch = [ln for ln in got.decode().splitlines()
             if "Epoch_bary" in ln or "Epoch_topo" in ln]
    assert any("Epoch_bary" in ln and "N/A" not in ln for ln in epoch), \
        epoch


@pytest.mark.parametrize("shards", [1, 2])
def test_run_survey_barycentred_seam_equals_staged(beam, shards, tmp_path):
    """run_survey(bary=True) with no zaplist: the seam's host resample and
    re-deposit (per shard on two logical shards) leaves .dat/.inf equal
    to the JAX package's staged prepsubband, and the search runs on the
    re-deposited series (the pulsar on top, within one trial of DM 49)."""
    from presto_tpu_torch.pipeline import survey
    raw, _mask, want = beam
    cfg = survey.SurveyConfig(lodm=40.0, hidm=60.0, nsub=8, zmax=0,
                              numharm=4, fold_top=0, singlepulse=False,
                              skip_rfifind=True, durable_stages=True,
                              bary=True)
    work = str(tmp_path / "w")
    if shards == 1:
        res = survey.run_survey([raw], cfg, work, device="cpu")
    else:
        with mesh.set_logical_devices(2, "cpu"):
            res = survey.run_survey([raw], cfg, work, device="cpu")
    got = _outputs(work)
    assert sorted(got) == sorted(want["plain"])
    for f, ref in want["plain"].items():
        if f.endswith(".dat"):
            assert got[f] == ref, f
        else:
            assert got[f].replace(work.encode() + b"/", b"") == ref, f
    top = res.sifted[0]
    assert top.DM == pytest.approx(49.0, abs=3.1)
    T = read_inf(os.path.join(work, "psr_DM49.00")).N * DT
    assert abs(top.r / T - 41.3) < 0.05
