"""The port's prepfold (search/prepfold.py, apps/prepfold.py) against the
JAX package's, on the CPU.

Both CLIs run in one directory with the same arguments, so the paths
the artifacts embed are equal.  A .pfd holds the fold cube (the
drizzle, bit-equal), the host statistics and the search grid, and so is
byte-equal whenever the two searches pick the same best trial.  A
.bestprof also holds the best summed profile and numbers computed from
it, which the device sums in its own order: strings and integers are
exact, numbers within rtol 1e-5 (atol 1e-6 of the profile's scale for
the profile rows, 1e-4 for the 4-decimal reduced chi2).  Searched folds
hold their chi2 surfaces within rtol 1e-5 of the surface's peak and
pick the same best (DM, f, fd[, fdd]) indices.
"""

import os
import sys

import numpy as np
import pytest

from presto_tpu.apps import prepfold as japp
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.models.synth import FakeSignal, fake_filterbank_file
from presto_tpu.search import prepfold as jpf
from presto_tpu_torch.apps import prepfold as tapp
from presto_tpu_torch.apps.accelsearch import write_cand_file
from presto_tpu_torch.io.pfd import read_pfd
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import prepfold as tpf

N, DT, F0, FD0 = 1 << 15, 5e-4, 41.3, 2e-4
T = N * DT


@pytest.fixture
def datdir(tmp_path, monkeypatch):
    """x.dat/.inf (a pulsar at F0, FD0 in noise) and x_ACCEL_20.cand with
    the pulsar and two other candidates; the cwd is the directory."""
    rng = np.random.default_rng(12)
    t = np.arange(N) * DT
    ph = F0 * t + 0.5 * FD0 * t * t
    x = (rng.normal(size=N) + 0.6 * np.exp(
        -0.5 * ((ph % 1.0 - 0.5) / 0.03) ** 2) + 10.0).astype(np.float32)
    x.tofile(str(tmp_path / "x.dat"))
    write_inf(InfoData(name="x", N=float(N), dt=DT, telescope="GBT",
                       object="FAKEPSR", dm=49.0, mjd_i=59000,
                       mjd_f=0.25), str(tmp_path / "x.inf"))
    # mean values over the observation: r = f(T/2) T, z = fd T^2
    r = (F0 + FD0 * T / 2) * T
    write_cand_file(str(tmp_path / "x_ACCEL_20.cand"), [
        taccel.AccelCand(power=80.0, sigma=9.0, numharm=2, r=r,
                         z=FD0 * T * T),
        taccel.AccelCand(power=30.0, sigma=5.0, numharm=1, r=r * 2.0,
                         z=2 * FD0 * T * T),
        taccel.AccelCand(power=20.0, sigma=4.0, numharm=1, r=r * 1.0001,
                         z=0.0)])
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _both(argv, outs):
    """Run the JAX CLI then the port's with the same argv in the cwd;
    returns ({artifact: bytes} of each, (jax result, port result))."""
    jres = japp.run(japp.build_parser().parse_args(argv))
    want = {o: open(o, "rb").read() for o in outs}
    for o in outs:
        os.remove(o)
    tres = tapp.run(tapp.build_parser().parse_args(argv), device="cpu")
    got = {o: open(o, "rb").read() for o in outs}
    return want, got, (jres, tres)


def _num(s):
    try:
        return float(s)
    except ValueError:
        return None


def assert_bestprof_agree(want: bytes, got: bytes):
    """The module docstring's field-by-field rule."""
    wl, gl = want.decode().splitlines(), got.decode().splitlines()
    assert len(wl) == len(gl)
    prof = [float(v.split()[1]) for v in wl if not v.startswith("#")]
    scale = max(abs(v) for v in prof)
    for a, b in zip(wl, gl):
        if a.startswith("#") and "=" in a:
            ka, va = a.split("=", 1)
            kb, vb = b.split("=", 1)
            assert ka == kb
            fa = [p.strip() for p in va.split("+/-")]
            fb = [p.strip() for p in vb.split("+/-")]
            for x, y in zip(fa, fb):
                if _num(x) is None or "Data Folded" in ka \
                        or "Profile Bins" in ka:
                    assert x == y, (a, b)
                else:
                    atol = 1e-4 if "chi-sqr" in ka else 0.0
                    np.testing.assert_allclose(_num(y), _num(x), rtol=1e-5,
                                               atol=atol, err_msg=a)
        elif a.startswith("#"):
            assert a == b
        else:
            ia, va = a.split()
            ib, vb = b.split()
            assert ia == ib
            np.testing.assert_allclose(float(vb), float(va), rtol=1e-5,
                                       atol=1e-6 * scale)


OUTS = ["fold.pfd", "fold.pfd.bestprof"]


@pytest.mark.parametrize("cand", ["1", "2"])
def test_nosearch_dat_fold_pfd_byte_equal(datdir, cand):
    """The survey's fold: -accelfile -accelcand -dm -nosearch."""
    argv = ["-accelfile", "x_ACCEL_20.cand", "-accelcand", cand, "-dm",
            "49.00", "-nosearch", "-noplot", "-o", "fold", "x.dat"]
    want, got, (jres, tres) = _both(argv, OUTS)
    assert got["fold.pfd"] == want["fold.pfd"]
    assert_bestprof_agree(want["fold.pfd.bestprof"],
                          got["fold.pfd.bestprof"])
    if cand == "1":
        assert tres.best_redchi > 10
        p = read_pfd("fold.pfd")
        assert (p.npart, p.nsub, p.proflen) == (64, 1, 32)
        assert abs(p.fold_p1 - F0) < 1e-9 and p.telescope == "GBT"


def _assert_search_agrees(jres, tres):
    for a in ("dm_chi2", "ppd_chi2", "fdd_chi2"):
        w, g = np.asarray(getattr(jres, a)), np.asarray(getattr(tres, a))
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    for a in ("best_dm", "best_f", "best_fd", "best_fdd"):
        assert getattr(tres, a) == getattr(jres, a), a
    np.testing.assert_array_equal(tres.periods, jres.periods)
    np.testing.assert_array_equal(tres.pdots, jres.pdots)
    np.testing.assert_array_equal(tres.dms, jres.dms)


@pytest.mark.parametrize("extra", [[], ["-searchpdd"]])
def test_searched_dat_fold_matches_jax(datdir, extra):
    """A (p, pd[, pdd]) search of the .dat at -f/-fd: surfaces within
    rtol, the same best trial, and so the same .pfd bytes."""
    argv = ["-f", "41.3005", "-fd", "0.0", "-n", "32", "-npart", "16",
            "-npfact", "1", "-noplot", "-o", "fold"] + extra + ["x.dat"]
    want, got, (jres, tres) = _both(argv, OUTS)
    _assert_search_agrees(jres, tres)
    assert tres.ppd_chi2.shape == (65, 65)
    assert tres.fdd_chi2.shape == ((65,) if extra else (1,))
    assert abs(tres.best_f + tres.best_fd * T / 2 - F0 - FD0 * T / 2) < \
        1.0 / T
    assert got["fold.pfd"] == want["fold.pfd"]
    assert_bestprof_agree(want["fold.pfd.bestprof"],
                          got["fold.pfd.bestprof"])


def test_fil_fold_with_dm_search_matches_jax(tmp_path, monkeypatch):
    """A filterbank dedispersed to subbands at the fold DM, then the DM
    stage and the (p, pd) stage: surfaces within rtol, the same best
    trial, the same .pfd bytes; the best DM lies near the injected."""
    monkeypatch.chdir(tmp_path)
    fake_filterbank_file("psr.fil", 1 << 14, 5e-4, 32, 400.0, 2.0,
                         FakeSignal(f=F0, dm=49.0, shape="gauss",
                                    width=0.04, amp=2.0),
                         noise_sigma=4.0, seed=7)
    argv = ["-f", str(F0), "-dm", "48.0", "-n", "32", "-npart", "16",
            "-nsub", "8", "-npfact", "1", "-ndmfact", "1", "-noplot",
            "-o", "fold", "psr.fil"]
    want, got, (jres, tres) = _both(argv, OUTS)
    assert len(tres.dms) == 4 * 32 + 1
    _assert_search_agrees(jres, tres)
    step = tres.dms[1] - tres.dms[0]
    assert abs(tres.best_dm - 49.0) <= 3 * step
    assert got["fold.pfd"] == want["fold.pfd"]
    assert_bestprof_agree(want["fold.pfd.bestprof"],
                          got["fold.pfd.bestprof"])


def test_fold_events_matches_jax():
    """Event folds are host histograms: equal cubes and statistics; the
    searched surfaces within rtol."""
    rng = np.random.default_rng(2)
    Tev = 400.0
    ev = np.sort(np.concatenate([
        rng.uniform(0, Tev, 3000),
        (np.arange(int(Tev * 3.3)) + 0.3
         + rng.normal(0, 0.02, int(Tev * 3.3))) / 3.3]))
    jcfg = jpf.FoldConfig(proflen=32, npart=16, nsub=1, search_dm=False)
    tcfg = tpf.FoldConfig(proflen=32, npart=16, nsub=1, search_dm=False)
    jr = jpf.fold_events(ev, 3.3001, cfg=jcfg, T=Tev)
    tr = tpf.fold_events(ev, 3.3001, cfg=tcfg, T=Tev)
    np.testing.assert_array_equal(tr.cube, jr.cube)
    np.testing.assert_array_equal(tr.stats, jr.stats)
    jr = jpf.search_fold(jr, jcfg)
    tr = tpf.search_fold(tr, tcfg, device="cpu")
    _assert_search_agrees(jr, tr)


def test_fold_dat_cands_byte_equal_to_cli(datdir):
    """Stacked .dat folds (three candidates, two stack geometries) write
    the port CLI's bytes, with basename labels, and the JAX package's
    fold_dat_cands bytes."""
    from presto_tpu.apps.prepfold import DatFoldSpec as JSpec
    specs = []
    for k in (1, 2, 3):
        argv = ["-accelfile", "x_ACCEL_20.cand", "-accelcand", str(k),
                "-dm", "49.00", "-nosearch", "-noplot", "-o",
                "cli%d" % k, "x.dat"]
        assert tapp.main(argv, device="cpu") == 0
        specs.append((str(datdir / "x.dat"), str(datdir / "x_ACCEL_20.cand"),
                      k))
    for side in ("j", "t"):
        os.makedirs(side)
    out = tapp.fold_dat_cands([tapp.DatFoldSpec(d, a, k, "t/cli%d" % k,
                                                49.0)
                               for d, a, k in specs], device="cpu")
    japp.fold_dat_cands([JSpec(d, a, k, "j/cli%d" % k, 49.0)
                         for d, a, k in specs])
    assert [o["stacked"] for o in out] == [2, 1, 2]
    for k in (1, 2, 3):
        for ext in (".pfd", ".pfd.bestprof"):
            cli = open("cli%d%s" % (k, ext), "rb").read()
            assert open("t/cli%d%s" % (k, ext), "rb").read() == cli
            if ext == ".pfd":
                assert open("j/cli%d%s" % (k, ext), "rb").read() == cli
            else:
                assert_bestprof_agree(
                    open("j/cli%d%s" % (k, ext), "rb").read(), cli)


@pytest.mark.parametrize("flags", [[], ["-psr", "B1937+21"]])
def test_unported_flags_are_refused(datdir, flags, monkeypatch):
    """A run without -noplot draws the diagnostic plot, alone and beside
    an ephemeris fold (tests/test_torch_prepfold_ephem.py runs those);
    where matplotlib is missing it is refused with ImportError naming
    matplotlib before any work, and -noplot runs without it
    (tests/test_torch_plots.py holds the drawing to the JAX CLI's)."""
    argv = flags + ["-f", "41.3", "-nosearch"] + ["x.dat"]
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules
                     if k.startswith("matplotlib.")] + ["matplotlib"]:
            m.setitem(sys.modules, name, None)
        with pytest.raises(ImportError, match="matplotlib"):
            tapp.main(argv, device="cpu")
        assert not os.path.exists("x.pfd")
        assert tapp.main(argv + ["-noplot", "-o", "n"], device="cpu") == 0
        assert os.path.exists("n.pfd") and not os.path.exists("n.pfd.png")
    assert tapp.main(argv, device="cpu") == 0
    with open("x.pfd.png", "rb") as f:
        assert f.read(4) == b"\x89PNG"


def test_fold_geometry_matches_jax(datdir):
    assert tapp.fold_geometry("x.dat", F0, FD0) == \
        japp.fold_geometry("x.dat", F0, FD0)
    assert tapp.fold_stack_key(N, DT, 64) == japp.fold_stack_key(N, DT, 64)
    for k in (1, 2, 3):
        assert tapp.accel_cand_fold_params("x_ACCEL_20.cand", k, T) == \
            japp.accel_cand_fold_params("x_ACCEL_20.cand", k, T)
