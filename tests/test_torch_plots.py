"""The port's plotting modules (plotting/{accelplot, explore, rfiplot,
spplot}) and plot CLIs (apps/{show_pfd, pfd2png, sum_profiles,
pulsestack, plot_spd, pyplotres}) against the JAX package's, and the
plots that prepfold, rfifind, single_pulse_search and
psrfits_quick_bandpass -plot draw, on the CPU.

Given the same inputs the host drawings write the JAX package's PNG
bytes, and the CLIs print its text.  Where the numbers drawn come from
the device in each package (the .pfd plot's chi2 panels and best
profile, rfifind's float32 statistics), the decoded images are held
within the pixel tolerance of tests/test_torch_pfdplot.py: at most
PIXEL_FRACTION of the pixels differ, each channel by at most
PIXEL_ATOL.  With matplotlib hidden (``sys.modules`` entries set to
None) every drawing raises ImportError naming matplotlib: nothing skips
a plot in silence.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from presto_tpu.apps import prepfold as jprepfold
from presto_tpu.apps import psrfits_quick_bandpass as jbp
from presto_tpu.apps import rfifind as jrfifind
from presto_tpu.apps import single_pulse_search as jsps
from presto_tpu.io.infodata import InfoData, write_inf
from presto_tpu.io.pfd import Pfd as JPfd
from presto_tpu.io.pfd import write_pfd as jwrite_pfd
from presto_tpu.io.psrfits import write_psrfits
from presto_tpu.io.residuals import write_residuals
from presto_tpu.io.sigproc import FilterbankHeader, write_filterbank
from presto_tpu.plotting import accelplot as jaccelplot
from presto_tpu.plotting import explore as jexplore
from presto_tpu.plotting import rfiplot as jrfiplot
from presto_tpu.plotting import spplot as jspplot
from presto_tpu.search.rfifind import rfifind as jrfi
from presto_tpu.search.singlepulse import SPCandidate
from presto_tpu.singlepulse.spd import SpdData, _savez
from presto_tpu_torch.apps import prepfold as tprepfold
from presto_tpu_torch.apps import psrfits_quick_bandpass as tbp
from presto_tpu_torch.apps import rfifind as trfifind
from presto_tpu_torch.apps import single_pulse_search as tsps
from presto_tpu_torch.plotting import accelplot as taccelplot
from presto_tpu_torch.plotting import explore as texplore
from presto_tpu_torch.plotting import rfiplot as trfiplot
from presto_tpu_torch.plotting import spplot as tspplot

PIXEL_FRACTION = 1e-3
PIXEL_ATOL = 3.0 / 255


def hide_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.startswith("matplotlib.")] \
            + ["matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_images_close(a, b):
    import matplotlib.image as mimg
    x, y = mimg.imread(a), mimg.imread(b)
    assert x.shape == y.shape
    diff = np.abs(x - y).max(axis=-1)
    assert (diff > 0).mean() <= PIXEL_FRACTION
    assert diff.max() <= PIXEL_ATOL


def _run_in(d, fn):
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        return fn()
    finally:
        os.chdir(cwd)


# ----------------------------------------------------------------------
# The host drawings: the same inputs, the same bytes
# ----------------------------------------------------------------------

def test_plot_ffdot_equals_jax(tmp_path):
    rng = np.random.default_rng(1)

    class C:
        r, z = 120.0, 4.0

    powers = rng.exponential(1.0, (21, 200))
    powers[10, 120] = 80.0
    args = (np.arange(100, 300), np.linspace(-20, 20, 21))
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jaccelplot.plot_ffdot(powers, *args, a, cands=[C()], title="t")
    assert taccelplot.plot_ffdot(powers, *args, b, cands=[C()],
                                 title="t") == b
    assert _bytes(b) == _bytes(a)


def _rfi_result():
    rng = np.random.default_rng(9)
    nchan, N = 16, 1 << 14
    data = rng.normal(10, 2, (N, nchan)).astype(np.float32)
    data[:, 7] += np.sin(np.arange(N)) * 30          # a bad channel
    res = jrfi(data, dt=1e-3, lofreq=1400.0, chanwidth=1.0, time_sec=2.0)
    res.info = {"filenm": "x.fil", "telescope": "GBT", "ra": "12:00:00",
                "dec": "-30:00:00", "chanfrac": 0.7, "intfrac": 0.3}
    return res


def test_plot_rfifind_equals_jax(tmp_path):
    res = _rfi_result()
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jrfiplot.plot_rfifind(res, a)
    trfiplot.plot_rfifind(res, b)
    assert _bytes(b) == _bytes(a)
    res.bytemask = None                   # the mask's zap lists instead
    jrfiplot.plot_rfifind(res, a)
    trfiplot.plot_rfifind(res, b)
    assert _bytes(b) == _bytes(a)


def _spd():
    rng = np.random.default_rng(4)
    return SpdData(dm=50.0, sigma=12.0, time=1.0, downfact=4, dt=1e-3,
                   wf_raw=rng.normal(0, 1, (16, 200)),
                   wf_dedisp=rng.normal(0, 1, (16, 200)),
                   freqs=np.linspace(1400, 1430, 16), start_time=0.9,
                   series=rng.normal(0, 1, 200),
                   context_dm=np.array([50.0, 49.0]),
                   context_time=np.array([1.0, 1.01]),
                   context_sigma=np.array([12.0, 8.0]), source="T")


def test_plot_singlepulse_and_spd_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    cands = [SPCandidate(bin=i, sigma=5 + rng.exponential(2),
                         time=float(i) / 10, downfact=2,
                         dm=float(rng.uniform(0, 100)))
             for i in range(200)]
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jspplot.plot_singlepulse(cands, a, title="test")
    tspplot.plot_singlepulse(cands, b, title="test")
    assert _bytes(b) == _bytes(a)
    jspplot.plot_spd(_spd(), a)
    tspplot.plot_spd(_spd(), b)
    assert _bytes(b) == _bytes(a)


def test_explore_views_keys_and_render_equal_jax(tmp_path, monkeypatch):
    """The views' display arrays, a keystroke session (its actions and
    the birdie file) and the rendered PNGs equal the JAX package's."""
    rng = np.random.default_rng(7)
    powers = rng.exponential(1.0, 1 << 16)
    powers[12345] = 400.0
    series = rng.normal(0, 1, 1 << 15)
    keys = ["a", "a", ">", ",", "g", "h", "n", "+", "-", "s", "d", "v",
            "z", "G", "x", "?", "p", "u", "q"]
    outs = {}
    for side, mod in (("j", jexplore), ("t", texplore)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        sv = mod.SpectrumView(powers=powers, T=100.0, zapfile="b.zap")
        tv = mod.TimeseriesView(data=series, dt=1e-3)
        acts = [mod.dispatch_key(sv, k) for k in keys]
        acts.append(mod.dispatch_key(sv, "G", arg=12.5))
        acts += [mod.dispatch_key(tv, k)
                 for k in ("i", "m", " ", "g", "d", "v", ".", "<")]
        acts.append(mod.dispatch_key(tv, "G", arg=3.0))
        mod.run_explorer(sv, mod.render_spectrum, str(d / "s.png"))
        mod.run_explorer(tv, mod.render_timeseries, str(d / "t.png"))
        outs[side] = (acts, sv.display(), tv.display(), tv.stats(),
                      _bytes(d / "b.zap"), _bytes(d / "s.png"),
                      _bytes(d / "t.png"))
    (ja, jsd, jtd, jst, *jb), (ta, tsd, ttd, tst, *tb) = \
        outs["j"], outs["t"]
    assert [str(x) for x in ta] == [str(x) for x in ja]
    for x, y in zip(tsd + ttd, jsd + jtd):
        np.testing.assert_array_equal(x, y)
    assert tst == jst and tb == jb
    assert texplore.DISPLAYNUM == jexplore.DISPLAYNUM


# ----------------------------------------------------------------------
# The CLIs
# ----------------------------------------------------------------------

def _pfd(path, seed=5, npart=16, nsub=8, L=32, n=9):
    rng = np.random.default_rng(seed)
    profs = rng.normal(100, 5, (npart, nsub, L))
    profs[:, :, 10:14] += 30.0
    st = np.zeros((npart, nsub, 7))
    st[:, :, 0] = 1000.0
    st[:, :, 1] = 100.0 / L
    st[:, :, 2] = 25.0 / L
    f, fd, T = 2.0, 0.0, 400.0
    fs = (np.arange(n) - n // 2) * 2.0 / (L * T)
    fds = (np.arange(n) - n // 2) * 8.0 / (L * T * T)
    jwrite_pfd(path, JPfd(
        npart=npart, nsub=nsub, proflen=L, numchan=32, dt=T / 16000.0,
        tepoch=58000.0, fold_p1=f, fold_p2=fd, lofreq=1400.0,
        chan_wid=1.0, bestdm=50.0, candnm="FAKE", telescope="GBT",
        dms=np.linspace(40, 60, n), periods=1.0 / (f - fs),
        pdots=-(fd - fds) / f ** 2, profs=profs, stats=st, numdms=n,
        numperiods=n, numpdots=n))
    return path


@pytest.mark.parametrize("cli", ["show_pfd", "pfd2png"])
def test_show_pfd_and_pfd2png_equal_jax(tmp_path, capsys, cli):
    """show_pfd with -killsubs/-killparts/-showfold/-allgrey on one .pfd,
    pfd2png (show_pfd's default flags) on two; -infoonly's text."""
    from presto_tpu.apps import pfd2png as jpng, show_pfd as jshow
    from presto_tpu_torch.apps import pfd2png as tpng, show_pfd as tshow
    for side in "jt":
        os.makedirs(str(tmp_path / side))
        for seed, name in ((5, "a.pfd"), (6, "b.pfd")):
            _pfd(str(tmp_path / side / name), seed=seed)
    ja, ta = str(tmp_path / "j" / "a.pfd"), str(tmp_path / "t" / "a.pfd")
    jb, tb = str(tmp_path / "j" / "b.pfd"), str(tmp_path / "t" / "b.pfd")
    if cli == "show_pfd":
        flags = ["-killsubs", "0:2", "-killparts", "3,5", "-showfold",
                 "-allgrey"]
        assert jshow.main(flags + [ja]) == 0
        want = capsys.readouterr().out.replace(str(tmp_path / "j"), "D")
        assert tshow.main(flags + [ta], device="cpu") == 0
        assert capsys.readouterr().out.replace(str(tmp_path / "t"),
                                               "D") == want
        pairs = [(ja, ta)]
        assert jshow.main(["-infoonly", ja]) == 0
        want = capsys.readouterr().out
        assert tshow.main(["-infoonly", ta]) == 0   # no device, no plot
        assert capsys.readouterr().out == want
    else:
        assert jpng.main([ja, jb]) == 0
        assert tpng.main([ta, tb], device="cpu") == 0
        pairs = [(ja, ta), (jb, tb)]
    for a, b in pairs:
        assert_images_close(a[:-4] + ".png", b[:-4] + ".png")


def test_sum_profiles_equals_jax(tmp_path, capsys):
    from presto_tpu.apps import sum_profiles as jsum
    from presto_tpu_torch.apps import sum_profiles as tsum
    rng = np.random.default_rng(2)
    n = 64
    x = (np.arange(n) + 0.5) / n
    paths = []
    for i, shift in enumerate((0.0, 0.2, -0.15)):
        prof = 5.0 * np.exp(-0.5 * (((x - 0.5 - shift + 0.5) % 1.0 - 0.5)
                                    / 0.03) ** 2) + rng.normal(0, 0.05, n)
        path = str(tmp_path / ("p%d.bestprof" % i))
        with open(path, "w") as f:
            f.write("# Input file       =  x\n######\n")
            for j, v in enumerate(prof):
                f.write("%4d  %.7g\n" % (j, v))
        paths.append(path)
    paths.append(_pfd(str(tmp_path / "c.pfd"), L=64))
    for tmpl in ([], ["-t", paths[1]]):
        a, b = str(tmp_path / "j.prof"), str(tmp_path / "t.prof")
        assert jsum.main(tmpl + ["-o", a] + paths) == 0
        want = capsys.readouterr().out.replace(a, "OUT")
        assert tsum.main(tmpl + ["-o", b] + paths) == 0
        assert capsys.readouterr().out.replace(b, "OUT") == want
        assert _bytes(b) == _bytes(a)


@pytest.fixture(scope="module")
def datfile(tmp_path_factory):
    """A .dat/.inf with a 0.25 s pulsar and an events file."""
    d = tmp_path_factory.mktemp("stack")
    rng = np.random.default_rng(8)
    n, dt = 1 << 14, 1e-3
    t = np.arange(n) * dt
    x = rng.normal(0, 1, n) + 3.0 * np.exp(
        -0.5 * (((t / 0.25) % 1.0 - 0.4) / 0.03) ** 2)
    x.astype(np.float32).tofile(str(d / "p.dat"))
    write_inf(InfoData(name="p", N=float(n), dt=dt, telescope="GBT"),
              str(d / "p.inf"))
    np.savetxt(str(d / "ev.events"), np.sort(rng.uniform(0, 10, 300)))
    return d


@pytest.mark.parametrize("flags,inp", [(["--nsub", "4"], "p.dat"),
                                       (["--lines"], "ev.events"),
                                       (["--start", "2", "--end", "12"],
                                        "p.dat")],
                         ids=["nsub", "lines-events", "span"])
def test_pulsestack_equals_jax(datfile, tmp_path, capsys, flags, inp):
    from presto_tpu.apps import pulsestack as jps
    from presto_tpu_torch.apps import pulsestack as tps
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    argv = ["-p", "0.25", "-n", "32"] + flags
    assert jps.main(argv + ["-o", a, str(datfile / inp)]) == 0
    want = capsys.readouterr().out.replace(a, "OUT")
    assert tps.main(argv + ["-o", b, str(datfile / inp)]) == 0
    assert capsys.readouterr().out.replace(b, "OUT") == want
    assert _bytes(b) == _bytes(a)


def test_plot_spd_equals_jax(tmp_path, capsys):
    from presto_tpu.apps import plot_spd as jplot
    from presto_tpu_torch.apps import plot_spd as tplot
    for side in "jt":
        os.makedirs(str(tmp_path / side))
        for name in ("c.spd", "d.spd"):
            with open(str(tmp_path / side / name), "wb") as fh:
                _savez(fh, _spd())
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    assert jplot.main([jd + "/c.spd", jd + "/d.spd"]) == 0
    want = capsys.readouterr().out.replace(jd, "D")
    assert tplot.main([td + "/c.spd", td + "/d.spd"]) == 0
    assert capsys.readouterr().out.replace(td, "D") == want
    for name in ("c.png", "d.png"):
        assert _bytes(td + "/" + name) == _bytes(jd + "/" + name)
    with pytest.raises(SystemExit):
        tplot.main(["-o", "x.png", td + "/c.spd", td + "/d.spd"])


@pytest.mark.parametrize("orbit,flags", [(False, []), (True, ["-s"])],
                         ids=["solitary-phase", "binary-seconds"])
def test_pyplotres_equals_jax(tmp_path, capsys, orbit, flags):
    from presto_tpu.apps import pyplotres as jres
    from presto_tpu_torch.apps import pyplotres as tres
    rng = np.random.default_rng(6)
    n = 25
    path = str(tmp_path / "resid2.tmp")
    write_residuals(path, 55000 + np.arange(n) * 0.5,
                    rng.normal(0, 0.01, n), rng.normal(0, 1e-4, n),
                    orbit_phs=(np.linspace(0, 2, n) % 1.0 if orbit
                               else None),
                    uncertainty=np.full(n, 3.0))
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert jres.main(flags + ["-o", a, path]) == 0
    want = capsys.readouterr().out.replace(a, "OUT")
    assert tres.main(flags + ["-o", b, path]) == 0
    assert capsys.readouterr().out.replace(b, "OUT") == want
    assert _bytes(b) == _bytes(a)


def test_plot_clis_without_matplotlib_raise(datfile, tmp_path, monkeypatch):
    """Every drawing CLI raises ImportError naming matplotlib when it is
    missing; sum_profiles and show_pfd -infoonly draw nothing and run."""
    from presto_tpu_torch.apps import (pfd2png, plot_spd, pulsestack,
                                       pyplotres, show_pfd, sum_profiles)
    pfd = _pfd(str(tmp_path / "a.pfd"))
    spd = str(tmp_path / "c.spd")
    with open(spd, "wb") as fh:
        _savez(fh, _spd())
    resid = str(tmp_path / "resid2.tmp")
    write_residuals(resid, 55000 + np.arange(5.0), np.zeros(5),
                    np.zeros(5))
    hide_matplotlib(monkeypatch)
    for call in (lambda: show_pfd.main([pfd], device="cpu"),
                 lambda: pfd2png.main([pfd], device="cpu"),
                 lambda: plot_spd.main([spd]),
                 lambda: pulsestack.main(["-p", "0.25", "-o",
                                          str(tmp_path / "s.png"),
                                          str(datfile / "p.dat")]),
                 lambda: pyplotres.main(["-o", str(tmp_path / "r.png"),
                                         resid])):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert not [f for f in os.listdir(str(tmp_path)) if f.endswith(".png")]
    assert show_pfd.main(["-infoonly", pfd]) == 0
    assert sum_profiles.main(["-o", str(tmp_path / "s.prof"), pfd]) == 0


# ----------------------------------------------------------------------
# The plots the pipeline CLIs draw (their refusals lifted)
# ----------------------------------------------------------------------

F0, FD0, NDAT, DTDAT = 41.3, 2e-4, 1 << 14, 5e-4


@pytest.fixture(scope="module")
def lifted(tmp_path_factory):
    """The four CLIs' inputs: a .dat with a pulsar (prepfold), a
    filterbank with RFI (rfifind), .dat files with single pulses
    (single_pulse_search) and a PSRFITS file (psrfits_quick_bandpass)."""
    d = tmp_path_factory.mktemp("lifted")
    rng = np.random.default_rng(12)
    t = np.arange(NDAT) * DTDAT
    ph = F0 * t + 0.5 * FD0 * t * t
    x = rng.normal(size=NDAT) + 0.8 * np.exp(
        -0.5 * ((ph % 1.0 - 0.5) / 0.03) ** 2) + 10.0
    x.astype(np.float32).tofile(str(d / "x.dat"))
    write_inf(InfoData(name="x", N=float(NDAT), dt=DTDAT, telescope="GBT",
                       object="FAKEPSR", dm=49.0, mjd_i=59000,
                       mjd_f=0.25), str(d / "x.inf"))
    for i, dm in enumerate((30.0, 31.0)):
        y = rng.normal(100.0, 3.0, 20000).astype(np.float32)
        for p, w, a in ((2345, 3, 15.0), (7001, 12, 6.0),
                        (12000 + 500 * i, 1, 25.0)):
            y[p:p + w] += a
        y.tofile(str(d / ("s_DM%.2f.dat" % dm)))
        write_inf(InfoData(name="s_DM%.2f" % dm, N=20000.0, dt=1e-3,
                           dm=dm, telescope="GBT", freq=1300.0,
                           chan_wid=1.0, num_chan=64, freqband=64.0),
                  str(d / ("s_DM%.2f.inf" % dm)))
    nchan, n = 16, 1 << 14
    data = 64.0 + 6.0 * rng.normal(size=(n, nchan))
    data[:, 5] += 15.0
    data[4000:5000] += 4.0
    write_filterbank(str(d / "rfi.fil"), FilterbankHeader(
        nchans=nchan, nbits=8, tsamp=5e-4, fch1=1338.0 + 60.0, foff=-4.0,
        tstart=59000.0, source_name="RFI", telescope_id=6),
        np.clip(np.round(data), 0, 255))
    write_psrfits(str(d / "b.fits"),
                  (100.0 + 20.0 * rng.normal(size=(4096, nchan)))
                  .clip(0, 255).astype(np.float32), 5e-4,
                  1338.0 + 4.0 * np.arange(nchan)[::-1], nsblk=512,
                  nbits=8)
    return d


def _copy_inputs(src, dest, names):
    os.makedirs(dest, exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(src, n), dest)


CLIS = {
    "prepfold": (["x.dat", "x.inf"],
                 lambda m, dev: m.main(["-f", str(F0), "-fd", str(FD0),
                                        "-npfact", "1", "-n", "32",
                                        "-npart", "16", "-o", "f",
                                        "x.dat"], **dev),
                 ["f.pfd.png"], ["f.pfd"]),
    "rfifind": (["rfi.fil"],
                lambda m, dev: m.main(["-time", "1", "-o", "r", "rfi.fil"],
                                      **dev),
                ["r_rfifind.png"], ["r_rfifind.mask"]),
    "single_pulse_search": (
        ["s_DM30.00.dat", "s_DM30.00.inf", "s_DM31.00.dat",
         "s_DM31.00.inf"],
        lambda m, dev: m.main(["s_DM30.00.dat", "s_DM31.00.dat"], **dev),
        ["s_DM30.00_singlepulse.png"], []),
    "psrfits_quick_bandpass": (
        ["b.fits"], lambda m, dev: m.main(["-plot", "b.fits"]),
        ["b.bandpass.png"], ["b.bandpass"]),
}
MODS = {"prepfold": (jprepfold, tprepfold), "rfifind": (jrfifind, trfifind),
        "single_pulse_search": (jsps, tsps),
        "psrfits_quick_bandpass": (jbp, tbp)}


@pytest.mark.parametrize("cli", list(CLIS))
def test_lifted_plots_draw_and_need_matplotlib(lifted, tmp_path,
                                               monkeypatch, cli):
    """With matplotlib each CLI draws what the JAX CLI draws (bytes equal
    where the numbers drawn are host numbers, the pixel tolerance where
    they come from the device); with it hidden each raises ImportError
    naming matplotlib, before any work where a run always draws
    (prepfold, rfifind, -plot), after the .singlepulse files where only
    events make a plot."""
    inputs, run, pngs, work = CLIS[cli]
    jmod, tmod = MODS[cli]
    for side, mod, dev in (("j", jmod, {}), ("t", tmod, {"device": "cpu"})):
        d = str(tmp_path / side)
        _copy_inputs(str(lifted), d, inputs)
        _run_in(d, lambda: run(mod, dev))
    for name in pngs:
        a, b = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
        assert _bytes(b)[:4] == b"\x89PNG"
        if cli in ("prepfold", "rfifind"):
            assert_images_close(a, b)
        else:
            assert _bytes(b) == _bytes(a)
    d = str(tmp_path / "hidden")
    _copy_inputs(str(lifted), d, inputs)
    hide_matplotlib(monkeypatch)
    with pytest.raises(ImportError, match="matplotlib"):
        _run_in(d, lambda: run(tmod, {"device": "cpu"}))
    left = set(os.listdir(d)) - set(inputs)
    assert not left & set(pngs + work)
    if cli == "single_pulse_search":
        assert left == {"s_DM30.00.singlepulse", "s_DM31.00.singlepulse"}
