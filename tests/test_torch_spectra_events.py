"""The port's io/spectra, utils/events, utils/gaussfit and the event_peak
CLI against the JAX package's, on the CPU.

All four are host NumPy/SciPy in both packages.  Spectra's every method
gives the JAX container's bytes; the event statistics agree within
EVENTS_RTOL; a Gaussian fit, its .gaussians file and its read-back are
the JAX functions'; event_peak prints the JAX CLI's text and draws its
pixels.
"""

import numpy as np
import pytest

from presto_tpu.apps import event_peak as jevent_peak
from presto_tpu.io import spectra as jspectra
from presto_tpu.utils import events as jevents
from presto_tpu.utils import gaussfit as jgaussfit
from presto_tpu_torch.apps import event_peak as tevent_peak
from presto_tpu_torch.io import spectra as tspectra
from presto_tpu_torch.utils import events as tevents
from presto_tpu_torch.utils import gaussfit as tgaussfit

EVENTS_RTOL = 1e-12


def _pair(freqs=None, nspec=500, seed=8):
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1500.0, 1200.0, 16) if freqs is None else freqs
    data = rng.normal(5.0, 1.0, (len(freqs), nspec)).astype(np.float32)
    data[3, 100:140] += 9.0
    return (jspectra.Spectra(freqs, 1e-3, data.copy(), 2.5, dm=0.0),
            tspectra.Spectra(freqs, 1e-3, data.copy(), 2.5, dm=0.0))


def _same(j, t):
    assert t.data.dtype == np.float32
    assert t.data.tobytes() == j.data.tobytes()
    assert t.freqs.tobytes() == j.freqs.tobytes()
    assert (t.dt, t.starttime, t.dm) == (j.dt, j.starttime, j.dm)


@pytest.mark.parametrize("op", [
    "shift_channels", "dedisperse", "dedisperse_ref", "subband",
    "subband_subdm", "downsample", "trim", "scaled", "scaled_indep",
    "mask_channels", "scrub", "reductions"])
def test_spectra_methods_equal_jax(op):
    """Every Spectra method: the JAX container's bytes (in place or in
    the returned container)."""
    j, t = _pair()
    if op == "shift_channels":
        bins = np.arange(16) * 37 - 200
        bins[5] = 900                   # beyond the block: all pad
        for s in (j, t):
            s.shift_channels(bins, padval=-1.0)
    elif op in ("dedisperse", "dedisperse_ref"):
        ref = 1350.0 if op == "dedisperse_ref" else None
        j.dedisperse(55.0, ref_freq=ref)
        t.dedisperse(55.0, ref_freq=ref)
        j.dedisperse(20.0)
        t.dedisperse(20.0)
    elif op in ("subband", "subband_subdm"):
        sub = 30.0 if op == "subband_subdm" else None
        j, t = j.subband(4, subdm=sub), t.subband(4, subdm=sub)
        with pytest.raises(ValueError):
            t.subband(5)
    elif op == "downsample":
        j, t = j.downsample(7), t.downsample(7)
    elif op == "trim":
        j, t = j.trim(30, 250), t.trim(30, 250)
    elif op in ("scaled", "scaled_indep"):
        for s in (j, t):
            s.data[7] = 3.0                  # a constant channel: std 0
        ind = op == "scaled_indep"
        j, t = j.scaled(indep=ind), t.scaled(indep=ind)
    elif op == "mask_channels":
        j.mask_channels([0, 9, 15], 2.0)
        t.mask_channels([0, 9, 15], 2.0)
    elif op == "scrub":
        for s in (j, t):
            s.data[2, 5] = np.nan
            s.data[4, 7:9] = np.inf
        assert t.scrub(0.5) == j.scrub(0.5) == 3
        assert t.scrub() == 0
    else:
        assert (t.numchans, t.numspectra) == (j.numchans, j.numspectra)
        assert t.get_chan(3).tobytes() == j.get_chan(3).tobytes()
        assert t.mean_spectrum().tobytes() == j.mean_spectrum().tobytes()
        assert t.timeseries().tobytes() == j.timeseries().tobytes()
    _same(j, t)


def test_spectra_rejects_mismatched_rows():
    with pytest.raises(ValueError):
        tspectra.Spectra(np.arange(4.0), 1e-3, np.zeros((3, 10)))


def _events(n=400, f=2.37, seed=6):
    """Event times (s) over 2000 s: half uniform, half pulsed at f."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform(0.0, 2000.0, n // 2)
    k = rng.integers(0, int(2000 * f), n - n // 2)
    pul = (k + 0.5 + 0.03 * rng.normal(size=k.size)) / f
    return np.sort(np.concatenate([uni, pul]))


def test_event_statistics_equal_jax():
    """fold_events, Z^2_m and its probability, Rayleigh, the H-test and
    the Kuiper test: within EVENTS_RTOL of the JAX functions."""
    ev = _events()
    np.testing.assert_allclose(
        tevents.fold_events(ev, 2.37, 1e-6, 1e-12, t0=3.0),
        jevents.fold_events(ev, 2.37, 1e-6, 1e-12, t0=3.0),
        rtol=EVENTS_RTOL, atol=0)
    for f in (2.37, 1.13):
        ph_j = jevents.fold_events(ev, f)
        ph_t = tevents.fold_events(ev, f)
        pairs = [
            (tevents.z2m(ph_t, 3), jevents.z2m(ph_j, 3)),
            (tevents.rayleigh(ph_t), jevents.rayleigh(ph_j)),
            (tevents.z2m_prob(7.5, 2), jevents.z2m_prob(7.5, 2)),
            (tevents.kuiper_statistic(ph_t),
             jevents.kuiper_statistic(ph_j)),
            (tevents.kuiper_prob(0.12, 400), jevents.kuiper_prob(0.12, 400)),
        ]
        pairs += list(zip(tevents.htest(ph_t), jevents.htest(ph_j)))
        pairs += list(zip(tevents.kuiper_uniform_test(ph_t),
                          jevents.kuiper_uniform_test(ph_j)))
        for got, want in pairs:
            assert got == pytest.approx(want, rel=EVENTS_RTOL, abs=0)
    assert tevents.htest(np.array([])) == jevents.htest(np.array([]))
    assert tevents.z2m(np.array([])) == 0.0
    assert tevents.kuiper_prob(0.0, 10) == 1.0


def test_gaussfit_fit_and_files_equal_jax(tmp_path):
    """fit_gaussians (seeded and from given components), gauss_profile,
    and a .gaussians file written and read back: the JAX functions'."""
    n = 128
    comps = [jgaussfit.GaussComponent(0.3, 0.04, 5.0),
             jgaussfit.GaussComponent(0.62, 0.08, 2.0)]
    rng = np.random.default_rng(2)
    prof = jgaussfit.gauss_profile(n, comps, 1.0) + rng.normal(0, 0.1, n)
    tcomps = [tgaussfit.GaussComponent(c.phase, c.fwhm, c.ampl)
              for c in comps]
    assert tgaussfit.gauss_profile(n, tcomps, 1.0).tobytes() == \
        jgaussfit.gauss_profile(n, comps, 1.0).tobytes()
    for kw in ({"ngauss": 2}, {"init": "given"}):
        jkw = {"init": comps} if kw.get("init") else kw
        tkw = {"init": tcomps} if kw.get("init") else kw
        jc, jdc, jrms = jgaussfit.fit_gaussians(prof, **jkw)
        tc, tdc, trms = tgaussfit.fit_gaussians(prof, **tkw)
        assert (tdc, trms) == (jdc, jrms)
        assert [(c.phase, c.fwhm, c.ampl) for c in tc] == \
            [(c.phase, c.fwhm, c.ampl) for c in jc]
    a, b = str(tmp_path / "a.gaussians"), str(tmp_path / "b.gaussians")
    jgaussfit.write_gaussians(a, jc, jdc, ref="x.pfd")
    tgaussfit.write_gaussians(b, tc, tdc, ref="x.pfd")
    assert open(b).read() == open(a).read()
    rc, rdc = tgaussfit.read_gaussians(b)
    jrc, jrdc = jgaussfit.read_gaussians(a)
    assert rdc == jrdc
    assert [(c.phase, c.fwhm, c.ampl) for c in rc] == \
        [(c.phase, c.fwhm, c.ampl) for c in jrc]


@pytest.mark.parametrize("unit", ["seconds", "days"])
def test_event_peak_equals_jax(tmp_path, capsys, monkeypatch, unit):
    """event_peak over a (f, fdot) grid: the JAX CLI's text, and with -o
    its contour plot's pixels."""
    import matplotlib.image as mimg
    ev = _events(n=300)
    if unit == "days":
        ev = 55000.0 + ev / 86400.0 * 20.0      # a span under 100 days
    path = str(tmp_path / "ev.txt")
    np.savetxt(path, ev, fmt="%.12f")
    monkeypatch.chdir(tmp_path)
    for mod, out in ((jevent_peak, "j.png"), (tevent_peak, "t.png")):
        assert mod.main(["-n", "9", "-o", out, "ev.txt", "2.37",
                         "1e-9"]) == 0
    jout, tout = capsys.readouterr().out.split("event_peak: wrote j.png\n")
    assert tout == jout + "event_peak: wrote t.png\n"
    assert np.array_equal(mimg.imread("t.png"), mimg.imread("j.png"))
    assert tevent_peak.main(["-n", "5", "ev.txt", "2.37"]) == 0
