"""The port's .pfd plot (presto_tpu_torch/plotting/pfdplot.py) against the
JAX package's, on the CPU.

The .pfd is made from a numpy seed: 16 parts x 8 subbands x 32 bins, a
drifting pulse, 9 trial DMs and a 9 x 9 (P, Pdot) grid as prepfold lays
it out.  The panels' numbers: the expected statistics and the part times
are host float64 code (equal); the chi2 growth curve is float64
cumulative sums in another order (rtol 1e-12); the chi2(P, Pdot) plane
and the DM curve both go through a float32 rotate-and-sum, the plane
through the fold search's ``_trial_chi2`` in each package, the DM curve
through ``combine_profs`` in the JAX package and one batched
``rotate_sum`` in the port, which sum in their own order (rtol 1e-5).

The drawing: given the JAX package's panel numbers, plot_pfd writes the
JAX package's PNG bytes for the default flags and each of the five
flags; with its own numbers the decoded image differs from the JAX
package's in at most PIXEL_FRACTION of its pixels, each channel by at
most PIXEL_ATOL (the float32 plane's colour levels and curves).
"""

import os
import sys

import numpy as np
import pytest

from presto_tpu.io.pfd import Pfd as JPfd
from presto_tpu.io.pfd import read_pfd as jread
from presto_tpu.io.pfd import write_pfd as jwrite
from presto_tpu.plotting import pfdplot as jp
from presto_tpu_torch.io.pfd import read_pfd as tread
from presto_tpu_torch.plotting import pfdplot as tp

NPART, NSUB, L, NGRID = 16, 8, 32, 9
F0, FD0, T = 5.0, 1e-5, 600.0
PIXEL_FRACTION = 1e-3
PIXEL_ATOL = 3.0 / 255
FLAGS = [None, "scaleparts", "allgrey", "justprofs", "fixchi", "portrait"]


def seeded_pfd(path, seed=5, stats=True, ndm=NGRID, ngrid=NGRID):
    rng = np.random.default_rng(seed)
    profs = rng.normal(100, 5, (NPART, NSUB, L))
    ph = np.arange(L) / L
    for i in range(NPART):
        for j in range(NSUB):
            c = 0.4 + 0.01 * i + 0.015 * j
            profs[i, j] += 40 * np.exp(-0.5 * ((ph - c) / 0.03) ** 2)
    st = np.zeros((NPART, NSUB, 7))
    st[:, :, 0] = rng.uniform(900, 1100, (NPART, NSUB)).round()
    if stats:
        st[:, :, 1] = 100.0 / L
        st[:, :, 2] = 25.0 / L
    df, dfd = 2.0 / (L * T), 8.0 / (L * T * T)
    fs = (np.arange(ngrid) - ngrid // 2) * df
    fds = (np.arange(ngrid) - ngrid // 2) * dfd
    jwrite(path, JPfd(
        npart=NPART, nsub=NSUB, proflen=L, numchan=64,
        dt=T / (NPART * 1000.0), tepoch=59000.25, fold_p1=F0, fold_p2=FD0,
        lofreq=1300.0, chan_wid=4.0, bestdm=50.0, candnm="SEEDED",
        filenm="seeded.fil", telescope="GBT", dms=np.linspace(45, 55, ndm),
        periods=1.0 / (F0 - fs), pdots=-(FD0 - fds) / F0 ** 2,
        profs=profs, stats=st, numdms=ndm, numperiods=ngrid,
        numpdots=ngrid))
    return path


@pytest.fixture(scope="module")
def pfds(tmp_path_factory):
    path = seeded_pfd(str(tmp_path_factory.mktemp("pfd") / "s.pfd"))
    return jread(path), tread(path)


def _sums(p):
    profs = np.asarray(p.profs, float)
    return profs.sum(axis=1), profs.sum(axis=0)


def test_expected_stats_and_part_times_equal_jax(pfds):
    pj, pt = pfds
    assert tp._expected_stats(pt) == jp._expected_stats(pj)
    np.testing.assert_array_equal(tp._part_times(pt), jp._part_times(pj))


def test_ppd_chi2_plane_equals_jax(pfds):
    pj, pt = pfds
    tvph, _ = _sums(pj)
    want = jp._ppd_chi2_plane(pj, tvph)
    got = tp._ppd_chi2_plane(pt, tvph, "cpu")
    assert got.shape == (NGRID, NGRID) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the pulse drifts by 0.01 turns a part: the plane peaks off centre
    assert np.unravel_index(np.argmax(got), got.shape) == \
        np.unravel_index(np.argmax(want), want.shape)


def test_dm_chi2_curve_equals_jax(pfds):
    pj, pt = pfds
    _, svph = _sums(pj)
    want = jp._dm_chi2_curve(pj, svph)
    got = tp._dm_chi2_curve(pt, svph, "cpu")
    assert got.shape == (NGRID,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_chi2_vs_time_equals_jax(pfds):
    pj, pt = pfds
    tvph, _ = _sums(pj)
    want = jp._chi2_vs_time(pj, tvph)
    got = tp._chi2_vs_time(pt, tvph, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(np.diff(got) > 0)      # the pulse adds up part by part


def test_pfd_panels_hold_each_function(pfds):
    _, pt = pfds
    tvph, svph = _sums(pt)
    pan = tp.pfd_panels(pt, device="cpu")
    assert (pan["prof_avg"], pan["prof_var"]) == tp._expected_stats(pt)
    np.testing.assert_array_equal(pan["part_times"], tp._part_times(pt))
    np.testing.assert_array_equal(pan["growth"],
                                  tp._chi2_vs_time(pt, tvph, "cpu"))
    np.testing.assert_array_equal(pan["dm_chi2"],
                                  tp._dm_chi2_curve(pt, svph, "cpu"))
    np.testing.assert_array_equal(pan["plane"],
                                  tp._ppd_chi2_plane(pt, tvph, "cpu"))


def test_panels_without_stats_or_grids_equal_jax(tmp_path):
    """No stats stored (the shape-normalized branches), and a fold with
    one DM and a one-point grid (no DM curve, no plane)."""
    path = seeded_pfd(str(tmp_path / "n.pfd"), seed=6, stats=False)
    pj, pt = jread(path), tread(path)
    tvph, svph = _sums(pj)
    np.testing.assert_allclose(tp._ppd_chi2_plane(pt, tvph, "cpu"),
                               jp._ppd_chi2_plane(pj, tvph), rtol=1e-5)
    np.testing.assert_allclose(tp._dm_chi2_curve(pt, svph, "cpu"),
                               jp._dm_chi2_curve(pj, svph), rtol=1e-5)
    np.testing.assert_array_equal(tp._chi2_vs_time(pt, tvph, "cpu"),
                                  jp._chi2_vs_time(pj, tvph))
    path = seeded_pfd(str(tmp_path / "o.pfd"), ndm=1, ngrid=1)
    pan = tp.pfd_panels(tread(path), device="cpu")
    assert pan["dm_chi2"] is None and pan["plane"] is None
    assert pan["growth"].shape == (NPART,)


def _jax_panels(pj):
    tvph, svph = _sums(pj)
    avg, var = jp._expected_stats(pj)
    return dict(prof_avg=avg, prof_var=var, part_times=jp._part_times(pj),
                growth=jp._chi2_vs_time(pj, tvph),
                dm_chi2=jp._dm_chi2_curve(pj, svph),
                plane=jp._ppd_chi2_plane(pj, tvph))


def _image(path):
    import matplotlib.image as mimg
    return mimg.imread(path)


@pytest.mark.parametrize("flag", FLAGS, ids=[f or "default" for f in FLAGS])
def test_plot_pfd_equals_jax(pfds, tmp_path, monkeypatch, flag):
    pj, pt = pfds
    kw = {flag: True} if flag else {}
    jpng, tpng = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jp.plot_pfd(pj, jpng, flags=jp.PlotFlags(**kw))
    want = open(jpng, "rb").read()
    assert want[:4] == b"\x89PNG"
    # the JAX package's numbers in: the JAX package's bytes out
    with monkeypatch.context() as m:
        m.setattr(tp, "pfd_panels", lambda p, device: _jax_panels(pj))
        assert tp.plot_pfd(pt, tpng, flags=tp.PlotFlags(**kw),
                           device="cpu") == tpng
    assert open(tpng, "rb").read() == want
    # its own numbers: the same picture within the pixel tolerance
    tp.plot_pfd(pt, tpng, flags=tp.PlotFlags(**kw), device="cpu")
    a, b = _image(jpng), _image(tpng)
    assert a.shape == b.shape
    diff = np.abs(a - b).max(axis=-1)
    assert (diff > 0).mean() <= PIXEL_FRACTION
    assert diff.max() <= PIXEL_ATOL
    if flag == "justprofs":            # no chi2 panel: equal bytes
        assert open(tpng, "rb").read() == want


def test_panels_need_no_matplotlib_and_drawing_does(pfds, tmp_path,
                                                    monkeypatch):
    """With matplotlib hidden the panels are computed and plot_pfd raises
    ImportError naming matplotlib, writing nothing."""
    _, pt = pfds
    for name in [m for m in sys.modules if m.startswith("matplotlib.")] \
            + ["matplotlib"]:
        monkeypatch.setitem(sys.modules, name, None)
    pan = tp.pfd_panels(pt, device="cpu")
    assert pan["plane"].shape == (NGRID, NGRID)
    out = str(tmp_path / "x.png")
    with pytest.raises(ImportError, match="matplotlib"):
        tp.plot_pfd(pt, out, device="cpu")
    assert not os.path.exists(out)
