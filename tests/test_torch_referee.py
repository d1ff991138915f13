"""The port's float64 referee (search/accel_ref) and corr_rz_plane against
the JAX package's, and the port's float32 search held to its referee.

The JAX side runs its TPU geometry on the CPU (inside the test only,
``accel_pallas.pallas_available`` answers True and ``_use_mxu_engine``
becomes its fftlen check), the aligned geometry the port implements: the
retuned uselen and the block read windows at the effective halfwidth.
Over the same geometry the two referees compute the same float64 plane,
so their lists have the same keys (numharm, round(2r), round(2z)) with
powers and sigmas within RTOL.  The port's float32 search on the CPU
(its kernels' plain versions) is held to its own float64 referee by
``accel_ref.agreement``, tests/test_referee.py's rule.
"""

import numpy as np
import pytest

from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas
from presto_tpu.search import accel_ref as jref
from presto_tpu.search import optimize as joptimize
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import accel_ref as tref
from presto_tpu_torch.search import optimize as toptimize

RTOL = 1e-9


@pytest.fixture
def jax_tpu_geometry(monkeypatch):
    """The JAX package's TPU plane geometry, on the CPU, for this test."""
    monkeypatch.setattr(accel_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jaccel, "_use_mxu_engine",
                        lambda fftlen: fftlen % 256 == 0)


def chirp_pairs(numbins, tones, seed=99):
    """tests/test_referee.py's spectrum: noise plus tones (r0, z, amp)
    that start at bin r0 and drift z bins over the observation."""
    N = 2 * numbins
    rng = np.random.default_rng(seed)
    t = np.arange(N) / N
    x = rng.normal(size=N)
    for (r0, z, amp) in tones:
        x += amp * np.cos(2 * np.pi * (r0 * t + 0.5 * z * t * t))
    X = np.fft.rfft(x)[:numbins]
    return np.stack([X.real, X.imag], -1).astype(np.float32)


def keyed(cands):
    return {(c.numharm, round(2 * c.r), round(2 * c.z)): c for c in cands}


def test_corr_rz_plane_equals_jax():
    """corr_rz_plane: float64, within 1e-12 relative of the JAX
    function."""
    rng = np.random.default_rng(3)
    n = 4096
    t = np.arange(2 * n) / (2 * n)
    x = rng.normal(size=2 * n) + 0.3 * np.cos(
        2 * np.pi * (800.3 * t + 3.0 * t * t))
    amps = np.fft.rfft(x)[:n].astype(np.complex64)
    args = (amps, 800.0, 804.0, 0.25, -2.0, 6.0, 0.5)
    want = joptimize.corr_rz_plane(*args)
    got = toptimize.corr_rz_plane(*args)
    assert got.shape == want.shape == (17, 17)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_search_ref_equals_jax(jax_tpu_geometry):
    """search_ref at 2^15 bins, zmax 20, numharm 4, float64: the same
    keys as the JAX referee's, powers and sigmas within RTOL."""
    numbins, T = 1 << 15, 100.0
    pairs = chirp_pairs(numbins, [(3000.5, 0.0, 0.3),
                                  (9000.25, 10.0, 0.3),
                                  (20000.0, -12.0, 0.35)])
    kw = dict(zmax=20, numharm=4, sigma=3.0)
    want = keyed(jref.search_ref(pairs, jaccel.AccelConfig(**kw), T,
                                 dtype=np.float64))
    search = taccel.AccelSearch(taccel.AccelConfig(**kw), T=T,
                                numbins=numbins, device="cpu")
    got = keyed(tref.search_ref(pairs, search, dtype=np.float64))
    assert len(want) > 10
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].power == pytest.approx(w.power, rel=RTOL, abs=0)
        assert got[k].sigma == pytest.approx(w.sigma, rel=RTOL, abs=0)


def test_float32_search_matches_its_float64_referee():
    """The port's float32 search (the kernels' plain versions on the
    CPU) against its own float64 referee over the same geometry, both
    after remove_duplicates, by test_referee.py's rule: isolated strong
    candidates equal in key, sigma within 0.1 and power within 1e-3,
    at least three of them, and every strong cluster on both sides; the
    four tones recovered at their mid-observation r."""
    numbins, T, cutoff = 1 << 16, 300.0, 3.0
    tones = [(5000.5, 0.0, 0.1), (20000.25, 10.0, 0.12),
             (43210.0, -15.0, 0.13), (53100.0, 4.0, 0.11)]
    pairs = chirp_pairs(numbins, tones)
    cfg = taccel.AccelConfig(zmax=30, numharm=4, sigma=cutoff)
    search = taccel.AccelSearch(cfg, T=T, numbins=numbins, device="cpu")
    dev = taccel.remove_duplicates(search.search(pairs))
    ref = taccel.remove_duplicates(tref.search_ref(pairs, search,
                                                   dtype=np.float64))
    res = tref.agreement(dev, ref, cutoff)
    assert res["ok"], res["failures"]
    assert res["exact"] >= 3 and res["max_sigma_diff"] < 1e-3
    for (r0, z, _amp) in tones:
        rmid = r0 + 0.5 * z
        assert any(abs(c.r - rmid) < 7.5 for c in ref), r0
        assert any(abs(c.r - rmid) < 7.5 for c in dev), r0


def test_agreement_flags_a_missing_and_a_weaker_cluster():
    """agreement fails a list that lost an isolated strong candidate or
    holds it far weaker, and passes the referee's own list."""
    C = taccel.AccelCand
    ref = [C(400.0, 20.0, 1, 1000.0, 0.0), C(300.0, 15.0, 1, 5000.0, 2.0),
           C(200.0, 12.0, 2, 9000.5, -4.0), C(30.0, 3.2, 1, 12000.0, 0.0)]
    assert tref.agreement(ref, ref, 3.0)["ok"]
    lost = tref.agreement(ref[1:], ref, 3.0)
    assert not lost["ok"] and lost["exact"] == 2
    weak = [C(c.power * 0.5, c.sigma - 2.0, c.numharm, c.r, c.z)
            for c in ref]
    res = tref.agreement(weak, ref, 3.0)
    assert not res["ok"] and res["max_sigma_diff"] == pytest.approx(2.0)


def test_timed_jerk_ref_equals_jax(jax_tpu_geometry):
    """timed_jerk_ref at a small jerk shape (2^14 bins, zmax 10, wmax
    20, numharm 2): the JAX function's ncands and cells."""
    nb = 1 << 14
    rng = np.random.default_rng(5)
    t = np.arange(2 * nb) / (2 * nb)
    x = (rng.normal(size=2 * nb)
         + 0.15 * np.cos(2 * np.pi * (3000.3 * t + 2.0 * t * t
                                      + 4 * t ** 3 / 3))
         + 0.12 * np.cos(2 * np.pi * 9000.6 * t))
    X = np.fft.rfft(x)[:nb]
    pairs = np.stack([X.real, X.imag], -1).astype(np.float32)
    kw = dict(zmax=10, wmax=20, numharm=2, sigma=2.0)
    jn, _js, jcells = jref.timed_jerk_ref(pairs, jaccel.AccelConfig(**kw),
                                          50.0)
    search = taccel.AccelSearch(taccel.AccelConfig(**kw), T=50.0,
                                numbins=nb, device="cpu")
    tn, ts, tcells = tref.timed_jerk_ref(pairs, search)
    assert jn > 0
    assert (tn, tcells) == (jn, jcells)
    assert ts > 0
