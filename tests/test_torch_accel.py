"""The port's acceleration search against the JAX package's TPU path.

The JAX side runs its TPU engine on the CPU: inside the test only,
``accel_pallas.pallas_available`` answers True, ``_use_mxu_engine``
becomes its fftlen check, and both Pallas factories build in interpret
mode.  That puts it on the aligned direct-plane geometry the port
implements.  The port runs its plain versions on the CPU.

Candidates more than 1% above their stage's powcut must have equal keys
(numharm, round(2r), round(2z)) in both lists, powers within rtol 1e-4
(the forward and inverse FFTs round differently in the two engines).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas, build_pallas
from presto_tpu_torch.search import accel as taccel

N = 1 << 16
DT = 1e-3


@pytest.fixture
def jax_tpu_path(monkeypatch):
    """The JAX package's TPU engine, on the CPU, for this test only."""
    monkeypatch.setattr(accel_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jaccel, "_use_mxu_engine",
                        lambda fftlen: fftlen % 256 == 0)
    monkeypatch.setattr(build_pallas, "make_plane_builder",
                        functools.partial(build_pallas.make_plane_builder,
                                          interpret=True))
    monkeypatch.setattr(accel_pallas, "make_stage_reducer",
                        functools.partial(accel_pallas.make_stage_reducer,
                                          interpret=True))


def spectra(nd, seed=11):
    """[nd, N/2, 2] packed spectra: noise plus an accelerating pulsar
    (different strength per trial)."""
    rng = np.random.default_rng(seed)
    t = np.arange(N) * DT
    out = []
    for d in range(nd):
        f0, fd = 37.3 + 3.1 * d, 0.004
        ph = f0 * t + 0.5 * fd * t * t
        x = rng.normal(size=N) + (0.08 + 0.03 * d) * (
            np.cos(2 * np.pi * ph) + 0.5 * np.cos(4 * np.pi * ph))
        full = np.fft.rfft(x.astype(np.float32).astype(np.float64))
        packed = full[:-1].copy()
        packed[0] = full[0].real + 1j * full[-1].real
        out.append(np.stack([packed.real, packed.imag], -1))
    return np.asarray(out, np.float32)


def strong_keys(cands, powcut):
    return {(c.numharm, round(2 * c.r), round(2 * c.z)): c.power
            for c in cands
            if c.power > 1.01 * powcut[int(np.log2(c.numharm))]}


def assert_lists_agree(want, got, powcut):
    kw, kg = strong_keys(want, powcut), strong_keys(got, powcut)
    assert kw, "no strong candidates to compare"
    assert set(kw) <= {(c.numharm, round(2 * c.r), round(2 * c.z))
                       for c in got}
    assert set(kg) <= {(c.numharm, round(2 * c.r), round(2 * c.z))
                       for c in want}
    pw = {(c.numharm, round(2 * c.r), round(2 * c.z)): c.power
          for c in got}
    for k, p in kw.items():
        np.testing.assert_allclose(pw[k], p, rtol=1e-4)


@pytest.mark.parametrize("slab,nd", [(1 << 20, 2), (1 << 14, 1)])
def test_search_many_matches_jax_tpu_path(jax_tpu_path, slab, nd):
    """slab 2^20 exceeds the spectrum: the JAX side scans numharm-
    aligned slabs; 2^14 engages its Pallas stage reducer's tiles."""
    batch = spectra(nd)
    cfg = jaccel.AccelConfig(zmax=20, numharm=8, sigma=3.0)
    T = N * DT
    js = jaccel.AccelSearch(cfg, T=T, numbins=N // 2)
    assert js._plb_hw_eff, "the JAX side must be on the TPU geometry"
    want = js.search_many(batch, slab=slab)

    tcfg = taccel.AccelConfig(**dataclasses.asdict(js.cfg))
    fz = jaccel._harm_fracs_and_zinds(js.cfg, js.cfg.numz)
    ts = taccel.from_reference_arrays(tcfg, T, N // 2,
                                      js.kern.kern_pairs, fz, js.numindep,
                                      js.powcut, device="cpu")
    got = ts.search_many(torch.from_numpy(batch), slab=slab)

    # the port's own host builders reproduce the reference state
    own = taccel.AccelSearch(taccel.AccelConfig(zmax=20, numharm=8,
                                                sigma=3.0),
                             T=T, numbins=N // 2, device="cpu")
    assert own.cfg == tcfg
    np.testing.assert_array_equal(own.kern.kern_pairs, js.kern.kern_pairs)
    for a, b in zip(own.fracs_zinds, fz):
        for (h, t, z), (h2, t2, z2) in zip(a, b):
            assert (h, t) == (h2, t2)
            np.testing.assert_array_equal(z, z2)
    assert own.powcut == js.powcut and own.numindep == js.numindep

    for w, g in zip(want, got):
        assert_lists_agree(w, g, js.powcut)
    # the injected pulsar tops each trial's cleaned list
    for d, g in enumerate(got):
        top = taccel.remove_duplicates(taccel.eliminate_harmonics(g))[0]
        f = top.r / T
        assert abs(f - (37.3 + 3.1 * d)) < 0.2 or \
            abs(f / 2 - (37.3 + 3.1 * d)) < 0.2


def test_median_norm_matches_jnp_median():
    """Even-count medians average the two middle order statistics."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    data = (rng.normal(size=(3, 4096))
            + 1j * rng.normal(size=(3, 4096))).astype(np.complex64)
    want = np.asarray(jaccel._block_median_norms_c(jnp.asarray(data)))
    got = taccel.block_median_norms(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_ties_break_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    v, i = taccel._topk_desc(x, 4)
    assert i.tolist() == [[1, 2, 4, 5]]
    assert v.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_entry_points_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        taccel.AccelSearch(taccel.AccelConfig(zmax=20), T=65.0,
                           numbins=N // 2)


def test_candidate_postprocessing_matches_jax():
    """eliminate_harmonics + remove_duplicates keep the same candidates
    as the JAX package's loops, on a list with harmonic families."""
    rng = np.random.default_rng(9)
    base = rng.uniform(50, 5000, 60)
    rs = np.concatenate([base, base[:20] * 2, base[:10] / 3,
                         base[:10] * 1.5 + 0.7, rng.uniform(50, 20000, 300)])
    sig = rng.uniform(2, 30, rs.size)
    nh = rng.choice([1, 2, 4, 8], rs.size)
    zs = rng.uniform(-20, 20, rs.size)
    jc = [jaccel.AccelCand(power=float(s * 3), sigma=float(s), numharm=int(h),
                           r=float(r), z=float(z))
          for r, s, h, z in zip(rs, sig, nh, zs)]
    tc = [taccel.AccelCand(power=c.power, sigma=c.sigma, numharm=c.numharm,
                           r=c.r, z=c.z) for c in jc]
    as_t = lambda cs: [(c.sigma, c.r, c.numharm, c.z) for c in cs]  # noqa
    want = jaccel.eliminate_harmonics(jc)
    assert as_t(taccel.eliminate_harmonics(tc)) == as_t(want)
    assert len(want) < len(jc)
    assert as_t(taccel.remove_duplicates(tc)) == \
        as_t(jaccel.remove_duplicates(jc))
    assert as_t(taccel.remove_duplicates(
        taccel.eliminate_harmonics(tc))) == as_t(
            jaccel.remove_duplicates(want))


SLAB_T = (1 << 22) * 1.28e-4
SLAB_NUMBINS = 1 << 21


@pytest.mark.parametrize("slab", [1 << 20, (1 << 16) + 512])
@pytest.mark.parametrize("zmax,numharm,rlo", [
    (200, 8, 0.0), (200, 16, 0.0), (200, 16, 300.0), (300, 8, 0.0),
    (300, 16, 0.0), (400, 8, 0.0), (600, 8, 0.0)])
def test_slab_plan_matches_jax_tpu_path(jax_tpu_path, zmax, numharm, rlo,
                                        slab):
    """The port's slab plan picks the JAX package's reducer tile (which
    steps down, or gives way to the numharm-aligned scanner, when its
    scratch estimate exceeds the TPU budget), so the slab starts agree.
    rlo 300 puts r0 mod 1024 at 600, where tiles 512 and 1024 differ."""
    cfg = jaccel.AccelConfig(zmax=zmax, numharm=numharm, rlo=rlo)
    js = jaccel.AccelSearch(cfg, T=SLAB_T, numbins=SLAB_NUMBINS)
    assert js._plb_hw_eff, "the JAX side must be on the TPU geometry"
    ts = taccel.AccelSearch(taccel.AccelConfig(zmax=zmax, numharm=numharm,
                                               rlo=rlo),
                            T=SLAB_T, numbins=SLAB_NUMBINS, device="cpu")
    assert ts.cfg == taccel.AccelConfig(**dataclasses.asdict(js.cfg))
    plane_numr = ts.plane_geom()[2]
    assert plane_numr == js._plane_geom().plane_numr
    w_slab, w_k, _scan, w_cols = js._slab_plan(plane_numr, slab)
    assert ts.slab_plan(plane_numr, slab) == (w_slab, w_k, w_cols)
    assert (ts._r0min, ts._rtop) == (js._r0min, js._rtop)


def test_search_matches_jax_where_no_reducer_tile_fits(jax_tpu_path):
    """zmax 300, numharm 16: the JAX package's scratch estimate fits no
    reducer tile, so it scans numharm-aligned slabs; the port follows
    and the candidate lists agree."""
    batch = spectra(1)
    cfg = jaccel.AccelConfig(zmax=300, numharm=16, sigma=3.0)
    T = N * DT
    js = jaccel.AccelSearch(cfg, T=T, numbins=N // 2)
    assert js._plb_hw_eff, "the JAX side must be on the TPU geometry"
    want = js.search_many(batch)[0]
    ts = taccel.AccelSearch(taccel.AccelConfig(**dataclasses.asdict(js.cfg)),
                            T=T, numbins=N // 2, device="cpu")
    numr = ts.plane_geom()[2]
    assert taccel.reference_tile(ts.fracs_zinds, ts.cfg.numz,
                                 min(1 << 20, numr)) is None
    got = ts.search_many(torch.from_numpy(batch))[0]
    assert_lists_agree(want, got, js.powcut)


def short_spectrum(numbins, seed=3, dt=1e-3):
    """[numbins, 2] packed spectrum of 2 * numbins samples: noise plus an
    accelerating 37.3 Hz pulsar; returns (pairs, T)."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * numbins) * dt
    x = rng.normal(size=t.size) + 0.3 * np.cos(
        2 * np.pi * (37.3 * t + 0.4 * t * t))
    full = np.fft.rfft(x.astype(np.float32).astype(np.float64))
    packed = full[:-1].copy()
    packed[0] = full[0].real + 1j * full[-1].real
    return (np.stack([packed.real, packed.imag], -1).astype(np.float32),
            t.size * dt)


@pytest.mark.parametrize("numbins,fftlen", [(512, 2048), (3000, 8192)])
def test_short_spectra_match_jax_tpu_path(jax_tpu_path, numbins, fftlen):
    """Spectra too short for the aligned geometry (uselen cut to
    2 * (numbins - 16), no multiple of 128): the JAX package's TPU path
    builds the plane with a non-Pallas engine at the exact halfwidth and
    pads it to the reducer tile; the port takes the same geometry, the
    same slab plan and the same candidates (zmax 200, numharm 8,
    sigma 2)."""
    pairs, T = short_spectrum(numbins)
    cfg = jaccel.AccelConfig(zmax=200, numharm=8, sigma=2.0)
    js = jaccel.AccelSearch(cfg, T=T, numbins=numbins)
    assert not js._plb_hw_eff and js.kern.fftlen == fftlen
    want = js.search_many(pairs[None])[0]
    ts = taccel.AccelSearch(taccel.AccelConfig(zmax=200, numharm=8,
                                               sigma=2.0),
                            T=T, numbins=numbins, device="cpu")
    assert ts.cfg == taccel.AccelConfig(**dataclasses.asdict(js.cfg))
    assert not ts.aligned and ts.hw_eff == js.kern.halfwidth
    assert ts.plane_geom()[2] == js._plane_geom().plane_numr
    got = ts.search_many(torch.from_numpy(pairs[None]))[0]
    assert len(got) == len(want) > 100
    assert_lists_agree(want, got, js.powcut)


@pytest.mark.parametrize("numbins,zmax,log2n", [(100, 0, 8), (200, 20, 9)])
def test_short_spectra_use_the_small_templates(numbins, zmax, log2n):
    """At small zmax a short spectrum's fftlen falls to 256 or 512, which
    the plane builder has templates for; nothing below 256 is planned."""
    pairs, T = short_spectrum(numbins)
    s = taccel.AccelSearch(taccel.AccelConfig(zmax=zmax, numharm=4,
                                              sigma=2.0),
                           T=T, numbins=numbins, device="cpu")
    assert s.kern.fftlen == 1 << log2n
    assert s.search(pairs)
    with pytest.raises(ValueError, match="templates"):
        taccel.AccelSearch(taccel.AccelConfig(zmax=0, uselen=40),
                           T=T, numbins=numbins, device="cpu")
