"""The port's jerk search (wmax) against the JAX package's, on the CPU.

The JAX side runs its TPU path (the ``jax_tpu_path`` fixture: the Pallas
plane builder and stage reducer in interpret mode); the port runs its
plain versions.  Tolerances:

  * host builders (w responses, kernel banks, fftlen, the w grid, the
    subharmonic w, powcuts) are byte-equal: both are the same float64
    numpy;
  * search candidates: every candidate above 1.01 powcut has its key
    (numharm, r, z, w) in both lists, powers within rtol 1e-4, sigma
    within 1e-3 (the two engines' FFTs round differently), as in
    tests/test_torch_accel.py;
  * the multi-plane reduction + collect is bit-equal to the JAX scan
    (the same float32 adds in the same order);
  * rzw_interp / power_at_rzw / max_rzw_arr within float64 rounding
    (rtol 1e-12);
  * the jerk polish by ``search/polish.agreement`` with ``jerk=True``:
    the same (r, z, w) grid point (power rtol 1e-4, sigma 1e-3), or a
    near-tie move of at most 6 final-stage steps whose descent
    objectives differ within the 3-D final grid's curvature bound (plus
    2 JERK_EVAL_RTOL) with each reported power its point's final
    measurement within 2 JERK_EVAL_RTOL, the two reported powers within
    the final measurement's own change across the move (its stencil
    gradient and curvature) and the sigmas within that gap's sigma, or
    a tie path that the descent replay reaches; none unexplained;
  * the ``_JERK_`` table and .cand by
    ``apps/accel_agreement.jerk_file_agreement``: on the same grid point
    the .cand's r, z, w bytes equal, power and sigma as above, and the
    table line byte-equal (or a named %.2f rounding boundary); every
    other line explained by both polishes' agreement.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from presto_tpu.apps import accelsearch as japp
from presto_tpu.io.infodata import InfoData as JInfoData
from presto_tpu.io.infodata import write_inf as jwrite_inf
from presto_tpu.ops import responses as jresp
from presto_tpu.search import accel as jaccel
from presto_tpu.search import optimize as jopt
from presto_tpu.search import polish as jpolish
from presto_tpu_torch.apps import accel_agreement
from presto_tpu_torch.apps import accelsearch as tapp
from presto_tpu_torch.ops import responses as tresp
from presto_tpu_torch.ops import stats as tst
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import accel_cuda
from presto_tpu_torch.search import optimize as topt
from presto_tpu_torch.search import polish as tpolish
from test_torch_accel import jax_tpu_path  # noqa: F401

NBINS = 1 << 14
T = 2 * NBINS * 4e-3
# (f0 Hz, z, w, amplitude): z = fdot T^2, w = fdotdot T^3 at the start
PULSARS = ((40.3, 10.0, 30.0, 0.15), (23.9, -6.0, -40.0, 0.12))


def jerk_spectrum(nbins=NBINS, T=T, pulsars=PULSARS, seed=17):
    """[nbins, 2] packed spectrum of 2 nbins samples: noise plus pulsars
    with a first and a second harmonic."""
    rng = np.random.default_rng(seed)
    n = 2 * nbins
    t = np.arange(n) * (T / n)
    x = rng.normal(size=n)
    for f0, z, w, amp in pulsars:
        ph = f0 * t + 0.5 * z / T ** 2 * t * t + w / T ** 3 * t ** 3 / 6
        x += amp * (np.cos(2 * np.pi * ph) + 0.5 * np.cos(4 * np.pi * ph))
    full = np.fft.rfft(x.astype(np.float32).astype(np.float64))
    packed = full[:-1].copy()
    packed[0] = full[0].real + 1j * full[-1].real
    return np.stack([packed.real, packed.imag], -1).astype(np.float32)


def key(c):
    """A search candidate's grid cell: r, z and w are exact float64
    quotients of integers on both sides."""
    return (c.numharm, c.r, c.z, c.w)


def assert_search_agrees(want, got, powcut):
    strong = [c for c in want
              if c.power > 1.01 * powcut[int(np.log2(c.numharm))]]
    assert strong, "no strong candidates to compare"
    kg = {key(c): c for c in got}
    kw = {key(c): c for c in want}
    for c in strong:
        assert key(c) in kg, c
        np.testing.assert_allclose(kg[key(c)].power, c.power, rtol=1e-4)
        assert abs(kg[key(c)].sigma - c.sigma) <= 1e-3
    for c in got:
        if c.power > 1.01 * powcut[int(np.log2(c.numharm))]:
            assert key(c) in kw, c


# ----------------------------------------------------------------------
# Host builders
# ----------------------------------------------------------------------


def test_w_responses_byte_equal():
    for z in (0.0, 3.0, -17.5, 100.0):
        for w in (0.0, 1e-8, 20.0, -60.0, 300.0):
            for acc in (tresp.LOWACC, tresp.HIGHACC):
                assert tresp.w_resp_halfwidth(z, w, acc) == \
                    jresp.w_resp_halfwidth(z, w, acc)
    for roff, z, w, nk in ((0.0, 4.0, 40.0, 120), (0.37, -10.0, -20.0, 96),
                           (0.5, 0.0, 1e-5, 64)):
        np.testing.assert_array_equal(
            tresp.gen_w_response(roff, 2, z, w, nk),
            jresp.gen_w_response(roff, 2, z, w, nk))
    zs = np.arange(-20, 21, 2, dtype=np.float64)
    np.testing.assert_array_equal(
        tresp.gen_w_response_bank(0.0, 2, zs, 60.0, 180),
        jresp.gen_w_response_bank(0.0, 2, zs, 60.0, 180))


@pytest.mark.parametrize("zmax,wmax,numharm", [(20, 60, 4), (100, 300, 4),
                                               (8, 40, 16), (50, 0, 8)])
def test_config_and_banks_byte_equal(zmax, wmax, numharm):
    """fftlen, the w grid, each plane's bank (kmax sized by the w
    halfwidth for every plane, w = 0 included), the subharmonic w and
    the powcuts; wmax 0 keeps one plane and the z-only powcuts."""
    jc = jaccel.AccelConfig(zmax=zmax, wmax=wmax, numharm=numharm, sigma=3.0)
    tc = taccel.AccelConfig(**dataclasses.asdict(jc))
    np.testing.assert_array_equal(tc.ws, jc.ws)
    assert len(tc.ws) == (2 * (wmax // 20) + 1 if wmax else 1)
    for nh, hn in ((1, 1), (2, 1), (4, 3), (16, 5)):
        for u in (7470, 7680, 3000):
            assert taccel.calc_fftlen(nh, hn, zmax, u, wmax) == \
                jaccel.calc_fftlen(nh, hn, zmax, u, wmax)
    for f in (0.5, 0.25, 0.75, 1 / 16, 15 / 16):
        for w in tc.ws:
            assert taccel.calc_required_w(f, w) == \
                jaccel.calc_required_w(f, w)
    if zmax <= 20:
        for w in tc.ws[::max(1, len(tc.ws) // 3)]:
            a, b = taccel.AccelKernels.build(tc, w), \
                jaccel.AccelKernels.build(jc, w)
            assert (a.fftlen, a.halfwidth, a.kmax) == \
                (b.fftlen, b.halfwidth, b.kmax)
            np.testing.assert_array_equal(a.kern_pairs, b.kern_pairs)
    js = jaccel.AccelSearch(jc, T=T, numbins=NBINS)
    ni, pc = taccel._powcuts(tc, js.rlo, js.rhi)
    assert ni == js.numindep and pc == js.powcut
    zonly, _pc = taccel._powcuts(dataclasses.replace(tc, wmax=0), js.rlo,
                                 js.rhi)
    assert ni == [x * len(tc.ws) for x in zonly]


@pytest.mark.parametrize("zmax,wmax,numbins", [(100, 300, 1 << 20),
                                               (8, 40, 1 << 14),
                                               (20, 40, 3000)])
def test_geometry_matches_jax_plane_builder(jax_tpu_path, zmax, wmax,  # noqa: F811
                                            numbins):
    """The port's aligned/uselen/good-window offset/plane width are the
    JAX package's direct-plane builder's for jerk configurations (the
    bench's zmax 100 / wmax 300, a small one, and a spectrum too short
    for the aligned geometry)."""
    cfg = jaccel.AccelConfig(zmax=zmax, wmax=wmax, numharm=4)
    js = jaccel.AccelSearch(cfg, T=1000.0, numbins=numbins)
    ts = taccel.AccelSearch(taccel.AccelConfig(zmax=zmax, wmax=wmax,
                                               numharm=4),
                            T=1000.0, numbins=numbins, device="cpu")
    g = js._plane_geom()
    assert ts.cfg == taccel.AccelConfig(**dataclasses.asdict(js.cfg))
    assert ts.kern.fftlen == js.kern.fftlen
    assert ts.kern.halfwidth == js.kern.halfwidth
    assert ts.aligned == bool(js._plb_hw_eff)
    assert ts.hw_eff == g.hw_use
    assert ts.plane_geom()[2] == g.plane_numr
    if zmax == 100:
        assert (ts.cfg.uselen, ts.kern.fftlen, ts.kern.halfwidth,
                ts.numz_pad, ts.plane_geom()[2]) == (7680, 8192, 91, 104,
                                                     2150400)


# ----------------------------------------------------------------------
# The search
# ----------------------------------------------------------------------


@pytest.mark.parametrize("numharm,banks,nbins", [
    (1, "own", NBINS), (2, "own", NBINS), (4, "own", NBINS),
    (4, "reference", NBINS), (2, "own", 3000)])
def test_search_matches_jax(jax_tpu_path, numharm, banks, nbins):  # noqa: F811
    """AccelSearch.search with wmax 40 (5 planes): the port's own banks,
    or the JAX package's through from_reference_arrays; also on the
    short spectrum's non-aligned geometry."""
    pairs = jerk_spectrum(nbins)
    cfg = jaccel.AccelConfig(zmax=20, wmax=40, numharm=numharm, sigma=3.0)
    js = jaccel.AccelSearch(cfg, T=T, numbins=nbins)
    want = js.search(pairs)
    tcfg = taccel.AccelConfig(**dataclasses.asdict(js.cfg))
    if banks == "own":
        ts = taccel.AccelSearch(taccel.AccelConfig(zmax=20, wmax=40,
                                                   numharm=numharm,
                                                   sigma=3.0),
                                T=T, numbins=nbins, device="cpu")
        assert ts.cfg == tcfg
    else:
        fz = jaccel._harm_fracs_and_zinds(js.cfg, js.cfg.numz)
        wb = {float(w): jaccel.AccelKernels.build(js.cfg, w).kern_pairs
              for w in js.cfg.ws}
        ts = taccel.from_reference_arrays(tcfg, T, nbins, js.kern.kern_pairs,
                                          fz, js.numindep, js.powcut,
                                          w_banks=wb, device="cpu")
        for w, kp in wb.items():
            np.testing.assert_array_equal(ts.bank(w).kern_pairs, kp)
    got = ts.search(torch.from_numpy(pairs))
    assert ts.numindep == js.numindep and ts.powcut == js.powcut
    assert_search_agrees(want, got, js.powcut)
    assert {c.w * c.numharm for c in got} <= set(js.cfg.ws)
    if nbins == NBINS:
        # the 40.3 Hz pulsar (or its second harmonic) tops the list
        top = taccel.remove_duplicates(taccel.eliminate_harmonics(got))[0]
        assert min(abs(top.r / T - 40.3 * h) for h in (1, 2)) < 0.2


def test_jerk_budget_holds_every_bank(monkeypatch):
    """The jerk search keeps every device bank of cfg.ws for its lifetime:
    the plane budget is what the device holds after all of them and the
    work, and a device without room for the banks and one scan's planes
    raises (a fake free-memory reading on a CPU searcher)."""
    s = taccel.AccelSearch(taccel.AccelConfig(zmax=20, wmax=40, numharm=2),
                           T=T, numbins=NBINS, device="cpu")
    bank = s._kbank.numel() * 8
    nbanks = len(s.cfg.ws) - 1           # w = 0 is the searcher's own
    plane, work = 1 << 20, 1 << 16
    free = [0]
    monkeypatch.setattr(s, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (free[0], 1 << 40))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    free[0] = (nbanks * bank + work + 3 * plane) / taccel.MEM_HEADROOM + 1
    assert s._jerk_budget(plane, work, 3) == 3
    free[0] -= bank / taccel.MEM_HEADROOM
    with pytest.raises(MemoryError, match="banks"):
        s._jerk_budget(plane, work, 3)
    # banks already on the device count as room
    s._w_banks_dev[20.0] = torch.zeros(1)
    assert s._jerk_budget(plane, work, 3) == 3


def test_search_many_is_per_spectrum():
    """search_many of a jerk searcher searches one spectrum at a time:
    the same lists as search, and the caches change nothing."""
    pairs = jerk_spectrum()
    ts = taccel.AccelSearch(taccel.AccelConfig(zmax=20, wmax=40, numharm=2,
                                               sigma=3.0),
                            T=T, numbins=NBINS, device="cpu")
    one = ts.search(pairs)
    both = ts.search_many(np.stack([pairs, pairs[::-1].copy()]))
    assert [key(c) for c in both[0]] == [key(c) for c in one]
    assert [c.power for c in both[0]] == [c.power for c in one]
    assert len(ts._w_banks) == 5


@pytest.mark.parametrize("slab", [1 << 20, 1 << 13])
def test_planes_reduction_bit_equal_to_jax_scan(jax_tpu_path, slab):  # noqa: F811
    """reduce_stages_planes_plain + collect_from_reduced on four distinct
    planes gives the JAX scan_all.planes output bit for bit (slab 2^20:
    one numharm-aligned slab; 2^13: the reducer tile's aligned slabs)."""
    import jax.numpy as jnp
    cfg = jaccel.AccelConfig(zmax=20, wmax=40, numharm=4, sigma=2.0)
    js = jaccel.AccelSearch(cfg, T=T, numbins=NBINS)
    g = js._plane_geom()
    slab_j, k, scanner, start_cols = js._slab_plan(g.plane_numr, slab)
    ts = taccel.AccelSearch(taccel.AccelConfig(zmax=20, wmax=40, numharm=4,
                                               sigma=2.0),
                            T=T, numbins=NBINS, device="cpu")
    assert ts.slab_plan(g.plane_numr, slab) == (slab_j, k, start_cols)
    rng = np.random.default_rng(slab % 997)
    planes = [(rng.exponential(size=(ts.numz_pad, g.plane_numr)) * 2.5
               ).astype(np.float32) for _ in range(4)]
    planes[0][:, 1000] = planes[0][:, 1000].max()     # a tie over z
    want = np.asarray(scanner.planes(tuple(jnp.asarray(p) for p in planes),
                                     jnp.asarray(start_cols, jnp.int32)))
    sc = torch.tensor(start_cols, dtype=torch.int32)
    cm, cz = accel_cuda.reduce_stages_planes(
        [torch.from_numpy(p) for p in planes], sc, ts._zinds, slab_j, 3)
    got = taccel.collect_from_reduced(cm, cz, ts._powcut_dev, k).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got[0].view(np.float32) > 0).sum() > 100


def test_planes_wrapper_checks():
    P = torch.zeros((8, 64))
    sc = torch.tensor([0], dtype=torch.int32)
    zi = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="planes for"):
        accel_cuda.reduce_stages_planes([P] * 3, sc, zi, 32, 3)
    with pytest.raises(ValueError, match="share"):
        accel_cuda.reduce_stages_planes([P, P, P, torch.zeros((8, 65))], sc,
                                        zi, 32, 3)
    # one plane repeated: the single-plane reduction's result
    P = torch.rand((8, 64), generator=torch.Generator().manual_seed(0))
    a = accel_cuda.reduce_stages_planes([P] * 4, sc, zi, 32, 3)
    b = accel_cuda.reduce_stages(P, sc, zi, 32, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# Refinement
# ----------------------------------------------------------------------


def test_rzw_functions_match_jax(monkeypatch):
    """rzw_interp and power_at_rzw at points near the injected pulsar and
    elsewhere; max_rzw_arr (the same scipy simplex, launched with both
    w-step signs) on one surface, a cheap quadratic with cross terms put
    into both modules (each evaluation of the real surface costs a
    w-response quadrature), gives the same maximum."""
    pairs = jerk_spectrum()
    amps = (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex128)
    r0 = 40.3 * T + 10.0 / 2 + 30.0 / 6
    for r, z, w in ((r0, 10.0 + 15.0, 30.0), (r0 + 0.3, 24.0, 25.0),
                    (r0, 25.0, 0.0), (1234.7, -3.0, -20.0)):
        a, b = topt.rzw_interp(amps, r, z, w), jopt.rzw_interp(amps, r, z, w)
        np.testing.assert_allclose([a.real, a.imag], [b.real, b.imag],
                                   rtol=1e-12, atol=1e-12 * abs(b))
        np.testing.assert_allclose(topt.power_at_rzw(amps, r, z, w),
                                   jopt.power_at_rzw(amps, r, z, w),
                                   rtol=1e-12)

    def surface(_amps, r, z, w):
        dr, dz, dw = r - r0, z - 25.0, w - 30.0
        return 100.0 - dr * dr - 0.1 * dz * dz - 0.01 * dw * dw \
            - 0.05 * dz * dw
    monkeypatch.setattr(topt, "power_at_rzw", surface)
    monkeypatch.setattr(jopt, "power_at_rzw", surface)
    got = topt.max_rzw_arr(amps, r0 + 0.2, 25.5, 12.0)
    want = jopt.max_rzw_arr(amps, r0 + 0.2, 25.5, 12.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert abs(got[0] - r0) < 1e-2 and abs(got[2] - 30.0) < 1.0


def jerk_seeds():
    """Seeds near injected cubic-phase responses (numharm 1, 2 and 4, w
    off by up to half a plane step) and noise seeds, on a noise
    spectrum."""
    rng = np.random.default_rng(4)
    n = 1 << 15
    u = (np.arange(1 << 16) + 0.5) / (1 << 16)
    X = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.5
    truths = [(4000.3, 30.0, 120.0, 1, 8.0), (9000.7, -20.0, -160.0, 1, -8.0),
              (14000.4, 10.0, 60.0, 2, 4.0), (6000.2, 4.0, 40.0, 4, 2.0)]
    seeds = []
    for r0, z0, w0, nh, werr in truths:
        for h in range(1, nh + 1):
            d = np.arange(-200, 200)
            rint = int(np.floor(h * r0))
            ph = np.exp(2j * np.pi * (
                -(d[:, None] + rint - h * r0) * u
                + 0.5 * h * z0 * (u * u - u)
                + h * w0 * (u ** 3 / 6 - u ** 2 / 4 + u / 12)))
            X[d + rint] += (40 / h) * ph.mean(axis=1)
        seeds.append((r0 + 0.2 / nh, z0 + 0.9 / nh, w0 + werr, nh))
    for r in rng.uniform(500, 30000, 8):
        seeds.append((float(r), float(rng.uniform(-20, 20)),
                      float(rng.choice([-40.0, 0.0, 20.0])),
                      int(rng.choice([1, 2, 4]))))
    return X.astype(np.complex64), seeds, truths


@pytest.mark.parametrize("harmpolish", [True, False])
def test_jerk_polish_matches_jax(harmpolish):
    X, seeds, truths = jerk_seeds()
    numindep = [1 << 15, 1 << 14, 1 << 13]
    jc = [jaccel.AccelCand(power=900.0, sigma=20.0, numharm=nh, r=r, z=z,
                           w=w) for r, z, w, nh in seeds]
    tc = [taccel.AccelCand(power=900.0, sigma=20.0, numharm=nh, r=r, z=z,
                           w=w) for r, z, w, nh in seeds]
    want = jpolish.optimize_jerk_cands(X, jc, 500.0, numindep,
                                       harmpolish=harmpolish)
    got = tpolish.optimize_jerk_cands(X, tc, 500.0, numindep,
                                      harmpolish=harmpolish, device="cpu")
    rep = tpolish.agreement(X, want, got, seeds=tc, jerk=True,
                            harmpolish=harmpolish, numindep=numindep)
    assert rep["unexplained"] == 0, rep["flags"]
    for (r0, z0, w0, _nh, _e), oc in zip(truths, got):
        assert abs(oc.r - r0) < 0.05 and abs(oc.z - z0) < 0.5
        assert abs(oc.w - w0) < 4.0, (oc.w, w0)


def test_jerk_agreement_flags_a_far_move():
    """A w move past the 3-D grid's bound is flagged: the w axis is held,
    not ignored."""
    X, seeds, _truths = jerk_seeds()
    tc = [taccel.AccelCand(power=900.0, sigma=20.0, numharm=nh, r=r, z=z,
                           w=w) for r, z, w, nh in seeds[:2]]
    got = tpolish.optimize_jerk_cands(X, tc, 500.0, [1e4] * 3, device="cpu")
    moved = [dataclasses.replace(got[0], w=got[0].w + 9.0), got[1]]
    rep = tpolish.agreement(X, got, moved, seeds=tc, jerk=True,
                            numindep=[1e4] * 3)
    assert rep["unexplained"] == 1 and rep["flags"][0]["i"] == 0
    assert tpolish.agreement(X, got, got, seeds=tc, jerk=True,
                             numindep=[1e4] * 3)["ok"]


def near_tie_moves():
    """The injected seeds' CPU jerk polish, and per candidate its one-step
    neighbour (one final-stage step on each axis at most) of least
    objective loss, reported as the polish reports a point: its final
    measurement and that power's sigma.  (X, seeds, polished, moved,
    numindep)."""
    X, seeds, _truths = jerk_seeds()
    numindep = [1e4] * 3
    tc = [taccel.AccelCand(power=900.0, sigma=20.0, numharm=nh, r=r, z=z,
                           w=w) for r, z, w, nh in seeds[:4]]
    got = tpolish.optimize_jerk_cands(X, tc, 500.0, numindep, device="cpu")
    amp = torch.as_tensor(np.stack([X.real, X.imag], -1))
    W, npts = tpolish.batch_geometry(tc, True)
    offs = np.array([o for o in np.ndindex(3, 3, 3) if o != (1, 1, 1)]) - 1
    moved = []
    for sd, c in zip(tc, got):
        h = np.array([x[0] for x in tpolish.final_steps([c.numharm])]
                     + [tpolish.final_step_w([c.numharm])[0]])
        pts = np.array([c.r, c.z, c.w]) + offs * h
        obj, fin = tpolish.SeedWindows(amp, sd, W, npts, True).measures(
            np.vstack([[c.r, c.z, c.w], pts]))
        k = int(np.argmax(obj[1:]))
        p = float(fin[1 + k])
        moved.append(dataclasses.replace(
            c, r=pts[k, 0], z=pts[k, 1], w=pts[k, 2], power=p,
            sigma=float(tst.candidate_sigma(p, c.numharm, numindep[
                int(np.log2(c.numharm))]))))
    return X, tc, got, moved, numindep


def test_jerk_agreement_holds_moved_power_and_sigma():
    """A near-tie move of one final step, reported as the polish reports
    it, is within the jerk rule; the same move with a reported power off
    its point's final measurement, or a sigma past the sigma of the
    power's change across the move, is not."""
    X, tc, got, moved, numindep = near_tie_moves()
    rep = tpolish.agreement(X, got, moved, seeds=tc, jerk=True,
                            numindep=numindep)
    assert rep["ok"] and rep["moved_ok"] == [0, 1, 2, 3], rep["flags"]
    assert 0 < rep["worst"]["gap_over_bound"] < 1
    for field, delta in (("power", 1.01), ("sigma", 1.0)):
        bad = list(moved)
        v = getattr(moved[2], field)
        bad[2] = dataclasses.replace(
            moved[2], **{field: v * delta if field == "power" else v + delta})
        rep = tpolish.agreement(X, got, bad, seeds=tc, jerk=True,
                                numindep=numindep)
        assert rep["unexplained"] == 1 and rep["flags"][0]["i"] == 2, field
        assert not rep["flags"][0]["tie_path"]
    with pytest.raises(ValueError, match="numindep"):
        tpolish.agreement(X, got, moved, seeds=tc, jerk=True)


def trace_of(jseeds, jocs, numindep):
    """A RefineTrace that holds only a jerk polish's seeds and results."""
    return tapp.RefineTrace(nraw=0, numindep=numindep, cands=[], ocs=[],
                            jseeds=jseeds, jocs=jocs, final=[], seed_of=[],
                            jerk_taken=[])


def test_jerk_polish_agreement_from_each_sides_seeds():
    """Where the (r, z) polish moved, the two sides' jerk seeds differ:
    each side's jerk polish is then held against the CPU polish of its
    own seeds, and a wrong result on either side is caught."""
    X, tc, got, _moved, numindep = near_tie_moves()
    other = [dataclasses.replace(c, r=c.r + 1e-3, z=c.z - 1e-2) for c in tc]
    oth = tpolish.optimize_jerk_cands(X, other, 500.0, numindep,
                                      device="cpu")
    want, have = trace_of(tc, got, numindep), trace_of(other, oth, numindep)
    rep = accel_agreement.jerk_polish_agreement(X, want, have)
    assert rep["repolished"] and rep["passed"] == {0, 1, 2, 3}
    far = list(oth)
    far[1] = dataclasses.replace(oth[1], w=oth[1].w + 9.0)
    rep = accel_agreement.jerk_polish_agreement(
        X, want, trace_of(other, far, numindep))
    assert rep["passed"] == {0, 2, 3}
    same = accel_agreement.jerk_polish_agreement(X, want, want)
    assert not same["repolished"] and same["passed"] == {0, 1, 2, 3}


# ----------------------------------------------------------------------
# Entry points and the CLI
# ----------------------------------------------------------------------


def test_entry_points_need_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = taccel.AccelConfig(zmax=20, wmax=40, numharm=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        taccel.AccelSearch(cfg, T=T, numbins=NBINS)
    X = jerk_seeds()[0]
    tc = [taccel.AccelCand(power=9.0, sigma=2.0, numharm=1, r=4000.3,
                           z=30.0, w=120.0)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpolish.optimize_jerk_cands(X, tc, 500.0, [1e4])
    f = write_spectrum(str(tmp_path), jerk_spectrum())
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main(["-zmax", "20", "-wmax", "40", f])


def write_spectrum(d, pairs):
    """<d>/x.fft and x.inf."""
    os.makedirs(d, exist_ok=True)
    (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64).tofile(
        os.path.join(d, "x.fft"))
    jwrite_inf(JInfoData(name=os.path.join(d, "x"), N=float(2 * len(pairs)),
                         dt=T / (2 * len(pairs)), telescope="Fake",
                         object="X", dm=10.0), os.path.join(d, "x.inf"))
    return os.path.join(d, "x.fft")


def jax_refine(raw, amps, T, js, wmax, harmpolish=True):
    """The JAX package's refine_and_write up to its files (its batched
    path, whose fallbacks do not fire here), as the port's RefineTrace."""
    cands = jaccel.remove_duplicates(jaccel.eliminate_harmonics(raw))
    ocs = jpolish.optimize_accelcands(amps, cands, T, js.numindep,
                                      harmpolish=harmpolish, with_props=False)
    jseeds = [jaccel.AccelCand(power=o.power, sigma=o.sigma,
                               numharm=o.numharm, r=o.r, z=o.z, w=c.w)
              for c, o in zip(cands, ocs)]
    jocs = jpolish.optimize_jerk_cands(amps, jseeds, T, js.numindep,
                                       harmpolish=harmpolish)
    refined, taken = [], []
    for c, oc, joc in zip(cands, ocs, jocs):
        c = jaccel.AccelCand(power=oc.power, sigma=oc.sigma,
                             numharm=c.numharm, r=oc.r, z=oc.z, w=c.w)
        took = abs(joc.w) <= wmax and joc.power > c.power
        if took:
            c.r, c.z, c.w = joc.r, joc.z, joc.w
            c.power, c.sigma = joc.power, joc.sigma
        else:
            c.w = 0.0
        refined.append(c)
        taken.append(took)
    final = jaccel.remove_duplicates(refined)
    seed_of = [next(k for k, r in enumerate(refined) if r is c)
               for c in final]
    return tapp.RefineTrace(nraw=len(raw), numindep=list(js.numindep),
                            cands=cands, ocs=ocs,
                            jseeds=jseeds, jocs=jocs, final=final,
                            seed_of=seed_of,
                            jerk_taken=[taken[k] for k in seed_of])


@pytest.mark.parametrize("argv", [
    ["-zmax", "20", "-wmax", "40", "-numharm", "4", "-sigma", "2.0"],
    ["-zmax", "20", "-wmax", "60", "-numharm", "2", "-sigma", "3.0",
     "-noharmpolish"],
])
def test_accelsearch_wmax_cli_matches_jax(tmp_path, jax_tpu_path,  # noqa: F811
                                          argv):
    """accelsearch -wmax on one .fft: the JAX CLI (its TPU path, on the
    CPU) and the port's write _ACCEL_20_JERK_<w> tables and .cand files
    that agree by accel_agreement.jerk_file_agreement (lines byte-equal on
    the same grid point, every other line explained)."""
    pairs = jerk_spectrum()
    jf = write_spectrum(str(tmp_path / "j"), pairs)
    tf = write_spectrum(str(tmp_path / "t"), pairs)
    assert japp.main(argv + [jf]) == 0
    args = tapp.build_parser().parse_args(argv + [tf])
    ttrace = tapp.run(args, device="cpu")
    js = jaccel.AccelSearch(jaccel.AccelConfig(
        zmax=20, wmax=args.wmax, numharm=args.numharm, sigma=args.sigma),
        T=T, numbins=NBINS)
    amps = (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)
    jtrace = jax_refine(js.search(pairs), amps, T, js, args.wmax,
                        harmpolish=not args.noharmpolish)
    name = "x_ACCEL_20_JERK_%d" % args.wmax
    rep = accel_agreement.jerk_file_agreement(
        pairs, str(tmp_path / "j" / name), str(tmp_path / "t" / name),
        jtrace, ttrace, harmpolish=not args.noharmpolish)
    assert rep["ok"], (rep["unexplained"], rep["z"]["flags"],
                       [r["flags"] for r in rep["jerk"]["reports"]])
    assert rep["same"] >= 1
    lines = open(str(tmp_path / "t" / name)).read().splitlines()
    assert len(lines[2]) == 142 and "FFT 'w'" in lines[0]
    top = ttrace.final[0]
    means = [f0 * T + z / 2 + w / 6 for f0, z, w, _a in PULSARS]
    assert min(abs(top.r - m) for m in means) < 0.5
    assert any(ttrace.jerk_taken)
