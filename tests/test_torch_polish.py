"""The port's batched polish against the JAX package's, on the CPU.

Both sides run the same float32 arithmetic; they differ in the
transcendental functions' last bits and in reduction order, so a
final-stage argmax can pick the neighbouring grid point on a near-tie.
Tolerances, per candidate: r within 2e-3 bins and z within 1e-2 (a
final-stage grid step is at most 0.12/81 in r and 0.5/81 in z).  Where
both sides picked the same grid point: power within rtol 1e-4 and sigma
within 1e-3; where a near-tie moved one of them by a final-stage step
(which moves the power by up to ~3e-4 on a sloped peak): power within
rtol 1e-3 and sigma within 1e-2.  Each harmonic's power agrees to the
same share of the candidate's summed power.
"""

import numpy as np
import pytest
import torch

from presto_tpu.search import accel as jaccel
from presto_tpu.search import polish as jpolish
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import polish as tpolish

T_OBS = 500.0
N = 1 << 16
SIGNALS = [(3000.3, 12.0, 0.10), (9000.7, -30.4, 0.08), (20000.1, 0.9, 0.07)]


@pytest.fixture(scope="module")
def corpus():
    """A spectrum with three accelerated pulsars (three harmonics each)
    and a candidate list mixing numharm 1-8: the search's own candidates
    plus seeds near each pulsar at every numharm and noise seeds."""
    rng = np.random.default_rng(7)
    t = np.arange(N) / N
    x = rng.normal(size=N).astype(np.float64)
    for (r0, z0, amp) in SIGNALS:
        ph = 2 * np.pi * ((r0 - z0 / 2) * t + 0.5 * z0 * t * t)
        x += amp * (np.cos(ph) + 0.4 * np.cos(2 * ph)
                    + 0.2 * np.cos(3 * ph + 0.5))
    X = np.fft.rfft(x)[:N // 2]
    amps = X.astype(np.complex64)
    s = jaccel.AccelSearch(jaccel.AccelConfig(zmax=50, numharm=8, sigma=2.5),
                           T=T_OBS, numbins=N // 2)
    pairs = np.stack([X.real, X.imag], -1).astype(np.float32)
    found = jaccel.remove_duplicates(jaccel.eliminate_harmonics(
        s.search(pairs)))
    seeds = [(c.r, c.z, c.numharm) for c in found]
    for (r0, z0, _a) in SIGNALS:
        for nh in (1, 2, 4, 8):
            seeds.append((r0 + 0.2 / nh, z0 + 0.7 / nh, nh))
    for r in rng.uniform(100, 30000, 6):
        seeds.append((float(r), float(rng.uniform(-40, 40)),
                      int(rng.choice([1, 2, 4, 8]))))
    cands = [jaccel.AccelCand(power=10.0, sigma=5.0, numharm=nh, r=r, z=z)
             for (r, z, nh) in seeds]
    return amps, cands, s.numindep


def as_torch(cands):
    return [taccel.AccelCand(power=c.power, sigma=c.sigma,
                             numharm=c.numharm, r=c.r, z=c.z)
            for c in cands]


def assert_polish_agrees(want, got):
    """The module docstring's tolerances."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.numharm == b.numharm
        assert abs(a.r - b.r) <= 2e-3, (a, b)
        assert abs(a.z - b.z) <= 1e-2, (a, b)
        same = abs(a.r - b.r) < 1e-9 and abs(a.z - b.z) < 1e-9
        rtol = 1e-4 if same else 1e-3
        assert abs(a.sigma - b.sigma) <= 10 * rtol, (a, b)
        np.testing.assert_allclose(b.power, a.power, rtol=rtol)
        if hasattr(a, "hpows"):          # OptimizedCand, not AccelCand
            np.testing.assert_allclose(b.hpows, a.hpows, rtol=rtol,
                                       atol=rtol * a.power)


@pytest.mark.parametrize("harmpolish,spectrum", [
    (True, "complex"), (False, "complex"), (True, "pairs tensor")])
def test_optimize_accelcands_matches_jax(corpus, harmpolish, spectrum):
    amps, cands, numindep = corpus
    want = jpolish.optimize_accelcands(amps, cands, T_OBS, numindep,
                                       harmpolish=harmpolish)
    arg = amps if spectrum == "complex" else torch.from_numpy(
        np.stack([amps.real, amps.imag], -1).astype(np.float32))
    got = tpolish.optimize_accelcands(arg, as_torch(cands), T_OBS, numindep,
                                      harmpolish=harmpolish, device="cpu")
    assert_polish_agrees(want, got)
    # the per-harmonic properties of the candidates on the same point
    for a, b in zip(want, got):
        if abs(a.r - b.r) < 1e-9 and abs(a.z - b.z) < 1e-9:
            for pa, pb in zip(a.props, b.props):
                np.testing.assert_allclose(
                    [pb.r, pb.z, pb.pow, pb.locpow, pb.rawpow],
                    [pa.r, pa.z, pa.pow, pa.locpow, pa.rawpow], rtol=1e-4)
                assert abs(pa.phs - pb.phs) <= 1e-3


def test_polish_finds_the_injected_pulsars(corpus):
    amps, cands, numindep = corpus
    got = tpolish.optimize_accelcands(amps, as_torch(cands), T_OBS,
                                      numindep, device="cpu")
    for (r0, z0, _a) in SIGNALS:
        best = max((o for o in got if abs(o.r - r0) < 1.0),
                   key=lambda o: o.sigma)
        assert abs(best.r - r0) < 0.1 and abs(best.z - z0) < 1.0


def test_empty_list(corpus):
    amps, _cands, numindep = corpus
    assert tpolish.optimize_accelcands(amps, [], T_OBS, numindep,
                                       device="cpu") == []
    assert jpolish.optimize_accelcands(amps, [], T_OBS, numindep) == []
    assert tpolish.optimize_accelcands_batched(
        np.zeros((2, 64, 2), np.float32), [[], []], T_OBS, numindep,
        device="cpu") == [[], []]


def test_large_r_precision():
    """Survey-scale absolute frequency: at r ~ 2^23 float32 spacing is a
    whole bin, so the polish must rebuild r on the host in float64 (the
    device sees offsets only).  The port recovers the injected (r, z)
    and agrees with the JAX package."""
    rng = np.random.default_rng(11)
    n = 1 << 14
    r0, z0 = 2.0 ** 23 + 1000.3, 12.0
    rint0 = int(np.floor(r0))
    X = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.5
    lob = rint0 - n // 2
    d = np.arange(-150, 150)
    u = (np.arange(4096) + 0.5) / 4096
    ph = np.exp(2j * np.pi * (-(d[:, None] + rint0 - r0) * u
                              + 0.5 * z0 * (u * u - u)))
    X[(d + rint0 - lob)] += 30 * ph.mean(axis=1)
    big = np.zeros(rint0 + n // 2, np.complex64)
    big[lob:lob + n] = X.astype(np.complex64)
    cand = jaccel.AccelCand(power=900.0, sigma=20.0, numharm=1,
                            r=r0 + 0.2, z=z0 + 0.7)
    want = jpolish.optimize_accelcands(big, [cand], T_OBS, [n])
    got = tpolish.optimize_accelcands(big, as_torch([cand]), T_OBS, [n],
                                      device="cpu")
    assert abs(got[0].r - r0) < 0.01 and abs(got[0].z - z0) < 0.2
    assert_polish_agrees(want, got)


@pytest.mark.parametrize("zmax_pairs", [0.0, 0.7, 7.3, 50.0, 101.0, 160.5,
                                        403.0, 1602.5, 3000.0])
def test_geometry_matches_jax(zmax_pairs):
    assert tpolish._geometry(zmax_pairs) == jpolish._geometry(zmax_pairs)


@pytest.mark.parametrize("stack", [False, True])
def test_windows_to_wmat_matches_jax(stack):
    """Window gather (zero fill outside the spectrum, at both ends) and
    the transform to w(u): within rtol 1e-5 of the largest value."""
    rng = np.random.default_rng(3)
    n, W, npts = 5000, 256, 512
    spec = rng.normal(size=(3, n, 2)).astype(np.float32)
    rints = np.array([0, 40, 2500, 4990, 4999, 100, 3000], np.int32)
    spec_of = np.array([0, 1, 2, 0, 1, 2, 1], np.int32)
    if stack:
        want = np.asarray(jpolish._windows_to_wmat(
            spec, rints, W, npts, spec_of=spec_of))
        got = tpolish._windows_to_wmat(
            torch.from_numpy(spec), torch.from_numpy(rints), W, npts,
            spec_of=torch.from_numpy(spec_of)).numpy()
    else:
        want = np.asarray(jpolish._windows_to_wmat(spec[1], rints, W, npts))
        got = tpolish._windows_to_wmat(torch.from_numpy(spec[1]),
                                       torch.from_numpy(rints), W,
                                       npts).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_padding_free_equals_padded(corpus):
    """The JAX package pads pairs and candidates to powers of two (pad
    pairs: harmonic 1, frac 0.5, weight 0, assigned to the last pad
    candidate).  The port drops the padding; the descent and the final
    measures of the real candidates come out bit-equal either way."""
    amps, cands, numindep = corpus
    pairs = torch.from_numpy(
        np.stack([amps.real, amps.imag], -1).astype(np.float32))
    nc = len(cands)
    nh = np.asarray([c.numharm for c in cands], np.int32)
    seed_r = np.asarray([c.r for c in cands])
    seed_z = np.asarray([c.z for c in cands]).astype(np.float32)
    cand_of = np.repeat(np.arange(nc, dtype=np.int32), nh)
    hh = np.concatenate([np.arange(1, k + 1) for k in nh]).astype(np.float32)
    rint = np.floor(seed_r[cand_of] * hh).astype(np.int32)
    frac0 = (seed_r[cand_of] * hh.astype(np.float64) - rint).astype(
        np.float32)
    P = cand_of.size
    W, npts = tpolish._geometry(float(np.abs(seed_z[cand_of] * hh).max()
                                      + tpolish.STEP0_Z * 3 + 1.0))

    def run(pad_p, pad_c):
        def padp(a, fill):
            return np.concatenate([a, np.full(pad_p, fill, a.dtype)])

        def padc(a, fill):
            return np.concatenate([a, np.full(pad_c, fill, a.dtype)])
        ncp = nc + pad_c
        cof = np.where(padp(cand_of, nc) >= ncp, ncp - 1, padp(cand_of, nc))
        hp = padp(hh, 1.0)
        t = torch.from_numpy
        wmat = tpolish._windows_to_wmat(pairs, t(padp(rint, 0)), W, npts)
        _, lp0 = tpolish._final_measures(wmat, t(padp(frac0, 0.5)),
                                         t(padc(seed_z, 0.0)[cof] * hp))
        dr, dz = tpolish._refine_stages(
            wmat, cof, t(hp), t(padp(frac0, 0.5)), t(padc(seed_z, 0.0)),
            1.0 / lp0, t(padp(np.ones(P, np.float32), 0.0)),
            t(padc((tpolish.STEP0_R / nh).astype(np.float32),
                   tpolish.STEP0_R)),
            t(padc((tpolish.STEP0_Z / nh).astype(np.float32),
                   tpolish.STEP0_Z)), ncp)
        return wmat[:P], lp0[:P], dr[:nc], dz[:nc]

    ref = run(0, 0)
    for got in (run(64 - P % 64, 32 - nc % 32), run(7, 3)):
        for a, b in zip(ref, got):
            assert torch.equal(a, b)


def test_pairs_must_be_grouped_by_candidate():
    with pytest.raises(ValueError, match="grouped"):
        tpolish._harmonic_slots(np.array([0, 1, 0]), 2)
    slot, width = tpolish._harmonic_slots(np.array([0, 0, 0, 1, 3, 3]), 4)
    assert slot.tolist() == [0, 1, 2, 0, 0, 1] and width == 3


def test_batched_matches_per_trial_and_jax():
    """optimize_accelcands_batched (one pipeline over three trials)
    equals per-trial calls, and agrees with the JAX package's."""
    rng = np.random.default_rng(17)
    numbins, T, ns = 1 << 14, 150.0, 3
    batch = rng.normal(size=(ns, numbins, 2)).astype(np.float32)
    for d in range(ns):
        batch[d, 2500 + 401 * d] = (70.0, 0.0)
        batch[d, 9000 + 100 * d] = (55.0, 0.0)
    s = jaccel.AccelSearch(jaccel.AccelConfig(zmax=8, numharm=2, sigma=3.0),
                           T=T, numbins=numbins)
    lists = s.search_many(batch)
    assert all(lists), "every trial must yield candidates"
    tlists = [as_torch(cl) for cl in lists]
    dev = torch.from_numpy(batch)
    per = [tpolish.optimize_accelcands(dev[d], tlists[d], T, s.numindep,
                                       with_props=False)
           for d in range(ns)]
    bat = tpolish.optimize_accelcands_batched(dev, tlists, T, s.numindep)
    want = jpolish.optimize_accelcands_batched(batch, lists, T, s.numindep)
    assert [len(x) for x in bat] == [len(x) for x in per]
    for a, b, w in zip(per, bat, want):
        for oa, ob in zip(a, b):
            assert (oa.r, oa.z, oa.sigma) == (ob.r, ob.z, ob.sigma)
        assert_polish_agrees(w, b)


def flat_top_spectrum(delta=0.26, r0=3000.5, n=1 << 14):
    """Two equal tones at r0 -+ delta bins (no noise): the polish's power
    surface is mirror-symmetric about r0 and, at this separation, flat
    to a few 1e-6 over three final-stage steps on either side."""
    t = np.arange(2 * n) / (2 * n)
    x = (np.cos(2 * np.pi * (r0 - delta) * t)
         + np.cos(2 * np.pi * (r0 + delta) * t))
    return np.fft.rfft(x)[:n].astype(np.complex64), r0


def _cand(r, z, power, sigma=5.0, numharm=1):
    return taccel.AccelCand(power=float(power), sigma=sigma, numharm=numharm,
                            r=float(r), z=float(z))


def test_agreement_accepts_a_tie_on_a_flat_top():
    """Two grid points mirrored about the flat top's centre tie (one
    evaluator gives them the same power); the agreement rule accepts the
    move, which is two and four final-stage r steps (past the old rule's
    2e-3 bins), and it holds the port's polish against the JAX package's
    on the same spectrum."""
    amps, r0 = flat_top_spectrum()
    hr, _hz = tpolish.final_steps(1)
    for k in (1, 2):
        ra, rb = r0 + k * hr, r0 - k * hr
        pa, pb = tpolish.joint_powers(amps, [ra, rb], [0.0, 0.0], [1, 1])
        assert abs(pa - pb) <= 1e-5 * pa
        rep = tpolish.agreement(amps, [_cand(ra, 0.0, pa)],
                                [_cand(rb, 0.0, pb)])
        assert rep["ok"] and rep["moved"] == 1, rep
        assert abs(rep["worst"]["steps"] - 2 * k) < 1e-6
    seeds = [jaccel.AccelCand(power=10.0, sigma=5.0, numharm=1, r=r0 + dr,
                              z=z) for dr, z in ((0.07, 0.4), (-0.05, -0.3))]
    numindep = [1e4]
    want = jpolish.optimize_accelcands(amps, seeds, 1.0, numindep)
    got = tpolish.optimize_accelcands(amps, as_torch(seeds), 1.0, numindep,
                                      device="cpu")
    rep = tpolish.agreement(amps, want, got)
    assert rep["ok"], rep


def test_agreement_flags_real_disagreements():
    """A move past AGREE_STEPS final-stage steps, a reported power off by
    1e-3 of itself and a numharm mismatch are each flagged."""
    amps, r0 = flat_top_spectrum()
    hr, _hz = tpolish.final_steps(1)
    far = r0 - (tpolish.AGREE_STEPS + 1) * hr
    pa, pf = tpolish.joint_powers(amps, [r0, far], [0.0, 0.0], [1, 1])
    a = _cand(r0, 0.0, pa)
    for b, why in ((_cand(far, 0.0, pf), "moved"),
                   (_cand(r0 - hr, 0.0, pa * (1 + 1e-3)), "moved"),
                   (_cand(r0, 0.0, pa, numharm=2), "numharm")):
        rep = tpolish.agreement(amps, [a], [b])
        assert not rep["ok"] and rep["flags"][0]["why"] == why, rep


def test_descent_replay_reproduces_the_polish(corpus):
    """The replay (one candidate at a time) follows optimize_accelcands'
    path (a batch): the polished point is reachable, and its final
    measurement is the polished power within float32 rounding (the CPU
    reduces and multiplies a batch in another order than one
    candidate)."""
    amps, cands, numindep = corpus
    seeds = as_torch(cands[:12])
    got = tpolish.optimize_accelcands(amps, seeds, T_OBS, numindep,
                                      device="cpu")
    reps = tpolish.descent_replay(amps, seeds, tpolish.TIE_RTOL,
                                  points=[[(o.r, o.z)] for o in got])
    for o, (reach, pw) in zip(got, reps):
        assert tpolish._in_reach(reach, o)
        assert pw[0] == pytest.approx(o.power, rel=1e-6)


def test_agreement_on_the_descent_tie_paths():
    """On the flat top the descent's stage ties within TIE_RTOL reach
    points several final-stage steps apart; a result at the farthest of
    them (at its measured power) ties with the polish's own within the
    curvature bound.  A point the descent cannot reach, past
    AGREE_STEPS, is flagged, and the replay leaves it unexplained.  (A
    tie path past the bound, which the replay explains, is held in
    test_accelsearch_cli_short_fft.)"""
    amps, r0 = flat_top_spectrum()
    seed = taccel.AccelCand(10.0, 5.0, 1, r0 - 0.05, -0.3)
    a, = tpolish.optimize_accelcands(amps, [seed], 1.0, [1e4], device="cpu")
    (reach, _), = tpolish.descent_replay(amps, [seed], tpolish.TIE_RTOL)
    assert len(reach) > 1 and tpolish._in_reach(reach, a)
    hr, hz = tpolish.final_steps(1)
    far = reach[np.argmax(np.abs(reach[:, 1] - a.z) / hz
                          + np.abs(reach[:, 0] - a.r) / hr)]
    assert max(abs(far[0] - a.r) / hr, abs(far[1] - a.z) / hz) > 2.9
    (_, pw), = tpolish.descent_replay(amps, [seed], 0.0,
                                      points=[[tuple(far)]])
    b = _cand(far[0], far[1], pw[0], sigma=a.sigma)
    rep = tpolish.agreement(amps, [a], [b], seeds=[seed])
    assert rep["ok"] and rep["moved"] == 1, rep
    off = _cand(a.r, a.z + 7.5 * hz, a.power, sigma=a.sigma)
    rep = tpolish.agreement(amps, [a], [off], seeds=[seed])
    assert not rep["ok"] and rep["unexplained"] == 1, rep
    assert rep["flags"][0]["b_reached"] is False, rep
