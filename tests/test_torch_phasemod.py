"""The port's phase-modulation (miniFFT) search (search/phasemod.py)
against the JAX package's, on the CPU.

Tolerances.  The miniFFT program rounds in float32 through two FFT
libraries (torch's and XLA's), so each stage's top-k values agree within
rtol 1e-5 and their indices are equal except where two values of one
window and stage lie within that tolerance of each other (a tie, which
either package may order first).  The candidate lists (search_minifft_
batch, search_phasemod) have the same keys (mini_N, full_lo_r, mini_r,
mini_numsum) in the same order, mini_power within rtol 1e-5 and
mini_sigma within 1e-4.  prune_powers (NumPy in both) and the .cand
files are byte-equal.  The device cut of the candidate loop is held to
the JAX package's uncut loop exactly, on the same top-k arrays.
"""

import numpy as np
import pytest
import torch

from presto_tpu.search import phasemod as J
from presto_tpu_torch.ops.stats import candidate_sigma
from presto_tpu_torch.search import phasemod as P

RTOL = 1e-5
SIGMA_ATOL = 1e-4


def binary_spectrum(N=1 << 18, dt=4e-3, f0=50.0, porb=400.0, amp=0.1,
                    seed=0):
    """A phase-modulated pulsar (modulation index 25 rad) in unit noise:
    (complex64 packed spectrum, N, dt).  Every sideband stays under
    prune_powers' 25x cutoff."""
    rng = np.random.default_rng(seed)
    t = np.arange(N) * dt
    x = np.cos(2 * np.pi * f0 * t + 25.0 * np.sin(2 * np.pi * t / porb))
    x = amp * x + rng.normal(size=N)
    return np.fft.rfft(x)[:-1].astype(np.complex64), N, dt


def _key(c):
    return (c.mini_N, c.full_lo_r, c.mini_r, c.mini_numsum)


def assert_same_cands(got, want):
    assert [_key(c) for c in got] == [_key(c) for c in want]
    for g, w in zip(got, want):
        assert abs(g.mini_power - w.mini_power) <= RTOL * w.mini_power
        assert abs(g.mini_sigma - w.mini_sigma) <= SIGMA_ATOL
        assert (g.full_N, g.full_T, g.psr_p, g.orb_p) == \
            (w.full_N, w.full_T, w.psr_p, w.orb_p)


def comb_windows(B, fftlen, seed):
    """B power windows: exponential noise plus a sideband comb whose
    miniFFT peaks between bins (fftlen / 9.3 cycles)."""
    rng = np.random.default_rng(seed)
    n = np.arange(fftlen)
    comb = 1.0 + 0.6 * np.cos(2 * np.pi * n * 9.3 / fftlen)
    return (rng.exponential(size=(B, fftlen)) * comb).astype(np.float32)


TOPK_CASES = {
    # name: (interbin, numbetween, checkaliased, numharm, numsumpow)
    "interp": (False, 2, True, 3, 1),
    "interbin": (True, 2, True, 2, 1),
    "raw_bins": (False, 1, True, 4, 1),
    "noalias": (False, 2, False, 1, 1),
    "stacked": (False, 2, True, 3, 4),
    "interbin_noalias": (True, 2, False, 4, 1),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_minifft_topk_equals_jax(case):
    interbin, nb, alias, numharm, nsum = TOPK_CASES[case]
    fftlen = 256
    wins = comb_windows(12, fftlen, seed=len(case))
    if nsum > 1:
        wins = wins * nsum
    M = (fftlen // 2 if nb == 1 else fftlen) * (2 if alias else 1)
    lobin, hibin = 3 * nb, M - 5
    jv, ji = J._minifft_topk(wins, np.float32(nsum), fftlen, interbin,
                             alias, numharm, lobin, hibin, J.MININCANDS,
                             numbetween=nb)
    tv, ti = P._minifft_topk(torch.from_numpy(wins), nsum, fftlen, interbin,
                             alias, numharm, lobin, hibin, P.MININCANDS,
                             numbetween=nb)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == jv.shape == (12, numharm, P.MININCANDS)
    assert np.all(np.abs(tv - jv) <= RTOL * np.abs(jv))
    differ = ti != ji
    # a differing index is a tie: the port's value at the JAX index
    # equals the JAX value there within the tolerance
    for b, s, r in zip(*np.nonzero(differ)):
        assert abs(tv[b, s, r] - jv[b, s, r]) <= RTOL * abs(jv[b, s, r])
    assert differ.sum() <= 2, differ.sum()
    # every index lies in its stage's valid range
    for s in range(numharm):
        assert ((ti[:, s] >= lobin * (s + 1)) & (ti[:, s] < hibin)).all()


def test_search_minifft_batch_equals_jax():
    """The JAX test's window on the sideband comb: the same candidates,
    and the orbit and spin recovered (tests/test_phasemod.py)."""
    fft, N, dt = binary_spectrum()
    T = N * dt
    r0 = int(50.0 * T)
    fftlen = 4096
    powers = (np.abs(fft) ** 2).astype(np.float32)
    starts = np.array([r0 - fftlen // 2, r0 - fftlen // 4, r0])
    wins = np.stack([powers[s:s + fftlen] for s in starts])
    want = J.search_minifft_batch(wins, T, N, starts, numharm=3)
    got = P.search_minifft_batch(wins, T, N, starts, numharm=3,
                                 device="cpu")
    assert_same_cands(got, want)
    best = max(got, key=lambda c: c.mini_sigma)
    assert best.mini_sigma > 5.0
    assert abs(best.orb_p - 400.0) / 400.0 < 0.1
    assert abs(best.psr_p - 0.02) / 0.02 < 0.05


def test_interbin_forces_numbetween_2_equals_jax():
    """-numbetween 1 -interbin still interbins, in both packages
    (tests/test_advice_r3.py): half-bin candidates, the same list."""
    fftlen = 1024
    n = np.arange(fftlen)
    win = (10.0 + 5.0 * np.cos(2 * np.pi * 100.5 * n / fftlen)
           + np.random.default_rng(2).normal(0, 0.1, fftlen)
           ).astype(np.float32)
    kw = dict(numharm=1, interbin=True, numbetween=1, checkaliased=False)
    want = J.search_minifft_batch(win[None], 1e6, 1e7, np.array([0.0]),
                                  **kw)
    got = P.search_minifft_batch(win[None], 1e6, 1e7, np.array([0.0]),
                                 device="cpu", **kw)
    assert got
    assert_same_cands(got, want)
    rs = np.array([c.mini_r for c in got])
    assert np.any(np.abs(rs * 2 - np.round(rs * 2)) < 1e-9)
    assert np.any(np.abs(rs - np.round(rs)) > 0.25)


def uncut_loop(vals, idx, T, full_N, lo_rs, fftlen, numharm, lobin, hibin,
               numbetween):
    """The JAX package's per-window candidate loop as it is
    (presto_tpu/search/phasemod.py:197-222): every value, scalar
    candidate_sigma."""
    numminifft = fftlen // 2
    dr = 1.0 / numbetween
    mini_N = 2.0 * numminifft
    out = []
    for b in range(vals.shape[0]):
        best = []
        for s in range(vals.shape[1]):
            h = s + 1
            numindep = max((hibin - lobin + 1.0) / h, 1.0)
            for v, jj in zip(vals[b, s], idx[b, s]):
                if not np.isfinite(v):
                    continue
                sig = candidate_sigma(float(v), h, numindep)
                if sig < P.MINRETURNSIG:
                    continue
                mini_r = dr * float(jj) / h
                best.append(P.RawBinCand(
                    full_N=full_N, full_T=T, full_lo_r=float(lo_rs[b]),
                    mini_N=mini_N, mini_r=mini_r, mini_power=float(v),
                    mini_numsum=float(h), mini_sigma=sig,
                    psr_p=T / (float(lo_rs[b]) + numminifft),
                    orb_p=T * mini_r / mini_N))
        best.sort(key=lambda c: -c.mini_sigma)
        out.extend(best[:P.MININCANDS])
    return out


@pytest.mark.parametrize("nb,numharm", [(2, 3), (1, 4)])
def test_cut_loop_equals_uncut_loop(nb, numharm):
    """search_minifft_batch's device cut and vectorized selection give
    the uncut loop's list exactly, on the same top-k arrays: noise
    windows (most values cut, some survive), a comb, a zero window
    (inf/nan, dropped by the isfinite filter in both)."""
    fftlen, B = 512, 400
    wins = comb_windows(B, fftlen, seed=nb)
    wins[7] = 0.0
    T, full_N = 2000.0, 4e6
    lo_rs = np.arange(B) * 128 + 10000
    numminifft = fftlen // 2
    lobin = max(int(np.ceil(2 * numminifft * P.MINORBP / T)), 1) * nb
    hibin = min(int(np.floor(2 * numminifft * (T / 1.2) / T)),
                2 * numminifft - 1) * nb
    vals, idx = P._minifft_topk(torch.from_numpy(wins), 1, fftlen, False,
                                True, numharm, lobin, hibin, P.MININCANDS,
                                numbetween=nb)
    want = uncut_loop(vals.numpy(), idx.numpy(), T, full_N, lo_rs, fftlen,
                      numharm, lobin, hibin, nb)
    got = P.search_minifft_batch(wins, T, full_N, lo_rs, numharm=numharm,
                                 numbetween=nb, device="cpu")
    assert len(want) > 20
    assert got == want
    # the cut drops most values before they cross to the host
    _numindep, cuts = P._stage_cuts(numharm, lobin, hibin)
    kept = int((vals >= torch.from_numpy(cuts)[None, :, None]).sum())
    assert kept < vals.numel() // 4


def test_power_cut_keeps_every_value_that_reaches_minreturnsig():
    """POWCUT_MARGIN: across stages and trial counts, the float32 cut's
    candidate_sigma stays under MINRETURNSIG (candidate_sigma rises with
    the power, so every value that reaches it passes the cut), while a
    power 1e-4 above the cut reaches it: the cut drops nearly all it can
    (candidate_sigma's asymptotic branch, above 15 per summed power,
    reaches MINRETURNSIG up to 2.1e-5 above power_for_sigma's exact
    inverse)."""
    for numharm in (1, 4, 8):
        for lobin, hibin in ((2, 40), (12, 1000), (50, 131071),
                             (100, 262143)):
            numindep, cuts = P._stage_cuts(numharm, lobin, hibin)
            for s in range(numharm):
                c = float(cuts[s])
                assert candidate_sigma(c, s + 1, numindep[s]) \
                    < P.MINRETURNSIG
                assert candidate_sigma(c * (1 + 1e-4), s + 1,
                                       numindep[s]) >= P.MINRETURNSIG


PHASEMOD_CASES = {
    "default": dict(ncand=20, minfft=256, maxfft=2048, harmsum=3,
                    rlo=48000, rhi=57000),
    "interbin": dict(ncand=15, minfft=512, maxfft=1024, harmsum=2,
                     interbin=True, rlo=49000, rhi=56000),
    "raw_bins": dict(ncand=15, minfft=512, maxfft=1024, harmsum=4,
                     numbetween=1, rlo=49000, rhi=56000),
    "noalias": dict(ncand=10, minfft=1024, maxfft=2048, harmsum=3,
                    noalias=True, rlo=49000, rhi=56000),
    "from_bin_0": dict(ncand=10, minfft=128, maxfft=512, harmsum=3,
                       rlo=0, rhi=6000),
}


@pytest.mark.parametrize("case", sorted(PHASEMOD_CASES))
def test_search_phasemod_equals_jax(case):
    fft, N, dt = binary_spectrum()
    kw = PHASEMOD_CASES[case]
    want = J.search_phasemod(fft, N, dt, J.PhaseModConfig(**kw))
    got = P.search_phasemod(fft, N, dt, P.PhaseModConfig(**kw),
                            device="cpu")
    assert got
    assert_same_cands(got, want)
    if case != "from_bin_0":
        assert abs(got[0].orb_p - 400.0) / 400.0 < 0.1
        assert abs(got[0].psr_p - 0.02) / 0.02 < 0.05


def test_search_phasemod_pairs_and_stack_equal_jax():
    """The [n, 2] pairs input (the .fft loader's) and stacked powers
    (stack = 2: two spectra's powers summed) give the JAX lists."""
    fft, N, dt = binary_spectrum()
    kw = dict(ncand=10, minfft=512, maxfft=1024, harmsum=3, rlo=49000,
              rhi=55000)
    pairs = np.stack([fft.real, fft.imag], -1).astype(np.float32)
    want = J.search_phasemod(pairs, N, dt, J.PhaseModConfig(**kw))
    got = P.search_phasemod(pairs, N, dt, P.PhaseModConfig(**kw),
                            device="cpu")
    assert_same_cands(got, want)
    fft2, _, _ = binary_spectrum(seed=5)
    stacked = ((np.abs(fft) ** 2) + (np.abs(fft2) ** 2)).astype(np.float32)
    want = J.search_phasemod(stacked, N, dt,
                             J.PhaseModConfig(stack=2, **kw))
    got = P.search_phasemod(stacked, N, dt,
                            P.PhaseModConfig(stack=2, **kw), device="cpu")
    assert got
    assert_same_cands(got, want)
    with pytest.raises(ValueError):
        P.search_phasemod(pairs, N, dt, P.PhaseModConfig(stack=2),
                          device="cpu")


def test_noise_only_equals_jax_and_finds_nothing_significant():
    rng = np.random.default_rng(3)
    N, dt = 1 << 17, 1e-3
    fft = np.fft.rfft(rng.normal(size=N))[:-1].astype(np.complex64)
    kw = dict(ncand=20, minfft=512, maxfft=2048, harmsum=2, rlo=20000,
              rhi=30000)
    want = J.search_phasemod(fft, N, dt, J.PhaseModConfig(**kw))
    got = P.search_phasemod(fft, N, dt, P.PhaseModConfig(**kw),
                            device="cpu")
    assert_same_cands(got, want)
    assert all(c.mini_sigma < 5.0 for c in got)


def _random_cands(rng, n, sigmas):
    return [P.RawBinCand(mini_N=float(rng.choice([512, 1024])),
                         mini_r=float(rng.integers(0, 40)) * 0.25,
                         mini_sigma=float(s), full_lo_r=float(i))
            for i, s in enumerate(sigmas[:n])]


@pytest.mark.parametrize("maxcands", [1, 5, 40])
def test_merge_equals_jax(maxcands):
    """The early-stopping merge gives the JAX merge's list: near
    duplicates (same mini_N, |dr| < 0.6), tied sigmas, an old master
    that already holds entries, several rounds."""
    rng = np.random.default_rng(maxcands)
    master_j, master_t = [], []
    for rnd in range(6):
        sig = np.round(rng.uniform(1.5, 9.0, 300), 1)   # many ties
        new = _random_cands(rng, 300, sig)
        master_j = J.merge_rawbin_cands(
            master_j, [J.RawBinCand(**c.__dict__) for c in new], maxcands)
        master_t = P.merge_rawbin_cands(master_t, new, maxcands)
        assert [c.__dict__ for c in master_t] == \
            [c.__dict__ for c in master_j]
    assert len(master_t) == maxcands
    # the JAX package's own dedup case
    a = P.RawBinCand(mini_N=1024, mini_r=100.0, mini_sigma=8.0)
    b = P.RawBinCand(mini_N=1024, mini_r=100.3, mini_sigma=5.0)
    c = P.RawBinCand(mini_N=1024, mini_r=300.0, mini_sigma=6.0)
    master = P.merge_rawbin_cands([], [a, b, c], maxcands=10)
    assert [m.mini_sigma for m in master] == [8.0, 6.0]
    assert not P.not_already_there_rawbin(b, master)


@pytest.mark.parametrize("numsumpow,even", [(1, True), (1, False), (4, True)])
def test_prune_powers_bytes_equal(numsumpow, even):
    rng = np.random.default_rng(numsumpow)
    p = rng.exponential(size=1000 if even else 1001).astype(np.float32)
    p[[5, 77, 500]] = [1e6, 300.0, 40.0]
    got = P.prune_powers(p, numsumpow)
    want = J.prune_powers(p, numsumpow)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got[5] == np.float32(5.0 * np.median(p))


def test_cand_files_cross_read(tmp_path):
    """A .cand written by the JAX package is read by the port and the
    other way round, byte for byte; the report text is the same."""
    fft, N, dt = binary_spectrum()
    kw = dict(ncand=8, minfft=512, maxfft=1024, harmsum=3, rlo=49000,
              rhi=55000)
    cands = P.search_phasemod(fft, N, dt, P.PhaseModConfig(**kw),
                              device="cpu")
    pj, pt = str(tmp_path / "j_bin3.cand"), str(tmp_path / "t_bin3.cand")
    P.write_bincands(pt, cands)
    back_j = J.read_bincands(pt)
    J.write_bincands(pj, back_j)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert P.read_bincands(pj) == cands
    assert P.rawbin_report(cands) == J.rawbin_report(back_j)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    fft, N, dt = binary_spectrum(N=1 << 12)
    for call in (lambda: P.search_phasemod(fft, N, dt),
                 lambda: P.search_minifft_batch(
                     np.ones((1, 64), np.float32), 1e3, 1e4,
                     np.array([0]))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
