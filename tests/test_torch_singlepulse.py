"""The port's single-pulse search against the JAX package's.

The same seeded numpy inputs go through presto_tpu.search.singlepulse
(on the CPU) and presto_tpu_torch.search.singlepulse (device="cpu").
The host helpers (kernels, bad-block flags, pruning, the .singlepulse
writer) must be equal.  The device pieces round differently in the last
float32 bits (the two packages' FFTs and reductions), so:

  * ``_detrend_blocks``: residuals within 1e-6 of the largest residual
    (rtol 1e-6 on the scale of the block; the slope's matmul and the
    float32 ``tvar`` sum round in another order), stds within rtol 2e-6;
  * ``_convolve_topk``: values within 1e-5 absolute, counts equal, and
    idx identical wherever a row's sorted values are distinct by more
    than that tolerance;
  * the searches: event lists held by ``singlepulse.agreement`` (matched
    lines' sigmas within 2e-4, every other line explained as a threshold
    or prune near-tie); stds within rtol 2e-6, bad blocks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from presto_tpu.search import singlepulse as J
from presto_tpu_torch.search import singlepulse as T

DT = 1e-3


def _jax_search(**kw):
    return J.SinglePulseSearch(**kw)


def _port_search(**kw):
    return T.SinglePulseSearch(device="cpu", **kw)


def assert_agree(want, got, threshold):
    r = T.agreement(want, got, threshold)
    assert r["ok"], r
    assert r["matched"] == len(want) - sum(
        1 for o in r["one_sided"] if o["side"] == "want")
    return r


# ---- host helpers: equal ----------------------------------------------

@pytest.mark.parametrize("fftlen", [512, 8192])
def test_boxcar_kernels_equal(fftlen):
    widths = [1] + list(J.DEFAULT_DOWNFACTS)
    np.testing.assert_array_equal(T.boxcar_kernels(widths, fftlen),
                                  J.boxcar_kernels(widths, fftlen))


def _cands(mod, rng, n, span=400):
    bins = np.sort(rng.integers(0, span, n))
    return [mod.SPCandidate(bin=int(b), sigma=float(s), time=float(b) * DT,
                            downfact=int(d), dm=12.5)
            for b, s, d in zip(bins, rng.uniform(5, 9, n),
                               rng.choice([1, 2, 3, 4, 6, 9, 14, 20, 30],
                                          n))]


def _key(cs):
    return [(c.bin, c.sigma, c.downfact) for c in cs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_functions_equal(seed):
    rng = np.random.default_rng(seed)
    bins = sorted(rng.integers(0, 300, 80).tolist())
    vals = rng.uniform(5, 9, 80).tolist()
    for df in (1, 2, 9, 30):
        assert T.prune_related1(bins, vals, df) == \
            J.prune_related1(bins, vals, df)
    widths = [1, 2, 3, 4, 6, 9, 14, 20, 30]
    jc = _cands(J, np.random.default_rng(seed), 120)
    tc = _cands(T, np.random.default_rng(seed), 120)
    assert _key(T.prune_related2(tc, widths)) == \
        _key(J.prune_related2(jc, widths))
    off = [(50, 80), (200, 260)]
    assert _key(T.prune_border_cases(tc, off)) == \
        _key(J.prune_border_cases(jc, off))


@pytest.mark.parametrize("case", ["normal", "dropout", "burst", "few"])
def test_flag_bad_blocks_equal(case):
    rng = np.random.default_rng(5)
    stds = np.abs(rng.normal(1.0, 0.01, size=64)).astype(np.float32)
    if case == "dropout":
        stds[10] = 0.01
    elif case == "burst":
        stds[[3, 40]] = (5.0, 7.0)
    elif case == "few":
        stds = stds[:3]
    bt, mt, st = T.flag_bad_blocks(stds)
    bj, mj, sj = J.flag_bad_blocks(stds)
    np.testing.assert_array_equal(bt, bj)
    assert (mt, st) == (mj, sj)


# ---- device pieces: within the float32 tolerances ----------------------

@pytest.mark.parametrize("fast,n", [(False, 1000), (True, 1000),
                                    (True, 999), (False, 2000)])
def test_detrend_blocks_matches_jax(fast, n):
    """Linear and median (fast) detrend; n = 1000 is the even-count
    median (the mean of the two middle values, as jnp.median)."""
    rng = np.random.default_rng(3)
    t = np.arange(n, dtype=np.float32)
    blocks = (rng.normal(size=(24, n)) * rng.uniform(0.5, 3, (24, 1))
              + 0.004 * t + 7.0).astype(np.float32)
    rj, sj = J._detrend_blocks(jnp.asarray(blocks), n, fast)
    rt, st = T._detrend_blocks(torch.as_tensor(blocks), n, fast)
    rj = np.asarray(rj)
    if fast:      # the median is an order statistic: exact
        np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-6,
                               atol=1e-6 * np.abs(rj).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-6)


def test_convolve_topk_matches_jax():
    rng = np.random.default_rng(2)
    fftlen, chunklen = 8192, 8000
    overlap = (fftlen - chunklen) // 2
    x = rng.normal(size=(6, fftlen)).astype(np.float32)
    x[1, 3000:3009] += 4.0
    x[4, 100:5000] += 3.0            # more hits than k in some rows
    widths = [1, 2, 3, 4, 6, 9, 14, 20, 30]
    kf = np.fft.rfft(J.boxcar_kernels(widths, fftlen))
    kp = np.stack([kf.real, kf.imag], -1).astype(np.float32)
    k = 64
    vj, ij, cj = (np.asarray(a) for a in J._convolve_topk(
        x, kp, np.float32(4.0), fftlen, overlap, k))
    vt, it, ct = (a.numpy() for a in T._convolve_topk(
        torch.as_tensor(x), torch.as_tensor(kf.astype(np.complex64)), 4.0,
        fftlen, overlap, k))
    np.testing.assert_array_equal(ct, cj)
    assert (cj > k).any()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    gap = np.abs(np.diff(vj, axis=-1))
    distinct = np.ones_like(vj, bool)
    distinct[..., 1:] &= gap > 1e-5
    distinct[..., :-1] &= gap > 1e-5
    assert distinct.mean() > 0.5
    np.testing.assert_array_equal(it[distinct], ij[distinct])


def test_topk_ties_take_the_lowest_index():
    """Rows with exact ties at the capacity (more hits than k): the port
    keeps jax.lax.top_k's lowest-index rule; a row within its capacity
    keeps the same above-threshold set."""
    rng = np.random.default_rng(4)
    good = np.round(rng.uniform(0, 4, (5, 3, 200))).astype(np.float32)
    good[:, 1] *= rng.uniform(size=(5, 200)) < 0.2      # within capacity
    thr, k = 1.5, 40
    counts = torch.as_tensor((good > thr).sum(-1))
    vt, it = T._topk_rows(torch.as_tensor(good), k, counts)
    vj, ij = jax.lax.top_k(jnp.asarray(good), k)
    over = counts.numpy() > k
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy()[over], np.asarray(ij)[over])
    for r in zip(*np.nonzero(~over)):
        n = int(counts[r])
        assert set(it.numpy()[r][:n]) == set(np.asarray(ij)[r][:n])


# ---- the searches --------------------------------------------------------

def _case(name):
    """(series list, dms, offregions per series, search kwargs)."""
    rng = np.random.default_rng(12)
    if name == "pulses":
        n = 1 << 15
        series = []
        for i in range(4):
            x = rng.normal(size=n).astype(np.float32)
            x[2000 + 700 * i:2009 + 700 * i] += 4.0
            x[20000 + 11 * i] += 9.0
            x += np.linspace(0, 3, n).astype(np.float32)
            series.append(x)
        return series, [10.0 * i for i in range(4)], None, {}
    if name == "edges":
        # a pulse straddling the F*chunklen boundary (N = 65536 -> F =
        # 8: the last chunk's right overlap reads zeros) and one past the
        # detrend-truncated length (N = 5500 -> 5000)
        x = rng.normal(size=1 << 16).astype(np.float32)
        x[63990:64020] += 3.0
        y = rng.normal(size=5500).astype(np.float32)
        y[4985:5000] += 6.0
        return [x, y], [0.0, 0.0], None, {}
    if name == "zero_variance":
        x = rng.normal(size=16000).astype(np.float32)
        x[4000:5000] = 3.14
        x[10000] += 12.0
        z = rng.normal(size=16000).astype(np.float32)
        z[8000:9000] *= 40.0
        return [x, z], [1.0, 2.0], None, dict(threshold=6.0, chunklen=4000,
                                              fftlen=4096)
    if name == "offregions":
        x = rng.normal(size=30000).astype(np.float32)
        for p in (9990, 10003, 20004, 25000):
            x[p:p + 6] += 4.0
        return [x], [5.0], [[(10000, 12000), (20000, 21000)]], {}
    if name == "nobadblocks_fast":
        x = rng.normal(size=24000).astype(np.float32)
        x[6000:7000] *= 20.0
        x[15000:15004] += 6.0
        return [x], [3.0], None, dict(badblocks=False, fast_detrend=True)
    raise KeyError(name)


CASES = ["pulses", "edges", "zero_variance", "offregions",
         "nobadblocks_fast"]


@pytest.mark.parametrize("path", ["search", "search_many",
                                  "search_many_resident"])
@pytest.mark.parametrize("case", CASES)
def test_search_paths_match_jax(case, path):
    series, dms, offs, kw = _case(case)
    js, ts = _jax_search(**kw), _port_search(**kw)
    thr = ts.threshold
    if path == "search":
        for x, dm, off in zip(series, dms, offs or [()] * len(series)):
            wc, wsd, wb = js.search(x, DT, dm=dm, offregions=off)
            gc, gsd, gb = ts.search(x, DT, dm=dm, offregions=off)
            assert_agree(wc, gc, thr)
            np.testing.assert_allclose(gsd, wsd, rtol=2e-6)
            np.testing.assert_array_equal(gb, wb)
        return
    if path == "search_many":
        want = js.search_many(series, DT, dms, offs)
        got = ts.search_many(series, DT, dms, offs)
    elif len({len(x) for x in series}) == 1:
        want = js.search_many_resident(np.stack(series), DT, dms, offs)
        got = ts.search_many_resident(np.stack(series), DT, dms, offs)
    else:                                 # one batch per length
        want, got = [], []
        for i, x in enumerate(series):
            o = None if offs is None else [offs[i]]
            want += js.search_many_resident(x[None], DT, [dms[i]], o)
            got += ts.search_many_resident(x[None], DT, [dms[i]], o)
    assert len(got) == len(want) == len(series)
    total = 0
    for (wc, wsd, wb), (gc, gsd, gb) in zip(want, got):
        assert_agree(wc, gc, thr)
        np.testing.assert_allclose(gsd, wsd, rtol=2e-6)
        np.testing.assert_array_equal(gb, wb)
        total += len(gc)
    assert total > 0


def test_zero_variance_block_flagged_without_nans():
    """A constant block (a masked prepsubband block's padding) is flagged
    bad on both paths, with and without the bad-block cut, and the
    pulse beside it survives (tests/test_review_fixes_sp.py)."""
    series, _dms, _o, kw = _case("zero_variance")
    x = series[0]
    for bb in (True, False):
        sp = _port_search(**dict(kw, badblocks=bb))
        for cands, stds, bad in (sp.search(x, DT),
                                 sp.search_many_resident(x[None], DT,
                                                         [0.0])[0]):
            assert np.all(np.isfinite(stds))
            assert 4 in bad
            assert any(abs(c.bin - 10000) <= 2 for c in cands)


@pytest.mark.parametrize("edge", ["at", "past"])
def test_resident_overflow_matches_jax(edge):
    """Small topk and G: rows with more hits than topk (taken again by a
    stable sort) and a file whose capped hit count sits at G ("at": the
    compacted path) or one past it ("past": the search_many overflow
    path, on the same device)."""
    rng = np.random.default_rng(8)
    n = 24000
    series = np.stack([rng.normal(size=n) for _ in range(3)]).astype(
        np.float32)
    series[1, 5000:9000] += np.sin(np.arange(4000) / 3.0) * 2.5
    kw = dict(threshold=3.0, topk=8)
    ts = _port_search(**kw)
    widths, chunklen, fftlen, overlap, kern_f = ts._chunk_geometry(
        [1] + ts.downfacts_for(DT))
    resid, stds = T._detrend_blocks(torch.as_tensor(series).reshape(-1, 1000),
                                    1000, False)
    scales, masks, _bads = ts.block_scales(stds.numpy().reshape(3, -1))
    *_r, counts = T._resident_pipeline(
        resid, torch.as_tensor(scales), torch.as_tensor(masks), kern_f,
        3.0, 1000, n // 1000, chunklen, fftlen, overlap, 8, 4096)
    capped = np.minimum(counts, 8).sum(axis=(1, 2))
    assert (counts > 8).any()
    G = int(capped.max()) - (1 if edge == "past" else 0)
    want = _jax_search(**kw).search_many_resident(series, DT, [0, 1, 2],
                                                  G=G)
    got = ts.search_many_resident(series, DT, [0, 1, 2], G=G)
    for (wc, _ws, wb), (gc, _gs, gb) in zip(want, got):
        assert_agree(wc, gc, 3.0)
        np.testing.assert_array_equal(gb, wb)


def test_resident_takes_the_seam_tensor_and_refuses_obs():
    """The seam tensor and a host array give the same events; ``obs``
    (once refused) is taken: the same events, and the call's sp_search
    unit cost probed on the handle's book."""
    from presto_tpu_torch.obs import Observability, ObsConfig, costmodel
    x = np.random.default_rng(1).normal(size=(2, 9000)).astype(np.float32)
    ts = _port_search()
    a = ts.search_many_resident(torch.as_tensor(x), DT, [0.0, 1.0])
    b = ts.search_many_resident(x, DT, [0.0, 1.0])
    assert [[str(c) for c in r[0]] for r in a] == \
        [[str(c) for c in r[0]] for r in b]
    obs = Observability(ObsConfig(enabled=True))
    c = ts.search_many_resident(x, DT, [0.0, 1.0], obs=obs)
    assert [[str(e) for e in r[0]] for r in c] == \
        [[str(e) for e in r[0]] for r in b]
    unit = costmodel.book(obs).unit("sp_search")
    assert unit is not None and unit.flops > 0 and unit.hbm_bytes > 0


@pytest.mark.parametrize("feed", [1000, 3777, 50000])
def test_stream_matches_batch_search(feed):
    """SinglePulseStream fed in pieces of ``feed`` samples gives the
    batch search's candidates (its equivalence contract: badblocks
    False, no near-zero-variance block)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=47500).astype(np.float32)
    for p in (1234, 7990, 8003, 23999, 31000, 46990):
        x[p:p + 7] += 3.5
    sp = _port_search(threshold=5.0, badblocks=False)
    want, _s, _b = sp.search(x, DT, dm=7.5)
    st = T.SinglePulseStream(sp, DT, dm=7.5)
    got = []
    for i in range(0, len(x), feed):
        got += st.feed(x[i:i + feed])
    got += st.flush()
    assert [str(c) for c in got] == [str(c) for c in want]
    assert len(want) >= 4
    with pytest.raises(ValueError):
        T.SinglePulseStream(_port_search(), DT)


def test_singlepulse_file_bytes_equal_to_jax(tmp_path):
    rng = np.random.default_rng(9)
    rows = [(int(b), float(s), int(d)) for b, s, d in zip(
        np.sort(rng.integers(0, 10 ** 7, 30)), rng.uniform(5, 40, 30),
        rng.choice([1, 2, 30], 30))]
    for mod, name in ((J, "j"), (T, "t")):
        mod.write_singlepulse(str(tmp_path / (name + ".singlepulse")), [
            mod.SPCandidate(bin=b, sigma=s, time=b * 6.4e-5, downfact=d,
                            dm=123.456) for b, s, d in rows])
        mod.write_singlepulse(str(tmp_path / (name + "0.singlepulse")), [])
    for a, b in (("j", "t"), ("j0", "t0")):
        assert (tmp_path / (a + ".singlepulse")).read_bytes() == \
            (tmp_path / (b + ".singlepulse")).read_bytes()
    back = T.read_singlepulse(str(tmp_path / "t.singlepulse"))
    want = J.read_singlepulse(str(tmp_path / "j.singlepulse"))
    assert [(c.bin, c.sigma, c.time, c.downfact, c.dm) for c in back] == \
        [(c.bin, c.sigma, c.time, c.downfact, c.dm) for c in want]


def test_agreement_rule_explains_and_flags():
    """The rule itself: a %7.2f boundary pair, a line one side only near
    the threshold, a prune near-tie pair, and an unexplained line."""
    S = T.SPCandidate
    base = [S(bin=100, sigma=7.0, time=0.1, downfact=4, dm=5.0)]
    want = base + [S(bin=300, sigma=6.12499, time=0.3, downfact=2, dm=5.0),
                   S(bin=500, sigma=5.00002, time=0.5, downfact=1, dm=5.0),
                   S(bin=700, sigma=8.0, time=0.7, downfact=9, dm=5.0)]
    got = base + [S(bin=300, sigma=6.12501, time=0.3, downfact=2, dm=5.0),
                  S(bin=702, sigma=8.00001, time=0.702, downfact=4, dm=5.0)]
    r = T.agreement(want, got, 5.0)
    assert r["ok"] and r["equal_lines"] == 1 and len(r["boundary"]) == 1
    assert sorted(o["why"] for o in r["one_sided"]) == \
        ["prune near-tie", "prune near-tie", "threshold"]
    bad = T.agreement(want, got[:-1], 5.0)
    assert not bad["ok"] and bad["bad"][0]["bin"] == 700
    off = T.agreement(base, [S(bin=100, sigma=7.001, time=0.1, downfact=4,
                                dm=5.0)], 5.0)
    assert not off["ok"]
