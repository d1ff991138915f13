"""The target-scale apps of the port against the JAX package, on the CPU.

apps/{target_scale, target_scale_chip, target_scale_e2e} run at a small
Share (16 channels in 4 subbands, 2^12-sample blocks, 2^15 samples, 32
DMs over 4 devices, zmax 20, numharm 4, the pulsar at DM 3 made strong
enough to find in 2 s).  ``tools/target_scale_chip.py`` and
``tools/target_scale_e2e.py`` exit at import off a TPU, so the JAX side
is composed from ``presto_tpu`` functions; ``tools/target_scale.py`` is
imported for its make_block, delays and hbm_plan, its module constants
monkeypatched to the small geometry inside the test.

Tolerances: the blocks, the delays, the subband pass, the DM fan-out
and the sharded fan-out are byte-equal; the residency plan is equal; the
group pipeline's candidates above 1.01 x their stage's powcut have equal
keys (numharm, round(2r), round(2z)) and powers within rtol 1e-4 (the
two packages' FFTs round differently, as in test_torch_accel.py); the
sift of the same ACCEL files is equal line for line; single-pulse events
by ``search/singlepulse.agreement``; the referee's containment above
its sigma floor is 1.0 both ways.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu.ops import dedispersion as JD
from presto_tpu.ops import fftpack as JF
from presto_tpu.pipeline import sifting as JS
from presto_tpu.search import accel as jaccel
from presto_tpu.search import accel_pallas, build_pallas
from presto_tpu.search import singlepulse as JSP
from presto_tpu_torch.apps import target_scale as ts
from presto_tpu_torch.apps import target_scale_chip as tsc
from presto_tpu_torch.apps import target_scale_e2e as tse
from presto_tpu_torch.pipeline import sifting as TS
from presto_tpu_torch.search import accel as taccel
from presto_tpu_torch.search import singlepulse as TSP
from tools import target_scale as jts

SMALL = ts.Share(numdms=32, ndev=4, nsamp=1 << 15, numchan=16, nsub=4,
                 numpts=1 << 12, psr_dm=3.0, psr_amp=0.5, zmax=20,
                 numharm=4, group=4)
SMALL_ARGS = ["--numdms", "32", "--ndev", "4", "--nsamp", "32768",
              "--numchan", "16", "--nsub", "4", "--numpts", "4096",
              "--psr_dm", "3.0", "--psr_amp", "0.5", "--zmax", "20",
              "--numharm", "4", "--group", "4"]


@pytest.fixture
def jax_small(monkeypatch):
    """tools/target_scale.py's constants at SMALL's geometry."""
    for name, val in (("NUMDMS", SMALL.numdms), ("NSAMP", SMALL.nsamp),
                      ("NUMCHAN", SMALL.numchan), ("NSUB", SMALL.nsub),
                      ("NUMPTS", SMALL.numpts), ("NBLOCKS", SMALL.nblocks),
                      ("DT", SMALL.dt), ("LOFREQ", SMALL.lofreq),
                      ("CHANWIDTH", SMALL.chanwidth), ("DM_LO", SMALL.dm_lo),
                      ("DDM", SMALL.ddm), ("PSR_F0", SMALL.psr_f0),
                      ("PSR_DM", SMALL.psr_dm), ("PSR_AMP", SMALL.psr_amp),
                      ("SEED", SMALL.seed)):
        monkeypatch.setattr(jts, name, val)
    return jts


@pytest.fixture
def jax_tpu_path(monkeypatch):
    """The JAX package's TPU search engine on the CPU (test_torch_accel's
    fixture), for this test only."""
    monkeypatch.setattr(accel_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jaccel, "_use_mxu_engine",
                        lambda fftlen: fftlen % 256 == 0)
    monkeypatch.setattr(build_pallas, "make_plane_builder",
                        functools.partial(build_pallas.make_plane_builder,
                                          interpret=True))
    monkeypatch.setattr(accel_pallas, "make_stage_reducer",
                        functools.partial(accel_pallas.make_stage_reducer,
                                          interpret=True))


@pytest.fixture(scope="module")
def blocks():
    return [ts.make_block(i, SMALL) for i in range(SMALL.nblocks)]


@pytest.fixture(scope="module")
def share_run(blocks):
    """The share's card half on the CPU from the host blocks (the pulsar
    in every trial): the subband stream, the pipeline and each group's
    candidate lists."""
    chan_d, dm_full, dms = ts.delays(SMALL)
    lo, hi = ts.dm_slice(SMALL, dms)
    psr = ts.psr_index(SMALL, dms)
    hp = ts.HostProbe(SMALL, chan_d, dm_full[psr])
    for i, b in enumerate(blocks):
        hp.feed(i, b)
    probe = ts.probe_pairs(hp.series)
    stream = tse.subband_stream(SMALL, blocks, chan_d, "cpu")
    srch = tse.searcher(SMALL, "cpu")
    pipe = tse.Pipeline(SMALL, srch, stream, np.ascontiguousarray(
        dm_full[lo:hi]), torch.as_tensor(probe), psr - lo)
    lists = []
    for gi in range(pipe.ngroups):
        packs, (host, _done) = pipe.dispatch(gi)
        lists += [pipe.steps.decode(host[j], p) for j, p in enumerate(packs)]
    return dict(chan_d=chan_d, dm_d=dm_full[lo:hi], dms=dms[lo:hi],
                psr_local=psr - lo, probe=probe, stream=stream, pipe=pipe,
                lists=lists)


# ---- the plan ----------------------------------------------------------

@pytest.mark.parametrize("i", [0, 1, 9])
def test_make_block_bytes_equal_jax(jax_small, i):
    want = jax_small.make_block(i, None)
    got = ts.make_block(i, SMALL)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_delays_equal_jax(jax_small):
    for g, w in zip(ts.delays(SMALL), jax_small.delays()):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_hbm_plan_equals_jax_at_16gib():
    want = jts.hbm_plan()
    got = ts.hbm_plan(ts.Share(), total_bytes=jts.V5E_HBM, device="cpu")
    for k, v in want.items():
        if k != "note":
            assert got[k] == v, k
    assert got["devices"] == 8 and got["full_series_trials_per_device"] == (
        (jts.V5E_HBM - got["streaming_resident_per_device"])
        // (jts.NSAMP * 4))
    with pytest.raises(MemoryError):
        ts.hbm_plan(ts.Share(), total_bytes=1 << 20, device="cpu")


def test_dm_slice_holds_the_pulsar():
    _c, _d, dms = ts.delays()
    lo, hi = ts.dm_slice(ts.Share(), dms)
    assert (lo, hi) == (2120, 2632)       # the JAX share (r05's dm_slice)
    assert lo <= ts.psr_index(ts.Share(), dms) < hi


# ---- the card's half -----------------------------------------------------

def _jax_subbands(blocks, chan_d):
    return [np.asarray(JD.dedisp_subbands_block(
        jnp.asarray(blocks[k]), jnp.asarray(blocks[k + 1]),
        jnp.asarray(chan_d), SMALL.nsub)) for k in range(len(blocks) - 1)]


def test_subband_pass_and_fan_out_bytes_equal_jax(blocks, share_run):
    subs = _jax_subbands(blocks, share_run["chan_d"])
    stream = share_run["stream"].numpy()
    assert stream.tobytes() == np.concatenate(subs, axis=1).tobytes()
    dm_d = share_run["dm_d"]
    want = np.concatenate([np.asarray(JD.float_dedisp_many_block(
        jnp.asarray(subs[b]), jnp.asarray(subs[b + 1]), jnp.asarray(dm_d)))
        for b in range(SMALL.nblocks - 2)], axis=1)
    got = tse.fan_out(share_run["stream"], dm_d, SMALL.nsamp).numpy()
    assert got.tobytes() == want.tobytes()


def test_sharded_fan_out_on_8_logical_shards_equals_one_device(blocks):
    share = dataclasses.replace(SMALL, ndev=8)
    chan_d, dm_d, dms = ts.delays(share)
    mesh = ts.share_mesh(share, "cpu")
    assert len(mesh.devices) == 8
    full = ts.FullWidth(share, mesh, chan_d, dm_d, ts.probe_rows(share, dms))
    for i in range(full.blocks):
        full.feed(i, blocks[i])
    n = ts.FULL_WIDTH_BLOCKS
    assert full.equal == [True] * n
    # and against the JAX package's one-device fan-out of the same blocks
    subs = _jax_subbands(blocks[:full.blocks], chan_d)
    for k in range(n):
        want = np.asarray(JD.float_dedisp_many_block(
            jnp.asarray(subs[k]), jnp.asarray(subs[k + 1]),
            jnp.asarray(dm_d)))[ts.probe_rows(share, dms)]
        assert full.kept[k].numpy().tobytes() == want.tobytes()


def test_chip_equality_against_the_numpy_referee(blocks):
    chan_d, dm_full, dms = ts.delays(SMALL)
    lo, hi = ts.dm_slice(SMALL, dms)
    eq = tsc.Equality(SMALL, chan_d, dm_full[lo:hi], "cpu")
    for i in range(eq.blocks):
        eq.feed(i, blocks[i])
    assert eq.result()["bit_equal_vs_numpy"] and eq.equal == [True, True]


def _strong(cands, powcut):
    return {(c.numharm, round(2 * c.r), round(2 * c.z)): c.power
            for c in cands
            if c.power > 1.01 * powcut[int(np.log2(c.numharm))]}


def test_group_pipeline_lists_equal_jax_composition(jax_tpu_path, blocks,
                                                    share_run):
    """The JAX fan-out, rFFT (fftpack), the probe spectrum at its row and
    AccelSearch.search_many (compact_scan_packed + collect_compacted) on
    its TPU engine, against the port's pipeline, group by group."""
    run = share_run
    subs = _jax_subbands(blocks, run["chan_d"])
    cfg = jaccel.AccelConfig(zmax=SMALL.zmax, numharm=SMALL.numharm,
                             sigma=SMALL.sigma,
                             max_cands_per_stage=tse.MAX_CANDS_PER_STAGE)
    js = jaccel.AccelSearch(cfg, T=SMALL.T, numbins=SMALL.numbins)
    assert js._plb_hw_eff, "the JAX side must be on the TPU geometry"
    assert run["pipe"].s.powcut == js.powcut
    n = 0
    for gi in range(run["pipe"].ngroups):
        rows = run["pipe"].rows(gi)
        series = jnp.concatenate([JD.float_dedisp_many_block(
            jnp.asarray(subs[b]), jnp.asarray(subs[b + 1]),
            jnp.asarray(run["dm_d"][rows.start:rows.stop]))
            for b in range(SMALL.nblocks - 2)], axis=1)
        series = series - jnp.mean(series, axis=1, keepdims=True)
        pairs = np.array(JF.realfft_packed_pairs(series))
        if run["psr_local"] in rows:
            pairs[run["psr_local"] - rows.start] = run["probe"]
        want = js.search_many(pairs)
        for j, w in zip(rows, want):
            kw, kg = (_strong(w, js.powcut),
                      _strong(run["lists"][j], js.powcut))
            assert set(kw) == set(kg), j
            for k, p in kw.items():
                np.testing.assert_allclose(kg[k], p, rtol=1e-4)
            n += len(kw)
    assert n > 0
    top = taccel.remove_duplicates(run["lists"][run["psr_local"]])[0]
    assert ts.harmonic_of(top.freq(SMALL.T), SMALL.psr_f0, 2e-2)


def test_share_sift_equals_jax_sift(tmp_path, share_run):
    files = [tse.write_trial(str(tmp_path), d, c, SMALL)
             for d, c in zip(share_run["dms"], share_run["lists"])]
    got = TS.sift_candidates(files, numdms_min=2)
    want = JS.sift_candidates(files, numdms_min=2)
    assert len(got.cands) == len(want.cands) > 0
    assert [str(c) for c in got.cands] == [str(c) for c in want.cands]
    assert [c.hits for c in got.cands] == [c.hits for c in want.cands]


def test_share_singlepulse_agrees_with_jax(share_run):
    pipe = share_run["pipe"]
    port = TSP.SinglePulseSearch(threshold=tse.SP_THRESHOLD, device="cpu")
    jax_sp = JSP.SinglePulseSearch(threshold=tse.SP_THRESHOLD)
    total = 0
    for gi in range(pipe.ngroups):
        series = pipe.series(gi)
        dms = [float(share_run["dms"][t]) for t in pipe.rows(gi)]
        # the pulsar in every trial overflows G: each file goes through
        # search_many, the JAX package's own path, and is listed
        ovf = []
        got = port.search_many_resident(series, SMALL.dt, dms, overflowed=ovf)
        want = jax_sp.search_many_resident(series.numpy(), SMALL.dt, dms)
        assert ovf == list(range(len(dms)))
        for (wc, _ws, wb), (gc, _gs, gb) in zip(want, got):
            r = TSP.agreement(wc, gc, tse.SP_THRESHOLD)
            assert r["ok"], r
            np.testing.assert_array_equal(gb, wb)
            total += len(gc)
    assert total > 0


def _chirp_pairs(numbins, tones):
    """tests/test_referee.py's spectrum: noise (seed 99) and tones of
    constant fdot, synthesized in time and transformed."""
    N = 2 * numbins
    rng = np.random.default_rng(99)
    t = np.arange(N) / N
    x = rng.normal(size=N)
    for (r0, z, amp) in tones:
        x += amp * np.cos(2 * np.pi * (r0 * t + 0.5 * z * t * t))
    X = np.fft.rfft(x)[:numbins]
    return np.stack([X.real, X.imag], -1).astype(np.float32)


SIGMA_FLOOR_CHIRP = 30.0


def test_referee_summary_on_the_chirp_spectrum():
    """tests/test_referee.py's containment pin (2^16 bins, T 300 s, zmax
    30, numharm 4, sigma 3, floor 30) through the e2e referee check."""
    pairs = _chirp_pairs(1 << 16, [(5000.5, 0.0, 0.30),
                                   (20000.25, 10.0, 0.35),
                                   (43210.0, -15.0, 0.40)])
    srch = taccel.AccelSearch(taccel.AccelConfig(zmax=30, numharm=4,
                                                 sigma=3.0),
                              T=300.0, numbins=1 << 16, device="cpu")
    res = tse.referee_check(pairs, srch)
    assert res["feature_match_above_floor"] == [1.0, 1.0]
    assert min(res["n_above_floor"]) > 0
    assert not res["violations"], res["violations"]
    assert res["mismatch_explanations"] and all(
        e["kind"] != "unexplained" for e in res["mismatch_explanations"])
    # reported, not required: the eliminated lists part below the strong
    # tones (float32 against float64 in the sidelobes)
    assert res["top_identical_n"] >= 2
    assert res["first_divergence_sigma"] < SIGMA_FLOOR_CHIRP


def test_compacted_decode_may_truncate():
    srch = tse.searcher(SMALL, "cpu")
    srch.slab_plan(srch.plane_geom()[2])
    m = 4
    comp = np.zeros((3, m), np.int32)
    comp[0] = np.asarray([90.0, 80.0, 70.0, 60.0], np.float32).view(np.int32)
    comp[1] = 2 * int(srch.rlo) + 40 + np.arange(m)
    with pytest.raises(ValueError):
        srch.collect_compacted(comp, [0], requested_m=m)
    got = srch.collect_compacted(comp, [0], requested_m=m,
                                 allow_truncated=True)
    assert len(got) == m and tse.overflowed(comp)


# ---- the apps end to end -------------------------------------------------

@pytest.mark.parametrize("app,extra,keys", [
    (ts, [], ("full_width_bit_equal", "lists_equal_sharded_vs_one_device",
              "probe_row_equals_host", "pulsar_recovered")),
    (tsc, [], ("bit_equal_vs_numpy", "throughput", "search")),
    (tse, ["--replay-workers", "1"],
     ("device_floor_sec", "e2e_share_sec", "singlepulse", "referee",
      "ncands_sifted", "launches", "host_concurrency")),
], ids=["target_scale", "target_scale_chip", "target_scale_e2e"])
def test_app_main_runs_on_the_cpu(tmp_path, app, extra, keys):
    out = tmp_path / "art.json"
    rc = app.main(["-device", "cpu", "--json", str(out)] + SMALL_ARGS
                  + extra)
    art = json.loads(out.read_text())
    assert rc == 0 and art["ok"] is True
    for k in keys:
        assert k in art, k


def test_referee_only_main(tmp_path):
    ts.probe_series(SMALL)                  # the cached probe
    out = tmp_path / "ref.json"
    rc = tse.main(["-device", "cpu", "--referee-only", "--referee-bins",
                   "8192", "--json", str(out)] + SMALL_ARGS)
    art = json.loads(out.read_text())
    assert rc == 0 and art["numbins"] == 8192 and art["violations"] == []


def test_host_blocks_from_worker_threads_equal_inline():
    share = dataclasses.replace(SMALL, numpts=1 << 10, nsamp=1 << 12)
    got = list(ts.host_blocks(share, 3))
    assert [i for i, _ in got] == [0, 1, 2]
    for i, b in got:
        assert b.tobytes() == ts.make_block(i, share).tobytes()


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(ts.Share)])
def test_probe_cache_keyed_by_every_share_field(field):
    """A share that differs in any one field (lofreq, chanwidth, dm_lo and
    ddm all move the pulsar-DM series) has a cache file of its own."""
    val = getattr(SMALL, field)
    other = dataclasses.replace(SMALL, **{field: val * 2 if val else 1})
    assert ts.probe_cache_path(other) != ts.probe_cache_path(SMALL)
    assert ts.probe_cache_path(dataclasses.replace(SMALL)) == \
        ts.probe_cache_path(SMALL)


@pytest.mark.parametrize("call", [
    lambda: ts.run(SMALL),
    lambda: ts.hbm_plan(SMALL),
    lambda: tsc.run(SMALL),
    lambda: tse.run(SMALL),
    lambda: tse.referee_only(SMALL),
    lambda: ts.main(SMALL_ARGS),
    lambda: tsc.main(SMALL_ARGS),
    lambda: tse.main(SMALL_ARGS),
], ids=["target_scale.run", "hbm_plan", "target_scale_chip.run",
        "target_scale_e2e.run", "referee_only", "target_scale.main",
        "target_scale_chip.main", "target_scale_e2e.main"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
