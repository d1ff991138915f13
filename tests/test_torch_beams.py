"""presto_tpu_torch/stream/beams: the beam multiplexer against the JAX
package's (presto_tpu/stream/beams) on the CPU.

  * The stacked step: StackedRollingDedisp's beam b bit-equal to a port
    RollingDedisp fed the same blocks and to the JAX StackedRollingDedisp,
    and its torch ops the same in number at 1 beam and at 13 (the
    launches a tick on the card do not grow with the beams).
  * CoincidenceVeto: decisions equal to the JAX veto's on one trigger
    list.
  * Per-source stall debt.
  * The multiplexer with the veto off: every beam's triggers equal an
    independent port stream's, dispatches <= ticks, every spectrum
    accounted; with coincidence_k=3, a burst in every beam vetoed and a
    one-beam pulse kept.
  * tools/stream_chaos.py's beam trials through the port's
    apps/stream_chaos: a stalled beam quarantined, not fatal; a replica
    killed mid-observation hands its beams off through the ledger with
    zero lost and zero duplicated triggers.
"""

import json
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))

import stream_loadgen  # noqa: E402

from presto_tpu.stream.beams import CoincidenceVeto as JVeto  # noqa: E402
from presto_tpu.stream.beams import \
    StackedRollingDedisp as JStacked  # noqa: E402
from presto_tpu.stream.rolling import Trigger as JTrigger  # noqa: E402

from presto_tpu_torch import stream as stream_pkg  # noqa: E402
from presto_tpu_torch.apps import stream_chaos  # noqa: E402
from presto_tpu_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from presto_tpu_torch.serve.server import SearchService  # noqa: E402
from presto_tpu_torch.stream import (BeamMultiplexer,  # noqa: E402
                                     CoincidenceVeto, RingBlockSource,
                                     RollingDedisp, StackedRollingDedisp,
                                     StreamConfig, StreamService,
                                     make_beam_block_step)
from presto_tpu_torch.stream.rolling import Trigger  # noqa: E402
from presto_tpu_torch.testing.chaos import SimulatedCrash  # noqa: E402

DT = 1e-3
NCHAN = 16


def _cfg(**kw):
    return StreamConfig(**dict(dict(lodm=10.0, dmstep=5.0, numdms=4,
                                    nsub=8, threshold=6.5, blocklen=4096,
                                    ring_capacity=64), **kw))


def _random_plan(rng, nchan, nsub, numdms, blocklen):
    chan_bins = np.sort(rng.integers(0, blocklen // 4,
                                     size=nchan)).astype(np.int32)
    chan_bins[0] = 0
    dm_bins = np.sort(rng.integers(0, blocklen // 4, size=(numdms, nsub)),
                      axis=1).astype(np.int32)
    dm_bins[:, 0] = 0
    return chan_bins, dm_bins


# ----------------------------------------------------------------------
# The stacked step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("downsamp", [1, 2])
def test_stacked_bit_equal_to_one_beam_carries_and_jax(downsamp):
    """Beam b's stacked series is bit-identical to a one-beam
    RollingDedisp fed the same blocks and to the JAX stacked step's, on
    every tick."""
    rng = np.random.default_rng(11)
    beams, nchan, nsub, numdms, blocklen = 3, 8, 4, 5, 256
    chan_bins, dm_bins = _random_plan(rng, nchan, nsub, numdms, blocklen)
    stacked = StackedRollingDedisp(chan_bins, dm_bins, nsub, downsamp,
                                   device="cpu")
    jstacked = JStacked(chan_bins, dm_bins, nsub, downsamp)
    singles = [RollingDedisp(chan_bins, dm_bins, nsub, downsamp,
                             device="cpu") for _ in range(beams)]
    emitted = 0
    for _ in range(5):
        blocks = rng.normal(0, 1, (beams, blocklen, nchan)
                            ).astype(np.float32)
        out, dispatched = stacked.feed(blocks)
        jout, jdispatched = jstacked.feed(blocks)
        refs = [s.feed(blocks[b]) for b, s in enumerate(singles)]
        assert dispatched == jdispatched
        if out is None:
            assert jout is None and all(r is None for r in refs)
            continue
        emitted += 1
        assert out.shape == (beams, numdms, blocklen // downsamp)
        assert np.array_equal(out, np.asarray(jout))
        for b in range(beams):
            assert np.array_equal(out[b], refs[b])
    assert emitted == 3 and stacked.blocks_in == 5
    flushed = stacked.flush(blocklen, nchan)
    assert len(flushed) == 2
    for b, single in enumerate(singles):
        for f, r in zip(flushed, single.flush(blocklen, nchan)):
            assert np.array_equal(f[b], r)


def test_stacked_carry_needs_two_blocks():
    stacked = StackedRollingDedisp(np.zeros(4, np.int32),
                                   np.zeros((2, 2), np.int32), 2,
                                   device="cpu")
    blk = np.ones((2, 64, 4), np.float32)
    assert stacked.feed(blk) == (None, 0)    # primes the raw carry
    assert stacked.feed(blk) == (None, 1)    # primes the subbands
    out, n = stacked.feed(blk)               # steady state
    assert n == 1 and out.shape == (2, 2, 64)
    assert np.array_equal(out, np.full((2, 2, 64), 4.0, np.float32))


#: torch ops that only make views or allocate: no kernel runs for them
#: (the CPU's cat may take one more view at some shapes)
_NO_KERNEL = {"aten::as_strided", "aten::slice", "aten::narrow",
              "aten::select", "aten::view", "aten::reshape",
              "aten::_reshape_alias", "aten::unsqueeze", "aten::expand",
              "aten::empty", "aten::resize_"}


def _op_counts(step, args):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(*args)
    return Counter(e.name for e in prof.events()
                   if e.name not in _NO_KERNEL)


def test_stacked_step_ops_do_not_grow_with_beams():
    """The stacked step runs the same computing torch ops (gathers,
    adds, concatenations), the same number of times, at 1 beam and at
    13: on the card, the same kernel launches a tick whatever the beam
    count (chip_smoke.py counts those with the profiler)."""
    rng = np.random.default_rng(2)
    nchan, nsub, numdms, T = 16, 4, 6, 128
    chan_bins, dm_bins = _random_plan(rng, nchan, nsub, numdms, T)
    prime, step = make_beam_block_step(chan_bins, dm_bins, nsub)
    counts = []
    for B in (1, 13):
        x = torch.randn(3, B, nchan, T)
        sub = prime(x[0], x[1])
        step(x[0], x[1], sub)               # delay tables built once
        counts.append(_op_counts(step, (x[1], x[2], sub)))
    assert counts[0] == counts[1]
    # one gather and one add a channel of a subband, then a subband
    assert counts[0]["aten::index"] == nchan // nsub + nsub


# ----------------------------------------------------------------------
# Cross-beam coincidence veto
# ----------------------------------------------------------------------

def _trig(cls, t, dm=20.0, sigma=8.0):
    return cls(time=t, dm=dm, sigma=sigma, downfact=1, bin=int(t / DT))


def test_coincidence_veto_matches_jax():
    """One trigger list through both packages' vetoes (k-beam clusters
    vetoed whole, same-beam repeats never veto, the frontier holding
    open windows, dm_tol splitting clusters, the final drain): equal
    emissions and decisions."""
    events = [("beam-0", 5.000, 20.0, 9.0), ("beam-1", 5.020, 20.0, 8.0),
              ("beam-2", 5.050, 25.0, 7.5), ("beam-0", 7.000, 20.0, 8.0),
              ("beam-0", 9.00, 20.0, 8.0), ("beam-0", 9.05, 20.0, 7.0),
              ("beam-1", 11.0, 20.0, 8.0), ("beam-2", 11.01, 45.0, 8.0),
              ("beam-1", 14.9, 20.0, 6.5)]
    for kw in (dict(k=2, window_s=0.1), dict(k=3, window_s=0.1),
               dict(k=2, window_s=0.1, dm_tol=2.0), dict(k=1)):
        outs = []
        for cls, tcls in ((CoincidenceVeto, Trigger), (JVeto, JTrigger)):
            v = cls(**kw)
            got = [v.enabled]
            for frontier in (5.3, 10.0, 15.2):
                for beam, t, dm, sig in events:
                    if frontier - 5.0 <= t < frontier:
                        v.add(beam, _trig(tcls, t, dm, sig))
                emit, vetoes = v.drain(frontier)
                got.append(([(b, tr.time, tr.dm) for b, tr in emit],
                            [d.to_json() for d in vetoes]))
            emit, vetoes = v.drain(0.0, final=True)
            got.append(([(b, tr.time, tr.dm) for b, tr in emit],
                        [d.to_json() for d in vetoes]))
            outs.append(got)
        assert outs[0] == outs[1], kw
    assert not CoincidenceVeto(1).enabled and CoincidenceVeto(2).enabled


# ----------------------------------------------------------------------
# Per-source stall debt (stream/source.py)
# ----------------------------------------------------------------------

def test_stall_debt_settles_against_late_data_only():
    src = RingBlockSource(capacity=8)
    src.note_stall_fill(100)
    assert src.stats()["stall_debt"] == 100
    assert src.settle_stall_debt(60) == 60   # stale, discard
    assert src.stats()["stall_debt"] == 40
    assert src.settle_stall_debt(100) == 40  # only the remainder
    assert src.stats()["stall_debt"] == 0
    assert src.settle_stall_debt(50) == 0    # healthy data flows


def test_stall_debt_is_per_source():
    a, b = RingBlockSource(capacity=8), RingBlockSource(capacity=8)
    a.note_stall_fill(64)
    assert b.settle_stall_debt(64) == 0
    assert b.stats()["stall_debt"] == 0
    assert a.stats()["stall_debt"] == 64 and a.stats()["stall_spectra"] \
        == 64


# ----------------------------------------------------------------------
# The multiplexer end to end
# ----------------------------------------------------------------------

_STRIP = ("seq", "ts", "kind", "stream", "beam", "latency_s")


def _payload(ev):
    return json.dumps({k: v for k, v in ev.items() if k not in _STRIP},
                      sort_keys=True)


def _push(source, hdr, data, chunk=1024):
    source.set_header(hdr)
    for lo in range(0, len(data), chunk):
        source.push_spectra(data[lo:lo + chunk])
    source.eof()


def _run_mux(workdir, hdr, datas, cfg, timeout=120.0, **kw):
    svc = SearchService(workdir, heartbeat_s=5.0).start()
    try:
        sources = [RingBlockSource(capacity=cfg.ring_capacity,
                                   policy=cfg.ring_policy) for _ in datas]
        for s, d in zip(sources, datas):
            threading.Thread(target=_push, args=(s, hdr, d),
                             daemon=True).start()
        mux = BeamMultiplexer(svc, sources, cfg, device="cpu",
                              **kw).start()
        assert mux.wait(timeout) and mux.failed is None, mux.failed
        evs = svc.events.tail(100000)
        per_beam = {lane.beam_id: [] for lane in mux.lanes}
        for ev in evs:
            if ev["kind"] == "trigger":
                per_beam[ev["beam"]].append(_payload(ev))
        lanes = svc.obs.metrics.get("serve_lane_batches_total")
        return mux, per_beam, evs, lanes.labels(lane="deadline").value
    finally:
        svc.stop()


def _run_reference(workdir, hdr, datas, cfg, timeout=120.0):
    """Independent port StreamServices, one a beam, on the same spectra."""
    out = {}
    for b, data in enumerate(datas):
        svc = SearchService(os.path.join(workdir, "ref-%d" % b),
                            heartbeat_s=5.0).start()
        try:
            src = RingBlockSource(capacity=cfg.ring_capacity,
                                  policy=cfg.ring_policy)
            threading.Thread(target=_push, args=(src, hdr, data),
                             daemon=True).start()
            stream = StreamService(svc, src, cfg, device="cpu").start()
            assert stream.wait(timeout) and stream.failed is None
            out["beam-%d" % b] = [_payload(e)
                                  for e in svc.events.tail(100000)
                                  if e["kind"] == "trigger"]
        finally:
            svc.stop()
    return out


def test_mux_veto_off_equals_independent_streams(tmp_path):
    """With the veto off each beam's trigger payloads equal an
    independent port stream's, one stacked step a tick at most, every
    spectrum consumed, nothing dropped or stalled."""
    hdr, datas, truth, _ = stream_loadgen.make_beam_feeds(
        3, pulse_beams=(0, 2), seed=4, nchan=NCHAN, dt=DT, seconds=16.0,
        npulses=2, nrfi=0, dm=20.0, amp=4.0)
    cfg = _cfg()
    ref = _run_reference(str(tmp_path / "ref"), hdr, datas, cfg)
    mux, per_beam, evs, deadline_ticks = _run_mux(
        str(tmp_path / "mux"), hdr, datas, cfg)
    for b in range(3):
        assert sorted(per_beam["beam-%d" % b]) == sorted(ref["beam-%d" % b])
    assert len(ref["beam-0"]) == len(ref["beam-2"]) == len(truth)
    ticks = max(lane.ticks for lane in mux.lanes)
    totals = mux.summary_totals()
    assert 1 <= totals["dispatches"] <= ticks
    # the summary's count is the registry's beam_dedisp dispatch counter
    assert totals["dispatches"] == mux.obs.metrics.get(
        "jax_dispatches_total").labels(kind="beam_dedisp").value
    assert deadline_ticks >= 1
    for row in mux.summary()["per_beam"]:
        assert row["spectra"] == hdr.N and row["state"] == "done"
        assert row["dropped_spectra"] == row["stalled_spectra"] == 0
    assert {"beam-start", "beam-eof", "stream-eof"} <= \
        {e["kind"] for e in evs}
    assert json.load(open(tmp_path / "mux" / "beams.json"))["beams"] == 3


def test_mux_coincidence_veto_kills_the_burst_keeps_the_pulse(tmp_path):
    """coincidence_k=3 over 3 beams: a burst in every beam is vetoed
    whole (a beam-veto event with each beam's evidence), the pulse in
    beam 0 alone is emitted."""
    hdr, datas, t_signal, t_rfi = stream_loadgen.make_beam_feeds(
        3, pulse_beams=(0,), seed=8, nchan=NCHAN, dt=DT, seconds=16.0,
        npulses=1, nrfi=1, dm=20.0, amp=4.0, rfi_amp=4.5)
    mux, per_beam, evs, _ = _run_mux(str(tmp_path), hdr, datas, _cfg(),
                                     coincidence_k=3, veto_window_s=0.25)
    vetoes = [e for e in evs if e["kind"] == "beam-veto"]
    assert len(vetoes) == 1
    assert abs(vetoes[0]["time"] - t_rfi[0]) < 0.2
    assert sorted(vetoes[0]["evidence"]) == ["beam-0", "beam-1", "beam-2"]
    kept = [json.loads(p) for p in per_beam["beam-0"]]
    assert [abs(k["time"] - t_signal[0]) < 0.2 for k in kept] == [True]
    assert per_beam["beam-1"] == per_beam["beam-2"] == []
    assert mux.summary_totals()["vetoed"] == 3


# ----------------------------------------------------------------------
# tools/stream_chaos.py's beam trials, on the port: apps/stream_chaos
# ----------------------------------------------------------------------

def test_mux_tick_device_error_ends_the_multiplexer(tmp_path,
                                                   monkeypatch):
    """A CUDA out-of-memory inside a tick's stacked step has taken that
    tick's bundle: the multiplexer ends with `failed` set, the retried
    job runs no further stacked step, and the job fails visibly."""
    import torch
    hdr, datas, _, cfg = stream_chaos._beam_setup(
        str(tmp_path), 2, (0,), 3, seconds=8.0, npulses=1)
    feeds = []
    real_feed = StackedRollingDedisp.feed

    def feed(self, stack_tc):
        feeds.append(stack_tc.shape)
        if len(feeds) == 2:
            raise torch.cuda.OutOfMemoryError("injected in a tick")
        return real_feed(self, stack_tc)

    monkeypatch.setattr(StackedRollingDedisp, "feed", feed)
    svc = SearchService(str(tmp_path), scheduler_cfg=SchedulerConfig(
        backoff_base_s=0.01)).start()
    try:
        sources = [RingBlockSource(capacity=cfg.ring_capacity,
                                   policy=cfg.ring_policy) for _ in datas]
        for src, d in zip(sources, datas):
            threading.Thread(target=_push, args=(src, hdr, d),
                             daemon=True).start()
        mux = BeamMultiplexer(svc, sources, cfg, device="cpu").start()
        assert mux.wait(60.0)
        assert isinstance(mux.failed, torch.cuda.OutOfMemoryError)
        reg = svc.obs.metrics
        deadline = time.time() + 10.0
        while (reg.get("serve_jobs_failed_total").value < 1
               and time.time() < deadline):
            time.sleep(0.02)
        assert reg.get("serve_jobs_failed_total").value == 1
        assert reg.get("serve_device_errors_total").value >= 1
        assert len(feeds) == 2
        kinds = [e["kind"] for e in svc.events.tail(100000)]
        assert "stream-eof" not in kinds
        assert stream_chaos._scheduler_alive(svc)
    finally:
        svc.stop()


def _recorded_muxes(monkeypatch):
    """The multiplexers apps/stream_chaos's trials make, recorded."""
    made = []

    class Recorded(BeamMultiplexer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(stream_pkg, "BeamMultiplexer", Recorded)
    return made


@pytest.mark.chaos
def test_stalled_beam_quarantined_not_fatal(tmp_path, monkeypatch):
    """One beam's feeder goes quiet mid-observation: the mux gap-fills
    that lane (quarantine "stall"), keeps ticking the healthy beam, and
    sheds the late data on resume; the healthy beam's pulses trigger
    exactly once (stream_chaos.trial_beam_stall on the CPU)."""
    made = _recorded_muxes(monkeypatch)
    res = stream_chaos.trial_beam_stall(str(tmp_path), device="cpu")
    mux = made[0]
    assert res["stalled_spectra"] > 0
    assert res["finished"] and mux.failed is None
    assert res["quarantine"].get("stall", 0) > 0
    assert res["dropped_spectra"] + res["stalled_spectra"] > 0
    hits = res["healthy_beam_hits"]
    assert hits and all(c == 1 for c in hits.values()), hits
    stalled = mux.obs.metrics.get("stream_beam_stalled_total")
    assert stalled.labels(beam="beam-1").value == res["stalled_spectra"]
    assert res["scheduler_alive"] and res["ok"]


@pytest.mark.chaos
def test_truncated_beam_flushes_early(tmp_path, monkeypatch):
    """One beam's feed dies halfway: that lane ends early while its
    sibling runs to the end; the healthy beam's pulses and the dead
    beam's pre-cut pulses trigger exactly once, none after the cut
    (stream_chaos.trial_beam_truncation on the CPU)."""
    made = _recorded_muxes(monkeypatch)
    res = stream_chaos.trial_beam_truncation(str(tmp_path), device="cpu")
    assert res["finished"] and made[0].failed is None
    assert res["lane_states"] == ["done", "done"]
    assert all(c == 1 for c in res["healthy_beam_hits"].values())
    dead = res["truncated_beam_hits"]
    assert res["expected_on_truncated"] and all(
        dead[t] == 1 for t in res["expected_on_truncated"])
    assert all(c == 0 for t, c in dead.items() if t > res["cut_at_s"])
    assert res["scheduler_alive"] and res["ok"]


@pytest.mark.chaos
def test_beam_handoff_exactly_once(tmp_path, monkeypatch):
    """Replica A is killed at a beam-tick kill point mid-observation
    (after committing early triggers to the beam ledger); replica B
    reaps it, adopts the leases, replays the feeds and suppresses A's
    committed set: the ledger's per-beam triggers equal an untouched
    reference's, with zero lost and zero duplicated
    (stream_chaos.trial_beam_handoff on the CPU)."""
    made = _recorded_muxes(monkeypatch)
    res = stream_chaos.trial_beam_handoff(str(tmp_path), device="cpu")
    mux_a, mux_b = made
    assert res["killed_at"] == "beam-tick"
    # the tick's crash ends replica A itself: no later tick runs
    assert mux_a.wait(0.1) and isinstance(mux_a.failed, SimulatedCrash)
    assert res["committed_before_kill"] >= 1
    assert res["handoffs"] == 2
    assert res["replayed"] == res["committed_before_kill"]
    assert res["byte_equal"] and res["no_duplicates"]
    assert res["ledger_triggers"] == res["reference_triggers"]
    assert res["ledger_states"] == ["done", "done"]
    assert res["finished"] and mux_b.failed is None
    assert res["scheduler_alive"] and res["ok"]


def test_beams_cli_tails_files(tmp_path):
    """presto-beams -tails F0 F1 (beams.main with device="cpu"): the
    summary JSON says ok, every spectrum of both beams consumed, and
    the per-beam triggers equal the multiplexer's in-process run."""
    from presto_tpu_torch.io import sigproc
    from presto_tpu_torch.stream import beams
    hdr, datas, truth, _ = stream_loadgen.make_beam_feeds(
        2, pulse_beams=(0, 1), seed=5, nchan=NCHAN, dt=DT, seconds=10.0,
        npulses=1, nrfi=0, dm=20.0, amp=4.0)
    whdr = sigproc.FilterbankHeader(
        nbits=32, nchans=NCHAN, nifs=1, tsamp=DT, fch1=hdr.fch1,
        foff=hdr.foff, tstart=hdr.tstart, source_name="beam", N=hdr.N)
    paths = []
    for b, data in enumerate(datas):
        paths.append(str(tmp_path / ("beam%d.fil" % b)))
        sigproc.write_filterbank(paths[-1], whdr, data)
    out = str(tmp_path / "summary.json")
    cfg = _cfg()
    rc = beams.main(["-tails"] + paths + [
        "-lodm", str(cfg.lodm), "-dmstep", str(cfg.dmstep), "-numdms",
        str(cfg.numdms), "-nsub", str(cfg.nsub), "-thresh",
        str(cfg.threshold), "-blocklen", str(cfg.blocklen), "-workdir",
        str(tmp_path / "w"), "-json", out, "-timeout", "120"],
        device="cpu")
    assert rc == 0
    summary = json.load(open(out))
    assert summary["ok"] and summary["beams"] == 2
    assert [row["spectra"] for row in summary["per_beam"]] == [hdr.N] * 2
    assert 1 <= summary["dispatches"]
    _, per_beam, _, _ = _run_mux(str(tmp_path / "mux"), hdr, datas, cfg)
    assert [row["triggers"] for row in summary["per_beam"]] == \
        [len(per_beam["beam-%d" % b]) for b in range(2)] == [1, 1]
