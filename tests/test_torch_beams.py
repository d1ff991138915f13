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
  * tools/stream_chaos.py's beam trials on the port: a stalled beam
    quarantined, not fatal; a replica killed mid-observation hands its
    beams off through the ledger with zero lost and zero duplicated
    triggers.
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

from presto_tpu_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from presto_tpu_torch.serve.server import SearchService  # noqa: E402
from presto_tpu_torch.stream import (BeamMultiplexer,  # noqa: E402
                                     CoincidenceVeto, RingBlockSource,
                                     RollingDedisp, StackedRollingDedisp,
                                     StreamConfig, StreamService,
                                     make_beam_block_step)
from presto_tpu_torch.stream.rolling import Trigger  # noqa: E402
from presto_tpu_torch.testing.chaos import (FaultInjector,  # noqa: E402
                                           SimulatedCrash)

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
# tools/stream_chaos.py's beam trials, on the port
# ----------------------------------------------------------------------

def test_mux_tick_device_error_ends_the_multiplexer(tmp_path,
                                                   monkeypatch):
    """A CUDA out-of-memory inside a tick's stacked step has taken that
    tick's bundle: the multiplexer ends with `failed` set, the retried
    job runs no further stacked step, and the job fails visibly."""
    import torch
    hdr, datas, _, cfg = _beam_setup(2, (0,), 3, seconds=8.0,
                                     npulses=1)
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
        assert _scheduler_alive(svc)
    finally:
        svc.stop()


def _beam_setup(nbeams, pulse_beams, seed, seconds=16.0, npulses=3):
    hdr, datas, t_signal, _ = stream_loadgen.make_beam_feeds(
        nbeams, pulse_beams=pulse_beams, seed=seed, nchan=64, dt=5e-4,
        seconds=seconds, npulses=npulses, nrfi=0)
    cfg = StreamConfig(lodm=25.0, dmstep=5.0, numdms=9, nsub=32,
                       threshold=7.0, blocklen=4096, ring_capacity=64)
    return hdr, datas, t_signal, cfg


def _matched(trigs, truth, tol=0.2):
    out = {i: 0 for i in range(len(truth))}
    for ev in trigs:
        for i, t in enumerate(truth):
            if abs(ev["time"] - t) <= tol:
                out[i] += 1
                break
    return out


def _beam_triggers(svc):
    out = {}
    for ev in svc.events.tail(100000):
        if ev["kind"] == "trigger":
            out.setdefault(ev["beam"], []).append(ev)
    return out


def _scheduler_alive(svc):
    done = threading.Event()
    svc.submit_callable(lambda job: done.set() or {}, lane="deadline")
    return done.wait(10.0)


@pytest.mark.chaos
def test_stalled_beam_quarantined_not_fatal(tmp_path):
    """One beam's feeder goes quiet mid-observation: the mux gap-fills
    that lane (quarantine "stall"), keeps ticking the healthy beam, and
    sheds the late data on resume; the healthy beam's pulses trigger
    exactly once."""
    hdr, datas, truth, cfg = _beam_setup(2, (0,), 4)
    svc = SearchService(str(tmp_path), heartbeat_s=0.5).start()
    try:
        sources = [RingBlockSource(capacity=cfg.ring_capacity,
                                   policy=cfg.ring_policy) for _ in datas]
        threading.Thread(target=_push, args=(sources[0], hdr, datas[0]),
                         daemon=True).start()
        half = (len(datas[1]) // (2 * cfg.blocklen)) * cfg.blocklen

        def push_half():
            sources[1].set_header(hdr)
            for lo in range(0, half, 1024):
                sources[1].push_spectra(datas[1][lo:lo + 1024])

        threading.Thread(target=push_half, daemon=True).start()
        mux = BeamMultiplexer(svc, sources, cfg, qos_wait_s=0.25,
                              device="cpu").start()
        deadline = time.time() + 120.0
        while time.time() < deadline and not (
                len(mux.lanes) == 2 and mux.lanes[1].stalled_spectra > 0):
            time.sleep(0.05)
        assert mux.lanes[1].stalled_spectra > 0

        def push_rest():                # resume: stale data, shed
            for lo in range(half, len(datas[1]), 1024):
                sources[1].push_spectra(datas[1][lo:lo + 1024])
            sources[1].eof()

        threading.Thread(target=push_rest, daemon=True).start()
        assert mux.wait(120.0) and mux.failed is None
        counts = _matched(_beam_triggers(svc).get("beam-0", []), truth)
        lane1 = mux.lanes[1].health()
        assert lane1["quarantine"].get("stall", 0) > 0
        assert lane1["dropped_spectra"] + lane1["stalled_spectra"] > 0
        assert all(c == 1 for c in counts.values()), counts
        stalled = svc.obs.metrics.get("stream_beam_stalled_total")
        assert stalled.labels(beam="beam-1").value == \
            lane1["stalled_spectra"]
        assert _scheduler_alive(svc)
    finally:
        svc.stop()


@pytest.mark.chaos
def test_beam_handoff_exactly_once(tmp_path):
    """Replica A is killed at a beam-tick kill point mid-observation
    (after committing early triggers to the beam ledger); replica B
    reaps it, adopts the leases, replays the feeds and suppresses A's
    committed set: the ledger's per-beam triggers equal an untouched
    reference's, with zero lost and zero duplicated."""
    hdr, datas, truth, cfg = _beam_setup(2, (0, 1), 6)
    ref = _run_reference(str(tmp_path / "ref"), hdr, datas, cfg)
    fleet = str(tmp_path / "fleet")
    os.makedirs(fleet)
    svc_a = SearchService(str(tmp_path / "A"), heartbeat_s=0.5).start()
    faults = FaultInjector(kill_at="beam-tick", kill_after=1, mode="off")
    sources_a = [RingBlockSource(capacity=cfg.ring_capacity,
                                 policy=cfg.ring_policy) for _ in datas]
    gate = threading.Event()
    hold = 7 * cfg.blocklen

    def push_gated(source, data):
        source.set_header(hdr)
        for lo in range(0, len(data), 1024):
            if lo >= hold:
                gate.wait(120.0)
            source.push_spectra(data[lo:lo + 1024])
        source.eof()

    for s, d in zip(sources_a, datas):
        threading.Thread(target=push_gated, args=(s, d),
                         daemon=True).start()
    mux_a = BeamMultiplexer(svc_a, sources_a, cfg, fleet_dir=fleet,
                            host="replica-A", lease_ttl=5.0,
                            heartbeat_ttl=1.0, faults=faults,
                            device="cpu").start()

    def ledger_triggers():
        try:
            with open(os.path.join(fleet, "beams.json")) as f:
                rows = json.load(f)["beams"]
        except (OSError, ValueError, KeyError):
            return 0
        return sum(len(r.get("triggers") or []) for r in rows.values())

    deadline = time.time() + 120.0
    while ledger_triggers() == 0 and time.time() < deadline:
        time.sleep(0.05)
    faults.mode = "raise"               # arm: the next beam tick dies
    gate.set()
    while faults.fired is None and time.time() < deadline:
        time.sleep(0.05)
    assert faults.fired == "beam-tick"
    # the tick's crash ends replica A itself: no later tick runs
    assert mux_a.wait(10.0) and isinstance(mux_a.failed, SimulatedCrash)
    a_committed = ledger_triggers()
    svc_a.stop()
    time.sleep(1.5)                     # A's heartbeat expires (ttl 1.0)
    svc_b = SearchService(str(tmp_path / "B"), heartbeat_s=0.5).start()
    try:
        sources_b = [RingBlockSource(capacity=cfg.ring_capacity,
                                     policy=cfg.ring_policy)
                     for _ in datas]
        for s, d in zip(sources_b, datas):
            threading.Thread(target=_push, args=(s, hdr, d),
                             daemon=True).start()
        mux_b = BeamMultiplexer(svc_b, sources_b, cfg, fleet_dir=fleet,
                                host="replica-B", lease_ttl=5.0,
                                heartbeat_ttl=1.0, adopt=True,
                                device="cpu").start()
        assert mux_b.wait(120.0) and mux_b.failed is None
        totals = mux_b.summary_totals()
        with open(os.path.join(fleet, "beams.json")) as f:
            rows = json.load(f)["beams"]
        ledger = {beam: sorted(json.dumps(t, sort_keys=True)
                               for t in (row.get("triggers") or []))
                  for beam, row in rows.items()}
        assert a_committed >= 1
        assert totals["handoffs"] == len(datas)
        assert totals["replayed"] == a_committed
        for b in ref:
            assert ledger[b] == sorted(ref[b])
            assert len(set(ledger[b])) == len(ledger[b])
        assert [r["state"] for _, r in sorted(rows.items())] == \
            ["done", "done"]
        assert _scheduler_alive(svc_b)
    finally:
        svc_b.stop()


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
