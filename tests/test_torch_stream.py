"""presto_tpu_torch/stream: the live streaming search against the JAX
package's (presto_tpu/stream) on the CPU.

  * Rolling dedispersion: the port's RollingDedisp series byte-equal to
    the JAX RollingDedisp's, to the JAX prepsubband .dat and to the
    port's prepsubband .dat over the valid span, for a many-block
    observation and one shorter than a block.
  * StreamSearch: the port's triggers equal to the JAX StreamSearch's on
    the same feed — (time, dm, downfact, bin, members) equal, sigma
    within search/singlepulse.SIGMA_ATOL — and its finalized candidates
    held to the JAX ones by search/singlepulse.agreement.
  * RingBlockSource, feed_stream, SocketProducer and FileTailProducer:
    block assembly, drop-oldest and truncation accounting.
  * testing/chaos: the live-feed, serve and file-corruption helpers
    against the JAX package's.
  * StreamService end to end on the port's SearchService over a
    loopback socket: every pulse triggered once, deadline-lane ticks
    counted, the latency histogram filled; the chaos trials of
    tools/stream_chaos.py (stall, truncation, ring drop) through the
    port's apps/stream_chaos.

Feeds come from tools/stream_loadgen (the JAX package's injector).
"""

import glob
import io
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))

import stream_loadgen  # noqa: E402

from presto_tpu.io import sigproc as jsigproc  # noqa: E402
from presto_tpu.io.datfft import read_dat  # noqa: E402
from presto_tpu.stream import StreamConfig as JStreamConfig  # noqa: E402
from presto_tpu.stream import StreamSearch as JStreamSearch  # noqa: E402
from presto_tpu.stream.rolling import RollingDedisp as JRolling  # noqa: E402
from presto_tpu.testing import chaos as jchaos  # noqa: E402

from presto_tpu_torch.apps import stream_chaos  # noqa: E402
from presto_tpu_torch.io import sigproc  # noqa: E402
from presto_tpu_torch.search import singlepulse as spm  # noqa: E402
from presto_tpu_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from presto_tpu_torch.serve.server import SearchService  # noqa: E402
from presto_tpu_torch.stream import (FileTailProducer,  # noqa: E402
                                     RingBlockSource, RollingDedisp,
                                     SocketProducer, StreamConfig,
                                     StreamSearch, StreamService,
                                     feed_stream)
from presto_tpu_torch.testing import chaos  # noqa: E402

DT = 1e-3
NCHAN = 16
LODM, DMSTEP, NUMDMS, NSUB = 10.0, 5.0, 4, 8


def _header(n, nchan=NCHAN, dt=DT):
    return sigproc.FilterbankHeader(
        nbits=32, nchans=nchan, nifs=1, tsamp=dt, fch1=400.0,
        foff=-1.0, tstart=55000.0, source_name="synthetic", N=n)


def _fil_bytes(data, hdr):
    buf = io.BytesIO()
    sigproc.write_filterbank_header(hdr, buf)
    arr = data[:, ::-1] if hdr.foff < 0 else data
    buf.write(sigproc.pack_bits(np.ascontiguousarray(arr).ravel(),
                                hdr.nbits).tobytes())
    return buf.getvalue()


def _wire_spectra(hdr, wire):
    """A loadgen wire's spectra, ascending frequency (the reader seam's
    order)."""
    body = wire[len(wire) - hdr.N * hdr.bytes_per_spectrum:]
    return np.frombuffer(body, np.float32).reshape(
        hdr.N, hdr.nchans)[:, ::-1].copy()


def _blocks(raw, blocklen):
    """(block, nreal) in ring order: the last block zero-padded."""
    for pos in range(0, raw.shape[0], blocklen):
        blk = raw[pos:pos + blocklen]
        nreal = blk.shape[0]
        if nreal < blocklen:
            blk = np.concatenate(
                [blk, np.zeros((blocklen - nreal, raw.shape[1]),
                               np.float32)])
        yield blk, nreal


def _drive(eng, raw, blocklen):
    """Feed `raw` through a StreamSearch (either package's) block by
    block: (concatenated rolling series, triggers, every finalized
    candidate before dedup)."""
    series, cands = [], []
    feed, dedup = eng.rolling.feed, eng._dedup

    def capture(b):
        out = feed(b)
        if out is not None:
            series.append(np.asarray(out))
        return out

    def keep(c, final=False):
        cands.extend(c)
        return dedup(c, final)

    eng.rolling.feed, eng._dedup = capture, keep
    trigs = []
    for blk, nreal in _blocks(raw, blocklen):
        trigs += eng.feed_block(blk, nreal)
    trigs += eng.finish()
    return np.concatenate(series, axis=1), trigs, cands


def _trig_key(t):
    return (t.time, t.dm, t.downfact, t.bin, t.members)


def _assert_triggers_equal(want, got):
    """(time, dm, downfact, bin, members) equal; sigma within the
    single-pulse agreement's SIGMA_ATOL."""
    assert [_trig_key(t) for t in got] == [_trig_key(t) for t in want]
    for a, b in zip(want, got):
        assert abs(a.sigma - b.sigma) <= spm.SIGMA_ATOL, (a, b)


def _cand_lists(cands, dms):
    """Finalized candidates grouped per DM trial, bin-sorted (file
    order, what singlepulse.agreement compares)."""
    return [sorted((c for c in cands if c.dm == float(dm)),
                   key=lambda c: (c.bin, c.downfact)) for dm in dms]


# ----------------------------------------------------------------------
# Rolling dedispersion: byte-identity with both packages' prepsubband
# ----------------------------------------------------------------------

def _prepsubband(tmp_path, filpath, out, jax_side):
    argv = ["-lodm", str(LODM), "-dmstep", str(DMSTEP), "-numdms",
            str(NUMDMS), "-nsub", str(NSUB), "-nobary", "-clip", "0",
            "-o", out, filpath]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        if jax_side:
            from presto_tpu.apps import prepsubband as jpsb
            jpsb.main(argv)
        else:
            from presto_tpu_torch.apps import prepsubband as psb
            psb.main(argv, device="cpu")
    finally:
        os.chdir(cwd)
    return sorted(glob.glob(str(tmp_path / ("%s_DM*.dat" % out))))


@pytest.mark.parametrize("n,blocklen", [(20000, 4096), (3000, 4096)],
                         ids=["multiblock", "shorter_than_a_block"])
def test_rolling_series_byte_equal_to_jax_and_prepsubband(tmp_path, n,
                                                          blocklen):
    """The port's rolling series equals, byte for byte over the valid
    span, the JAX RollingDedisp's (every sample it produced) and both
    packages' prepsubband .dat files: many carry steps with a block
    length the batch driver does not use, and an observation shorter
    than one block (the EOF zero pad must not poison the series)."""
    rng = np.random.default_rng(7)
    data = rng.normal(10, 2, (n, NCHAN)).astype(np.float32)
    hdr = _header(n)
    filpath = str(tmp_path / "beam.fil")
    with open(filpath, "wb") as f:
        f.write(_fil_bytes(data, hdr))
    jdats = _prepsubband(tmp_path, filpath, "jax", jax_side=True)
    pdats = _prepsubband(tmp_path, filpath, "port", jax_side=False)
    assert len(jdats) == len(pdats) == NUMDMS
    with sigproc.FilterbankFile(filpath) as fb:
        raw = fb.read_spectra(0, n)
    cfg = StreamConfig(lodm=LODM, dmstep=DMSTEP, numdms=NUMDMS,
                       nsub=NSUB)
    eng = StreamSearch(hdr, cfg, blocklen=blocklen, device="cpu")
    series, _, _ = _drive(eng, raw, blocklen)
    jroll = JRolling(eng._chan_bins, eng._dm_bins, NSUB)
    jseries = [jroll.feed(b) for b, _ in _blocks(raw, blocklen)]
    jseries += jroll.flush(blocklen, NCHAN)
    jseries = np.concatenate([np.asarray(s) for s in jseries
                              if s is not None], axis=1)
    assert series.dtype == np.float32
    assert np.array_equal(series, jseries)
    valid = n - eng.maxd
    assert valid > 0
    for i, (jf, pf) in enumerate(zip(jdats, pdats)):
        jd, pd = read_dat(jf), read_dat(pf)
        assert np.array_equal(jd[:valid], series[i][:valid]), jf
        assert np.array_equal(pd[:valid], series[i][:valid]), pf


def test_rolling_dedisp_primes_two_blocks_and_flushes():
    """Block 0 primes the raw carry, block 1 the subband carry, every
    later block yields one series block; flush() pushes two zero
    blocks, as in the JAX carry."""
    chan_bins = np.array([3, 2, 1, 0], np.int32)
    dm_bins = np.array([[0, 0], [2, 0]], np.int32)
    roll = RollingDedisp(chan_bins, dm_bins, 2, device="cpu")
    jroll = JRolling(chan_bins, dm_bins, 2)
    rng = np.random.default_rng(3)
    for k in range(4):
        blk = rng.normal(size=(16, 4)).astype(np.float32)
        out, jout = roll.feed(blk), jroll.feed(blk)
        assert (out is None) == (jout is None) == (k < 2)
        if out is not None:
            assert np.array_equal(out, np.asarray(jout))
    flushed, jflushed = roll.flush(16, 4), jroll.flush(16, 4)
    assert len(flushed) == len(jflushed) == 2
    for a, b in zip(flushed, jflushed):
        assert np.array_equal(a, np.asarray(b))
    assert roll.blocks_in == 6


# ----------------------------------------------------------------------
# StreamSearch: triggers and candidates against the JAX package
# ----------------------------------------------------------------------

def test_stream_search_triggers_match_jax():
    """Two dispersed pulses through both packages' StreamSearch on the
    same blocks: equal series, equal triggers (sigma within
    SIGMA_ATOL), the finalized candidates of every DM trial held by
    singlepulse.agreement, and both injected pulses triggered exactly
    once near their times."""
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=1, nchan=NCHAN, dt=DT, seconds=25.0, npulses=2, dm=20.0,
        amp=4.0)
    raw = _wire_spectra(hdr, wire)
    kw = dict(lodm=LODM, dmstep=DMSTEP, numdms=NUMDMS, nsub=NSUB,
              threshold=6.5)
    eng = StreamSearch(hdr, StreamConfig(**kw), blocklen=4096,
                       device="cpu")
    series, trigs, cands = _drive(eng, raw, 4096)
    jeng = JStreamSearch(hdr, JStreamConfig(**kw), blocklen=4096)
    jseries, jtrigs, jcands = _drive(jeng, raw, 4096)
    assert np.array_equal(series, jseries)
    _assert_triggers_equal(jtrigs, trigs)
    assert cands, "pulses must be detectable"
    for want, got in zip(_cand_lists(jcands, eng.dms),
                         _cand_lists(cands, eng.dms)):
        agree = spm.agreement(want, got, kw["threshold"])
        assert agree["ok"], agree
    assert len(trigs) == len(truth)
    for tr, t0 in zip(trigs, truth):
        assert abs(tr.time - t0) < 0.2
        assert abs(tr.dm - 20.0) <= DMSTEP
    assert eng.summary() == jeng.summary()


def test_stream_search_quarantine_matches_jax():
    """note_quarantine maps damaged raw spectra to the same offregions
    in every DM trial as the JAX engine, and the triggers that follow
    stay equal."""
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=2, nchan=NCHAN, dt=DT, seconds=20.0, npulses=2, dm=20.0,
        amp=4.0)
    raw = _wire_spectra(hdr, wire)
    lo = int((truth[0] - 1.0) / DT)
    raw[lo:lo + 3000] = 0.0
    kw = dict(lodm=LODM, dmstep=DMSTEP, numdms=NUMDMS, nsub=NSUB,
              threshold=6.5)
    eng = StreamSearch(hdr, StreamConfig(**kw), blocklen=4096,
                       device="cpu")
    jeng = JStreamSearch(hdr, JStreamConfig(**kw), blocklen=4096)
    for e in (eng, jeng):
        e.note_quarantine(lo, lo + 3000)
    assert [s._offregions for s in eng.streams] == \
        [s._offregions for s in jeng.streams]
    _, trigs, _ = _drive(eng, raw, 4096)
    _, jtrigs, _ = _drive(jeng, raw, 4096)
    _assert_triggers_equal(jtrigs, trigs)


def test_blocklen_resolution_matches_jax():
    """resolve_blocklen: the explicit length (rounded up to the
    downsample factor), else the batch streaming bound; a block not
    longer than every delay is refused."""
    from presto_tpu.stream import rolling as jrolling
    from presto_tpu_torch.stream import rolling
    hdr = _header(1 << 16)
    for kw in (dict(), dict(blocklen=4097, downsamp=2),
               dict(blocklen=1000, numdms=8, dmstep=50.0)):
        cfg = StreamConfig(**dict(dict(lodm=LODM, dmstep=DMSTEP,
                                       numdms=NUMDMS, nsub=NSUB), **kw))
        jcfg = JStreamConfig(**dict(dict(lodm=LODM, dmstep=DMSTEP,
                                         numdms=NUMDMS, nsub=NSUB), **kw))
        dms, cb, db, maxd = rolling.plan_stream(hdr, cfg)
        jdms, jcb, jdb, jmaxd = jrolling.plan_stream(hdr, jcfg)
        assert np.array_equal(dms, jdms) and maxd == jmaxd
        assert np.array_equal(cb, jcb) and np.array_equal(db, jdb)
        try:
            want = jrolling.resolve_blocklen(hdr, jcfg, jmaxd, jcb, jdb)
        except ValueError:
            with pytest.raises(ValueError):
                rolling.resolve_blocklen(hdr, cfg, maxd, cb, db)
            continue
        assert rolling.resolve_blocklen(hdr, cfg, maxd, cb, db) == want


# ----------------------------------------------------------------------
# RingBlockSource and the producers
# ----------------------------------------------------------------------

def test_ring_assembles_fixed_blocks():
    src = RingBlockSource(capacity=8)
    src.set_header(_header(0, nchan=4))
    src.configure(100)
    src.push_spectra(np.ones((250, 4), np.float32))
    src.eof()
    sizes = []
    while True:
        blk = src.next_block(timeout=1.0)
        if blk is None:
            break
        sizes.append((blk.nreal, blk.data.shape))
    assert sizes == [(100, (100, 4)), (100, (100, 4)), (50, (100, 4))]
    assert src.at_eof


def test_ring_drop_oldest_accounting_and_gap_synthesis():
    src = RingBlockSource(capacity=2, policy="drop-oldest")
    src.set_header(_header(0, nchan=4))
    src.configure(10)
    src.push_spectra(
        np.arange(50 * 4, dtype=np.float32).reshape(50, 4) + 1)
    src.eof()
    stats = src.stats()
    assert stats["dropped_blocks"] == 3
    assert stats["dropped_spectra"] == 30
    # every dropped spectrum is a quarantine ledger entry
    assert src.quality.counts().get("ring-drop", 0) == 30
    got = []
    while True:
        blk = src.next_block(timeout=1.0)
        if blk is None:
            break
        got.append(blk)
    # 5 blocks in stream order: 3 synthesized zero gaps + the last 2
    assert [b.seq for b in got] == [0, 1, 2, 3, 4]
    assert [b.nreal for b in got] == [0, 0, 0, 10, 10]
    assert not got[0].data.any()
    assert got[0].quarantined == [("ring-drop", 0, 10)]
    assert got[3].data[0, 0] == 121.0   # spectrum 30, chan 0


def test_ring_block_policy_waits_for_the_consumer():
    """policy="block": a full ring holds the producer back instead of
    shedding, and nothing is dropped."""
    src = RingBlockSource(capacity=1, policy="block")
    src.set_header(_header(0, nchan=2))
    src.configure(4)

    def produce():
        src.push_spectra(np.ones((16, 2), np.float32))
        src.eof()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    n = 0
    while True:
        blk = src.next_block(timeout=5.0)
        if blk is None:
            break
        n += blk.nreal
    t.join(5.0)
    assert not t.is_alive()
    assert n == 16 and src.stats()["dropped_blocks"] == 0
    with pytest.raises(ValueError):
        RingBlockSource(policy="newest")


def test_truncation_quarantined():
    hdr = _header(40, nchan=4)
    wire = _fil_bytes(np.ones((40, 4), np.float32), hdr)
    src = RingBlockSource(capacity=8)
    cut = len(wire) - 4 * 2             # half a spectrum of trailing bytes
    t = threading.Thread(target=feed_stream,
                         args=(src, io.BytesIO(wire[:cut])), daemon=True)
    src.configure(16)                   # consumer side pre-configured
    t.start()
    t.join(5.0)
    assert not t.is_alive()
    assert src.quality.counts().get("truncated", 0) == 1
    # 39 full spectra + 1 zero-padded truncated one
    assert src.stats()["pushed_spectra"] == 40


def test_feed_stream_decodes_like_the_jax_feed():
    """An 8-bit wire through both packages' feed_stream: the same
    blocks (decoded by the port's native decoder), the same quality."""
    from presto_tpu.stream.source import RingBlockSource as JRing
    from presto_tpu.stream.source import feed_stream as jfeed
    rng = np.random.default_rng(5)
    hdr = sigproc.FilterbankHeader(
        nbits=8, nchans=8, nifs=1, tsamp=DT, fch1=400.0, foff=-1.0,
        tstart=55000.0, source_name="synthetic", N=300)
    data = rng.integers(0, 255, (300, 8)).astype(np.float32)
    data[100:180] = 0.0                 # a zero-fill run
    wire = _fil_bytes(data, hdr)
    got = []
    for ring_cls, feed in ((RingBlockSource, feed_stream),
                           (JRing, jfeed)):
        src = ring_cls(capacity=16)
        src.configure(64)
        feed(src, io.BytesIO(wire))
        blocks = []
        while True:
            blk = src.next_block(timeout=1.0)
            if blk is None:
                break
            blocks.append((blk.seq, blk.nreal, blk.data))
        got.append((blocks, src.quality.to_json(), src.stats()))
    (pb, pq, ps), (jb, jq, js) = got
    assert [(s, n) for s, n, _ in pb] == [(s, n) for s, n, _ in jb]
    for (_, _, a), (_, _, b) in zip(pb, jb):
        assert np.array_equal(a, b)
    assert pq == jq and ps == js
    assert pq["intervals"] == [{"start": 100, "stop": 180,
                                "reason": "zero-fill"}]


def test_file_tail_producer(tmp_path):
    hdr = _header(200, nchan=4)
    wire = _fil_bytes(np.full((200, 4), 3.0, np.float32), hdr)
    path = str(tmp_path / "grow.fil")
    with open(path, "wb") as f:
        f.write(wire[:len(wire) // 2])
    src = RingBlockSource(capacity=16)
    prod = FileTailProducer(src, path, poll_s=0.01,
                            idle_eof_s=0.5).start()
    src.wait_header(5.0)
    src.configure(64)
    time.sleep(0.1)
    with open(path, "ab") as f:         # the file grows mid-tail
        f.write(wire[len(wire) // 2:])
    prod.join(10.0)
    total = 0
    while True:
        blk = src.next_block(timeout=1.0)
        if blk is None:
            break
        total += blk.nreal
    assert total == 200
    assert src.quality.clean


def test_socket_producer_and_stall_fill():
    """A loopback feed that freezes past the source's stall budget: the
    gap is zero fill quarantined as "stall", the late spectra owed to it
    are discarded on resume, and the stream position stays aligned."""
    hdr = _header(3000, nchan=4)
    data = np.full((3000, 4), 5.0, np.float32)
    wire = _fil_bytes(data, hdr)
    src = RingBlockSource(capacity=64, stall_timeout_s=0.2)
    prod = SocketProducer(src).start()
    hdrlen = len(wire) - 3000 * hdr.bytes_per_spectrum

    def client():
        s = socket.create_connection(prod.address)
        half = hdrlen + 1500 * hdr.bytes_per_spectrum
        s.sendall(wire[:half])
        time.sleep(0.7)                 # longer than the stall budget
        s.sendall(wire[half:])
        s.close()

    threading.Thread(target=client, daemon=True).start()
    src.wait_header(5.0)
    src.configure(256)
    prod.join(20.0)
    stats = src.stats()
    stall = src.quality.counts().get("stall", 0)
    assert stall > 0 and stats["stall_spectra"] == stall
    # the debt was settled against the late data: spectra in == out
    assert stats["stall_debt"] == 0
    assert stats["pushed_spectra"] == 3000
    prod.close()


# ----------------------------------------------------------------------
# testing/chaos: the helpers against the JAX package's
# ----------------------------------------------------------------------

def test_chaos_file_corrupters_match_jax(tmp_path):
    payload = bytes(range(256)) * 64
    paths = []
    for side in ("port", "jax"):
        p = str(tmp_path / side)
        with open(p, "wb") as f:
            f.write(payload)
        paths.append(p)
    offs = chaos.bitflip_file(paths[0], nflips=5, seed=3, lo=10)
    assert offs == jchaos.bitflip_file(paths[1], nflips=5, seed=3, lo=10)
    chaos.zero_fill_file(paths[0], 100, 50)
    jchaos.zero_fill_file(paths[1], 100, 50)
    assert chaos.truncate_file(paths[0], keep_frac=0.5) == \
        jchaos.truncate_file(paths[1], keep_frac=0.5)
    assert chaos.truncate_file(paths[0], keep_bytes=10 ** 9) == \
        os.path.getsize(paths[0])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    with open(paths[0], "rb") as f:
        short = chaos.ShortReadFile(f, budget=100)
        assert len(short.read(60)) == 60 and len(short.read(60)) == 40
        assert short.read(10) == b"" and short.read() == b""
        assert short.tell() == 100


def test_chaos_stream_and_transient_faults():
    faults = chaos.StreamFaults([(100, "stall", 0.01),
                                 (50, "raise", "link down")])
    faults(10)
    assert faults.fired == []
    with pytest.raises(RuntimeError, match="link down"):
        faults(60)
    faults(200)
    assert [f[:2] for f in faults.fired] == [(50, "raise"),
                                             (100, "stall")]
    with pytest.raises(ValueError):
        chaos.StreamFaults([(0, "explode", None)])(1)
    tf = chaos.TransientFaults(fail_attempts=2,
                               match=lambda job: job.job_id != "x")

    class J:
        job_id = "j1"
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="attempt %d" % attempt):
            tf(J(), attempt)
    tf(J(), 3)
    J.job_id = "x"
    tf(J(), 1)
    assert tf.calls == 4
    assert chaos.BEAM_KILL_POINTS == jchaos.BEAM_KILL_POINTS


# ----------------------------------------------------------------------
# StreamService end to end on the port's serve core
# ----------------------------------------------------------------------

def _service_run(tmp_path, wire, cfg, timeout=120.0):
    svc = SearchService(str(tmp_path), heartbeat_s=0.2).start()
    src = RingBlockSource(capacity=32)
    prod = SocketProducer(src).start()

    def client():
        s = socket.create_connection(prod.address)
        for i in range(0, len(wire), 1 << 16):
            s.sendall(wire[i:i + (1 << 16)])
        s.close()

    threading.Thread(target=client, daemon=True).start()
    stream = StreamService(svc, src, cfg, device="cpu").start()
    assert stream.wait(timeout)
    prod.close()
    return svc, stream


def test_stream_service_socket_feed_triggers_exactly_once(tmp_path):
    """A loopback socket feed -> RingBlockSource -> StreamService on the
    port's SearchService: every injected pulse triggered exactly once,
    the trigger payloads equal an offline port StreamSearch's on the
    same spectra, ticks on the deadline lane, one latency sample a
    trigger, heartbeats on /events."""
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=4, nchan=NCHAN, dt=DT, seconds=20.0, npulses=2, dm=20.0,
        amp=4.0)
    cfg = StreamConfig(lodm=LODM, dmstep=DMSTEP, numdms=NUMDMS,
                       nsub=NSUB, threshold=6.5, blocklen=4096)
    svc, stream = _service_run(tmp_path, wire, cfg)
    try:
        assert stream.failed is None
        evs = svc.events.tail(100000)
        trigs = [e for e in evs if e["kind"] == "trigger"]
        assert len(trigs) == len(truth)
        for e, t0 in zip(trigs, truth):
            assert abs(e["time"] - t0) < 0.2
            assert abs(e["dm"] - 20.0) <= DMSTEP
            assert e["latency_s"] >= 0.0
        _, offline, _ = _drive(
            StreamSearch(hdr, cfg, device="cpu"), _wire_spectra(hdr, wire),
            4096)
        strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                           if k != "latency_s"}
        assert [strip(e) for e in
                ({k: v for k, v in ev.items()
                  if k not in ("seq", "ts", "kind", "stream")}
                 for ev in trigs)] == [strip(t.to_json()) for t in offline]
        kinds = {e["kind"] for e in evs}
        assert {"stream-start", "stream-eof"} <= kinds
        deadline = time.time() + 10.0
        while (not svc.events.counts().get("heartbeat")
               and time.time() < deadline):
            time.sleep(0.02)
        assert svc.events.counts().get("heartbeat", 0) >= 1
        lanes = svc.obs.metrics.get("serve_lane_batches_total")
        assert lanes.labels(lane="deadline").value >= 1
        h = svc.obs.metrics.get("stream_latency_seconds")
        assert h.labels(stream="stream-0", beam="-").count == len(trigs)
        blocks = svc.obs.metrics.get("stream_blocks_total").value
        # the live blocks, and the engine's carry fed two flush blocks
        assert blocks == -(-hdr.N // 4096)
        assert stream.summary()["engine"]["blocks"] == blocks + 2
        names = {s.name for s in svc.obs.tracer.finished()}
        assert {"stream:block", "stream:dedisp", "stream:search",
                "serve-job"} <= names
        assert stream.summary()["latency"]["p99"] > 0
    finally:
        svc.stop()


@pytest.mark.parametrize("where", ["before-tick", "in-tick"])
def test_stream_service_tick_failure_skips_no_block(tmp_path, monkeypatch,
                                                    where):
    """A device error on the deadline lane never skips a block.  Raised
    by the scheduler's fault injector before the second tick runs, the
    block is still in the inbox: the retry processes it and every pulse
    triggers once.  Raised inside the second block's step (a CUDA
    out-of-memory), the block is gone: the stream ends with `failed`
    set, no later block reaches the carry, and the retried job fails."""
    import torch
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=4, nchan=NCHAN, dt=DT, seconds=20.0, npulses=2, dm=20.0,
        amp=4.0)
    cfg = StreamConfig(lodm=LODM, dmstep=DMSTEP, numdms=NUMDMS,
                       nsub=NSUB, threshold=6.5, blocklen=4096)
    nblocks = -(-hdr.N // 4096)
    ticks = []

    def injector(job, attempt):
        if where == "before-tick" and "-tick-" in job.job_id:
            ticks.append(job.job_id)
            if len(ticks) == 2:
                raise RuntimeError("CUDA error: injected before a tick")

    feeds = []
    real_feed = StreamSearch.feed_block

    def feed_block(self, data, nreal):
        feeds.append(nreal)
        if where == "in-tick" and len(feeds) == 2:
            raise torch.cuda.OutOfMemoryError("injected in a tick")
        return real_feed(self, data, nreal)

    monkeypatch.setattr(StreamSearch, "feed_block", feed_block)
    svc = SearchService(str(tmp_path), scheduler_cfg=SchedulerConfig(
        fault_injector=injector, backoff_base_s=0.01)).start()
    try:
        src = RingBlockSource(capacity=32, policy="block")
        stream = StreamService(svc, src, cfg, device="cpu").start()
        src.set_header(hdr)
        raw = _wire_spectra(hdr, wire)
        reg = svc.obs.metrics
        for k, lo in enumerate(range(0, hdr.N, 4096)):
            src.push_spectra(raw[lo:lo + 4096])
            if lo + 4096 <= hdr.N:
                # one block a tick: the next block is pushed only once
                # this one's tick job has completed (after its retry,
                # for the injected failure) or the stream has failed
                _wait_tick_done(svc, stream, k + 1)
        src.eof()
        assert stream.wait(60.0)
        blocks = reg.get("stream_blocks_total").value
        kinds = [e["kind"] for e in svc.events.tail(100000)]
        if where == "before-tick":
            assert stream.failed is None
            assert reg.get("serve_job_retries_total").value >= 1
            assert blocks == nblocks
            assert all(c == 1 for c in _hits(svc, truth).values())
            assert "stream-eof" in kinds and "stream-fail" not in kinds
            return
        assert isinstance(stream.failed, torch.cuda.OutOfMemoryError)
        assert blocks == 1 and len(feeds) == 2
        assert "stream-fail" in kinds and "stream-eof" not in kinds
        assert reg.get("serve_device_errors_total").value >= 1
        deadline = time.time() + 10.0
        while (reg.get("serve_jobs_failed_total").value < 1
               and time.time() < deadline):
            time.sleep(0.02)
        assert reg.get("serve_jobs_failed_total").value == 1
        assert len(feeds) == 2        # the retries fed nothing further
        assert stream_chaos._scheduler_alive(svc)
    finally:
        svc.stop()


def test_stream_cli_runs_a_tailed_file(tmp_path, capsys):
    """presto-stream -tail FILE (service.main with device="cpu"): the
    summary JSON says ok, with the stream's engine counts."""
    import json
    from presto_tpu_torch.stream import service
    hdr, wire, truth = stream_loadgen.make_feed(
        seed=6, nchan=NCHAN, dt=DT, seconds=12.0, npulses=1, dm=20.0,
        amp=4.0)
    path = str(tmp_path / "feed.fil")
    with open(path, "wb") as f:
        f.write(wire)
    out = str(tmp_path / "summary.json")
    rc = service.main(["-tail", path, "-lodm", str(LODM), "-dmstep",
                       str(DMSTEP), "-numdms", str(NUMDMS), "-nsub",
                       str(NSUB), "-thresh", "6.5", "-blocklen", "4096",
                       "-workdir", str(tmp_path / "w"), "-json", out,
                       "-timeout", "120"], device="cpu")
    assert rc == 0
    summary = json.load(open(out))
    assert summary["ok"] and summary["engine"]["spectra"] == hdr.N
    assert summary["engine"]["triggers"] == len(truth)


# ----------------------------------------------------------------------
# tools/stream_chaos.py's trials, on the port: apps/stream_chaos
# ----------------------------------------------------------------------

def _wait_tick_done(svc, stream, n, timeout=30.0):
    """Wait until n of the stream's tick jobs have completed, or the
    stream has failed; the wait fails past its deadline."""
    deadline = time.time() + timeout
    while stream.failed is None:
        done = sum(1 for e in svc.events.tail(100000)
                   if e["kind"] == "complete" and "-tick-" in e["job"])
        if done >= n:
            return
        assert time.time() < deadline, "tick %d never completed" % n
        time.sleep(0.005)


def _hits(svc, truth):
    """truth index -> trigger count (exactly-once per pulse)."""
    return stream_chaos._matched(stream_chaos._triggers(svc), truth)


def _recorded_setup(monkeypatch):
    """apps/stream_chaos._setup, each trial's (header, wire, truth,
    service, source, producer, stream) recorded."""
    made = []
    real = stream_chaos._setup

    def setup(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    monkeypatch.setattr(stream_chaos, "_setup", setup)
    return made


@pytest.mark.chaos
def test_chaos_stall_quarantined_and_post_stall_pulses_trigger(
        tmp_path, monkeypatch):
    """The producer freezes mid-stream past the stall budget: zero fill
    quarantined as "stall", every pulse outside the damaged window
    triggered once, the scheduler still alive (stream_chaos.trial_stall
    on the CPU)."""
    made = _recorded_setup(monkeypatch)
    # a 0.6 s stall budget (the JAX trial's is 0.3 s) keeps a busy
    # host's sending hiccups from reading as stalls; the 1.5 s freeze
    # still spans two budgets
    res = stream_chaos.trial_stall(str(tmp_path), device="cpu",
                                   stall_timeout_s=0.6, stall_s=1.5)
    stream = made[0][6]
    assert res["finished"] and stream.failed is None
    assert res["stall_fired"]
    assert res["quarantine"].get("stall", 0) > 0
    hits = res["pulse_hits"]
    assert all(hits[t] == 1 for t in res["safe_pulses"]), hits
    assert all(c <= 1 for c in hits.values())
    assert res["scheduler_alive"]
    assert res["ok"]


@pytest.mark.chaos
def test_chaos_truncation_and_ring_drop(tmp_path, monkeypatch):
    """The connection dies mid-spectrum: the partial spectrum is
    quarantined, the stream EOFs and pre-cut pulses trigger once.  A
    burst into a 2-block ring: shed blocks are quarantined as ring-drop
    (every dropped spectrum accounted) and no trigger duplicates
    (stream_chaos.trial_truncation and trial_ringdrop on the CPU)."""
    made = _recorded_setup(monkeypatch)
    res = stream_chaos.trial_truncation(str(tmp_path / "t"), device="cpu")
    assert res["finished"] and made[0][6].failed is None
    assert res["quarantine"].get("truncated", 0) > 0
    hits = res["pulse_hits"]
    assert res["expected_pulses"] and all(
        hits[t] == 1 for t in res["expected_pulses"])
    assert all(c <= 1 for c in hits.values())
    assert res["scheduler_alive"] and res["ok"]
    res = stream_chaos.trial_ringdrop(str(tmp_path / "r"), device="cpu")
    svc, stream = made[1][3], made[1][6]
    assert res["finished"] and stream.failed is None
    assert res["dropped_blocks"] > 0
    assert res["dropped_spectra"] <= res["quarantine"].get("ring-drop", 0)
    assert all(c <= 1 for c in res["pulse_hits"].values())
    drops = svc.obs.metrics.get("stream_drops_total").value
    assert drops == res["dropped_blocks"]
    assert res["scheduler_alive"] and res["ok"]


class _Unseekable(io.BytesIO):
    """A byte stream that cannot seek (a socket's or a pipe's face)."""

    def seek(self, *a):
        if a and (a[0], a[1:] or (0,)) == (self.tell(), (0,)):
            return self.tell()
        raise io.UnsupportedOperation("unseekable")


def test_header_parse_agrees_with_jax_on_a_live_wire():
    """The port's header parser reads a loadgen wire as the JAX one
    does (the live path's first step), seekable or not: an unseekable
    stream leaves N unknown (0)."""
    _, wire, _ = stream_loadgen.make_feed(
        seed=9, nchan=NCHAN, dt=DT, seconds=2.0, npulses=1, dm=20.0)
    for cls, n_known in ((io.BytesIO, True), (_Unseekable, False)):
        a = sigproc.read_filterbank_header(cls(wire))
        b = jsigproc.read_filterbank_header(cls(wire))
        for k in ("nchans", "nbits", "tsamp", "fch1", "foff",
                  "headerlen", "N"):
            assert getattr(a, k) == getattr(b, k), k
        assert (a.N > 0) == n_known
