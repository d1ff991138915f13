"""Beam multiplexer: N live beam feeds as ONE stacked device chain.

The port of ``presto_tpu/stream/beams.py``: run as ``python -m
presto_tpu_torch.stream.beams``.  The stacked step is one batched step
over a beam axis (``make_beam_block_step``), so a tick launches the same
CUDA kernels at 1 beam and at 64; the device work runs on the card
unless the caller passes device="cpu".

Modern arrays deliver hundreds of coherent beams at once; one
`presto-stream` per beam means N sockets, N rolling-dedisp carries and
N deadline ticks fighting one queue.  This module multiplexes N
same-geometry beam feeds (sockets or tailed files) into a single
resident pipeline:

  * **Stacking** — per-beam `RingBlockSource` fronts are assembled
    tick-aligned into one ``[beams, nchan, blocklen]`` device tensor
    and pushed through ONE rolling-dedispersion step per stack group
    (`make_beam_block_step`): 64 beams cost one launch chain, not 64.
    Every beam's output sample is the same row-ascending chain of
    float32 adds as `ops.dedispersion`'s one-beam step, so every
    beam's dedispersed series — and therefore its trigger set, which
    is produced by feeding the per-beam slice back through the SAME
    `StreamSearch` trigger logic an independent `presto-stream` runs —
    is byte-identical to N independent instances.
  * **QoS / degradation** — the deadline tick never waits on a
    straggler: a beam whose next block has not arrived `qos_wait_s`
    after the first beam's has degrades to a zero gap block,
    quarantined as "stall" in that beam's own `DataQualityReport`
    (the per-beam dimension of the existing quality reasons) and
    counted on ``stream_beam_stalled_total{beam=}``.  The late real
    block is discarded on arrival (``stream_beam_dropped_total``) so
    the beam stays wall-clock aligned — per-beam stall debt, never
    shared (see stream/source.py).
  * **Cross-beam coincidence veto** — a real pulse is localized on
    the sky; broadband RFI is not.  Triggers landing in >= K distinct
    beams within `window_s` (and `dm_tol` when set) are vetoed as one
    cluster, emitting the decision AND the per-beam evidence
    (`beam-veto` event, ``stream_beam_vetoed_total{beam=}``).  With
    the veto off every per-beam trigger is emitted exactly as an
    independent stream would.
  * **Beam hand-off** — with a fleet directory, every beam is a
    leased item in a `BeamLedger` (pipeline/leaseledger.py: lease /
    heartbeat / epoch fencing).  Each tick commits newly emitted
    triggers and the emission frontier to the ledger *before* the
    events go out; when a replica dies mid-observation a successor
    reaps, re-leases, replays the (replayable) feeds and suppresses
    the already-committed triggers — zero lost, zero duplicated.

The tick runs on the serve scheduler's deadline lane exactly like
stream/service.StreamService (single outstanding tick; force
submission bypasses the depth bound without unbounded growth).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch.io.quality import DataQualityReport
from presto_tpu_torch.obs import costmodel, devtel
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.pipeline.leaseledger import LeaseLedger
from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.stream.rolling import (RollingDedisp, StreamConfig,
                                             StreamSearch, Trigger)
from presto_tpu_torch.stream.service import LATENCY_BUCKETS
from presto_tpu_torch.stream.source import (FileTailProducer,
                                            RingBlockSource,
                                            SocketProducer)

#: chaos seam names the multiplexer fires (testing/chaos.FaultInjector
#: substring match); testing/chaos.py re-exports them for trial authors
BEAM_KILL_POINTS = ("beam-tick", "beam-commit", "beam-handoff")


# ----------------------------------------------------------------------
# Stacked rolling dedispersion: one device step for a whole beam group
# ----------------------------------------------------------------------

def make_beam_block_step(chan_delays, dm_delays, numsubbands: int,
                         downsamp: int = 1):
    """Build the stacked two-block rolling step: ``(prime, step)``
    callables over ``[beams, nchan, blocklen]`` device carries.

    These are ops.dedispersion's block functions over a leading beam
    axis, the delays shared by every beam: one gather a channel of a
    subband and one a subband serve every beam, so the launches do not
    depend on the beam count, and beam b's series is bit-identical to a
    one-beam RollingDedisp fed the same blocks (the same float32 adds
    in the same order; no reduction reorders them)."""
    nsub = int(numsubbands)

    def prime(prev_raw, cur):
        """First carry transition: subbands only (no series yet)."""
        return dd.dedisp_subbands_block(
            prev_raw, cur, dd._as_delays(chan_delays, cur.device), nsub)

    return prime, dd.make_block_step(chan_delays, dm_delays, nsub,
                                     downsamp)


class StackedRollingDedisp(RollingDedisp):
    """RollingDedisp fed [beams, blocklen, nchan] stacks: the same
    carry, priming and pinned upload, each fed block one stacked step
    for every beam once primed."""

    def feed(self, stack_tc: np.ndarray
             ) -> Tuple[Optional[np.ndarray], int]:
        """stack_tc: [beams, blocklen, nchan] float32.  Returns
        (series [beams, numdms, blocklen // downsamp] or None while
        priming, stacked steps issued)."""
        dispatched = int(self._prev_raw is not None)
        return super().feed(stack_tc), dispatched

    def flush(self, blocklen: int, nchan: int) -> List[np.ndarray]:
        """The two zero flush blocks of every beam: the final stacked
        series blocks."""
        return [out for out, _ in super().flush(blocklen, nchan)
                if out is not None]


# ----------------------------------------------------------------------
# Cross-beam coincidence veto
# ----------------------------------------------------------------------

@dataclass
class VetoDecision:
    """One vetoed coincidence cluster with its per-beam evidence."""
    time: float                       # strongest member's arrival
    nbeams: int                       # distinct beams hit
    evidence: Dict[str, dict]         # beam id -> strongest trigger

    def to_json(self) -> dict:
        return {"time": round(self.time, 6), "nbeams": self.nbeams,
                "evidence": self.evidence}


class CoincidenceVeto:
    """Buffer per-beam triggers until every live beam's emission
    frontier has passed them, then cluster by arrival time (and DM
    when `dm_tol` is set): a cluster hitting >= `k` distinct beams is
    broadband RFI and is vetoed whole; everything else is released
    for emission.  `k` <= 1 disables buffering entirely (the
    byte-equality mode: triggers flow through untouched)."""

    def __init__(self, k: int, window_s: float = 0.1,
                 dm_tol: Optional[float] = None):
        self.k = int(k)
        self.window_s = float(window_s)
        self.dm_tol = dm_tol
        self._pending: List[Tuple[str, Trigger]] = []

    @property
    def enabled(self) -> bool:
        return self.k > 1

    def add(self, beam: str, trig: Trigger) -> None:
        self._pending.append((beam, trig))

    def _same_cluster(self, a: Trigger, b: Trigger) -> bool:
        if abs(a.time - b.time) > self.window_s:
            return False
        if self.dm_tol is not None \
                and abs(a.dm - b.dm) > self.dm_tol:
            return False
        return True

    def drain(self, frontier_s: float, final: bool = False
              ) -> Tuple[List[Tuple[str, Trigger]],
                         List[VetoDecision]]:
        """Release every pending trigger no future candidate can join
        (its window is fully behind every beam's frontier), clustered;
        returns (emit list, veto decisions)."""
        if final:
            ripe, self._pending = self._pending, []
        else:
            ripe = [p for p in self._pending
                    if p[1].time + self.window_s < frontier_s]
            self._pending = [p for p in self._pending
                             if p[1].time + self.window_s
                             >= frontier_s]
        clusters: List[List[Tuple[str, Trigger]]] = []
        for beam, trig in sorted(ripe, key=lambda p: p[1].time):
            for cl in clusters:
                if self._same_cluster(cl[0][1], trig):
                    cl.append((beam, trig))
                    break
            else:
                clusters.append([(beam, trig)])
        emit: List[Tuple[str, Trigger]] = []
        vetoes: List[VetoDecision] = []
        for cl in clusters:
            beams = {b for b, _ in cl}
            if len(beams) >= self.k:
                best = max(cl, key=lambda p: p[1].sigma)[1]
                ev: Dict[str, dict] = {}
                for b, t in cl:
                    if b not in ev or t.sigma > ev[b]["sigma"]:
                        ev[b] = {"time": round(t.time, 6),
                                 "dm": t.dm,
                                 "sigma": round(float(t.sigma), 3)}
                vetoes.append(VetoDecision(time=best.time,
                                           nbeams=len(beams),
                                           evidence=ev))
            else:
                emit.extend(cl)
        emit.sort(key=lambda p: p[1].time)
        return emit, vetoes


# ----------------------------------------------------------------------
# Beam ledger: lease / fence / exactly-once commit per beam
# ----------------------------------------------------------------------

class BeamLedgerError(Exception):
    pass


class StaleBeamWrite(BeamLedgerError):
    def __init__(self, item_id, host, epoch, current_epoch, why):
        self.item_id, self.host = item_id, host
        self.epoch, self.current_epoch = epoch, current_epoch
        self.why = why
        super().__init__(
            "stale beam write rejected: %r by %r under epoch %d "
            "(cluster epoch %d): %s"
            % (item_id, host, epoch, current_epoch, why))


class BeamLedger(LeaseLedger):
    """One leased item per beam inside a fleet directory.  The row's
    ``triggers`` list is the authoritative emitted set: `advance`
    commits new triggers (and the emission frontier) under the ledger
    lock with the full fence check BEFORE any event leaves the
    process, so a successor replaying the observation after a replica
    death suppresses exactly the committed set — zero lost, zero
    duplicated across the hand-off."""

    LEDGER_NAME = "beams.json"
    ITEMS_KEY = "beams"
    ERROR = BeamLedgerError
    STALE = StaleBeamWrite
    EV_LEASE = "beam-lease"
    EV_DONE = "beam-done"
    EV_REDO = "beam-redo"
    EV_STALE = "beam-stale-write"
    EV_HOST_DEAD = "beam-replica-dead"
    EV_EPOCH_BUMP = "beam-epoch-bump"

    def advance(self, leases: Dict[str, "ItemLease"], host: str,
                updates: Dict[str, dict], ttl: float,
                now: Optional[float] = None) -> None:
        """One transaction for the whole tick: for every beam in
        `updates` ({beam id: {"triggers": [...json...],
        "frontier_s": float, "vetoed": int}}) append the new
        triggers, advance the frontier and renew the lease.  Any
        fenced beam raises STALE (after recording the event) — a
        zombie replica must stop, not partially write."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            items = self._items(state)
            for iid in sorted(updates):
                lease = leases[iid]
                row = items.get(iid)
                why = self._fence_why(row, lease, host)
                if why is not None:
                    self._reject_stale(state, lease, host, {}, why)
                up = updates[iid]
                row.setdefault("triggers", []).extend(
                    up.get("triggers", ()))
                row["frontier_s"] = max(
                    float(row.get("frontier_s", 0.0)),
                    float(up.get("frontier_s", 0.0)))
                row["vetoed"] = int(row.get("vetoed", 0)) \
                    + int(up.get("vetoed", 0))
                row["lease_expires"] = now + ttl
            self._save(state)


# ----------------------------------------------------------------------
# Per-beam lane state
# ----------------------------------------------------------------------

class BeamLane:
    """One beam inside the multiplexer: its ring source, its OWN
    StreamSearch trigger engine (internal rolling carry bypassed —
    the stacked step hands each tick's series slice back through
    feed_series, so the trigger logic is literally the independent
    stream's code), and the per-beam accounting dimension."""

    LIVE, FLUSHING, DONE = "live", "flushing", "done"

    def __init__(self, beam_id: str, source: RingBlockSource,
                 engine: StreamSearch):
        self.beam_id = beam_id
        self.source = source
        self.engine = engine
        # two independent state machines, one per thread: the
        # ASSEMBLER advances feed_state (LIVE -> FLUSHING) when the
        # reader drains, and the TICK thread advances state
        # (LIVE -> FLUSHING -> DONE) from the pad ordinals carried in
        # each bundle — the tick thread may run many bundles behind
        # the assembler (burst feeds, compile stalls), so it must
        # never read the assembler's clock
        self.state = self.LIVE
        self.feed_state = self.LIVE
        self.inbox: deque = deque()       # blocks from the reader
        self.lock = threading.Lock()
        self.feed_eof = False             # reader saw source EOF
        self.ticks = 0                    # stacked ticks consumed
        self.flush_series: List[np.ndarray] = []
        self.flush_ticks = 0
        self.pad_issued = 0               # assembler-side flush pads
        self.last_t_arrival = time.time()
        # mux-side quarantine (straggler gap fill) — the `beam`
        # dimension of the existing quality reasons
        self.quality = DataQualityReport(
            path="<%s>" % beam_id, nchan=engine.hdr.nchans)
        self.stalled_spectra = 0
        self.dropped_spectra = 0
        self.vetoed = 0
        self.emitted = 0
        self.replayed = 0
        self.handoff = False
        self.committed: set = set()       # canonical trigger keys
        self._routed: set = set()         # quality intervals routed
        self._quar_seen = 0
        self.lease = None

    # canonical trigger identity: every deterministic field (latency
    # is wall clock and excluded — replay reproduces everything else)
    @staticmethod
    def trigger_key(tj: dict) -> str:
        return json.dumps({k: v for k, v in sorted(tj.items())
                           if k != "latency_s"}, sort_keys=True)

    def route_quarantine(self, frontier: int) -> int:
        """Route this beam's quality intervals (source ledger: ring
        drops, stalls, truncation, NaN scrub, zero runs; plus the
        mux's own straggler fills) into the engine's offregions.
        Returns newly quarantined spectra."""
        fresh = 0
        for q in (self.source.quality, self.quality):
            if q is None:
                continue
            for iv in q.intervals:
                key = (iv.start, iv.stop, iv.reason)
                if iv.start < frontier and key not in self._routed:
                    self._routed.add(key)
                    self.engine.note_quarantine(
                        iv.start, min(iv.stop, frontier))
                    fresh += min(iv.stop, frontier) - iv.start
        return fresh

    def health(self) -> dict:
        eng = self.engine.summary()
        return {
            "beam": self.beam_id,
            "state": self.state,
            "spectra": eng["spectra"],
            "blocks": self.ticks,
            "triggers": self.emitted,
            "vetoed": self.vetoed,
            "stalled_spectra": self.stalled_spectra,
            "dropped_spectra": self.dropped_spectra,
            "replayed": self.replayed,
            "handoff": self.handoff,
            "source": self.source.stats(),
            "quarantine": dict(self.source.quality.counts()
                               if self.source.quality else {},
                               **self.quality.counts()),
        }


# ----------------------------------------------------------------------
# The multiplexer
# ----------------------------------------------------------------------

class BeamMultiplexer:
    """N same-geometry beam feeds -> one stacked deadline-lane chain.

    An assembler thread aligns per-beam blocks into stacked tick
    bundles (QoS: stragglers degrade to quarantined gap fill after
    `qos_wait_s`, the tick is never stalled); a single outstanding
    deadline-lane tick job runs the stacked dedispersion step(s),
    feeds each beam's series slice to its own StreamSearch, applies
    the cross-beam coincidence veto, commits to the beam ledger and
    emits triggers.
    """

    def __init__(self, service, sources: List[RingBlockSource],
                 cfg: StreamConfig, mux_id: str = "beams-0",
                 beam_ids: Optional[List[str]] = None,
                 coincidence_k: int = 0, veto_window_s: float = 0.1,
                 dm_tol: Optional[float] = None,
                 stack: int = 0, qos_wait_s: float = 0.25,
                 fleet_dir: Optional[str] = None,
                 host: str = "replica-0", lease_ttl: float = 30.0,
                 heartbeat_ttl: float = 10.0, adopt: bool = False,
                 faults=None, device="cuda"):
        if not sources:
            raise ValueError("need at least one beam source")
        self.device = resolve_device(device)
        self.service = service
        self.sources = list(sources)
        self.cfg = cfg
        self.mux_id = mux_id
        self.beam_ids = (list(beam_ids) if beam_ids else
                         ["beam-%d" % i
                          for i in range(len(sources))])
        if len(self.beam_ids) != len(sources):
            raise ValueError("beam_ids/sources length mismatch")
        self.veto = CoincidenceVeto(coincidence_k, veto_window_s,
                                    dm_tol)
        self.stack = int(stack)
        self.qos_wait_s = float(qos_wait_s)
        self.fleet_dir = fleet_dir
        self.host = host
        self.lease_ttl = float(lease_ttl)
        self.heartbeat_ttl = float(heartbeat_ttl)
        self.adopt = adopt
        self.faults = faults
        self.obs = service.obs
        self.events = service.events
        self.lanes: List[BeamLane] = []
        self.groups: List[Tuple[StackedRollingDedisp,
                                List[int]]] = []
        self.ledger: Optional[BeamLedger] = None
        self.epoch = 0
        self.blocklen = 0
        #: stacked dedispersion steps issued (one a group a tick)
        self.dispatches = 0
        self._inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._tick_out = False
        self._tick_ids = itertools.count(1)
        self._threads: List[threading.Thread] = []
        self._done = threading.Event()
        self._failed: Optional[BaseException] = None
        reg = self.obs.metrics
        self._g_beams = reg.gauge(
            "stream_beams", "Live beams in the multiplexer")
        self._c_stalled = reg.counter(
            "stream_beam_stalled_total",
            "Spectra gap-filled for a straggler beam (quarantined)",
            ("beam",))
        self._c_dropped = reg.counter(
            "stream_beam_dropped_total",
            "Late straggler spectra discarded to stay wall-clock "
            "aligned", ("beam",))
        self._c_vetoed = reg.counter(
            "stream_beam_vetoed_total",
            "Triggers vetoed by cross-beam coincidence", ("beam",))
        self._c_handoffs = reg.counter(
            "stream_beam_handoffs_total",
            "Beams adopted from a dead replica via the beam ledger",
            ("beam",))
        self._c_trigs = reg.counter(
            "stream_triggers_total", "Deduplicated triggers emitted")
        self._c_blocks = reg.counter(
            "stream_blocks_total", "Live-feed blocks processed")
        self._h_latency = reg.histogram(
            "stream_latency_seconds",
            "Sample arrival -> trigger emitted", ("stream", "beam"),
            buckets=LATENCY_BUCKETS)

    # ---- chaos seam ---------------------------------------------------

    def _point(self, name: str) -> None:
        if self.faults is not None:
            self.faults.point(name)

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "BeamMultiplexer":
        t = threading.Thread(target=self._run,
                             name="presto-beams-assemble",
                             daemon=True)
        self._threads.append(t)
        t.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def failed(self) -> Optional[BaseException]:
        return self._failed

    # ---- setup (assembler thread) -------------------------------------

    def _resolve_stack(self, nbeams: int) -> int:
        """Beams a stacked step: the explicit ``stack``, else the tuning
        DB's ``beam_stack_size`` when tuning is active, else up to 64."""
        if self.stack > 0:
            return min(self.stack, nbeams)
        from presto_tpu_torch import tune
        if tune.enabled():
            best = tune.best("beam_stack_size", tune.GLOBAL_KEY,
                             obs=self.obs)
            if best and int(best.get("stack", 0)) > 0:
                return min(int(best["stack"]), nbeams)
        return min(nbeams, 64)

    def _setup(self) -> None:
        hdrs = [s.wait_header() for s in self.sources]
        for h in hdrs:
            if h is None:
                raise RuntimeError("a beam feed ended before its "
                                   "header")
            geom = (h.nchans, h.tsamp, h.nbits, h.fch1, h.foff)
            if geom != (hdrs[0].nchans, hdrs[0].tsamp,
                        hdrs[0].nbits, hdrs[0].fch1, hdrs[0].foff):
                raise ValueError(
                    "beam geometry mismatch: %r vs %r"
                    % (geom, (hdrs[0].nchans, hdrs[0].tsamp,
                              hdrs[0].nbits, hdrs[0].fch1,
                              hdrs[0].foff)))
        first = StreamSearch(hdrs[0], self.cfg, device=self.device)
        self.blocklen = first.blocklen
        engines = [first] + [
            StreamSearch(h, self.cfg, blocklen=self.blocklen,
                         device=self.device)
            for h in hdrs[1:]]
        self.lanes = [BeamLane(bid, src, eng)
                      for bid, src, eng in zip(self.beam_ids,
                                               self.sources,
                                               engines)]
        for src in self.sources:
            src.configure(self.blocklen)
        stack = self._resolve_stack(len(self.lanes))
        for lo in range(0, len(self.lanes), stack):
            idxs = list(range(lo, min(lo + stack,
                                      len(self.lanes))))
            self.groups.append((StackedRollingDedisp(
                first._chan_bins, first._dm_bins, self.cfg.nsub,
                self.cfg.downsamp, device=self.device), idxs))
        self._attach_ledger()
        self._g_beams.set(len(self.lanes))
        self.events.emit("beam-start", stream=self.mux_id,
                         nbeams=len(self.lanes),
                         blocklen=self.blocklen,
                         numdms=self.cfg.numdms,
                         stack=stack, groups=len(self.groups),
                         coincidence_k=self.veto.k, host=self.host)

    def _attach_ledger(self) -> None:
        if self.fleet_dir is None:
            return
        self.ledger = BeamLedger(self.fleet_dir, obs=self.obs)
        self.epoch = self.ledger.join(self.host)
        if self.adopt:
            self.ledger.reap(self.heartbeat_ttl)
        self.ledger.ensure_items(
            [(lane.beam_id, {"triggers": [], "frontier_s": 0.0,
                             "vetoed": 0})
             for lane in self.lanes], meta={"mux": self.mux_id})
        by_id = {lane.beam_id: lane for lane in self.lanes}
        while True:
            lease = self.ledger.lease(self.host, self.lease_ttl)
            if lease is None:
                break
            lane = by_id.get(lease.item_id)
            if lane is None:
                self.ledger.fail(lease, self.host)
                continue
            lane.lease = lease
            prior = lease.data.get("triggers") or []
            if prior or float(lease.data.get("frontier_s", 0.0)) > 0:
                # a predecessor replica got this far: replay and
                # suppress its committed set
                lane.handoff = True
                lane.committed = {BeamLane.trigger_key(tj)
                                  for tj in prior}
                self._c_handoffs.labels(beam=lane.beam_id).inc()
                self._point("beam-handoff")
                self.events.emit("beam-handoff",
                                 stream=self.mux_id,
                                 beam=lane.beam_id, host=self.host,
                                 committed=len(lane.committed),
                                 frontier_s=lease.data.get(
                                     "frontier_s", 0.0))
        unleased = [lane.beam_id for lane in self.lanes
                    if lane.lease is None]
        if unleased:
            raise BeamLedgerError(
                "beams %s are leased elsewhere or terminal"
                % ",".join(unleased))
        self.ledger.heartbeat(self.host, self.epoch)

    # ---- reader threads -----------------------------------------------

    #: reader-side inbox depth bound: past this the reader leaves
    #: blocks in the source ring (bounded, with explicit ring-drop
    #: accounting) instead of buffering unboundedly in the lane
    INBOX_DEPTH = 8

    def _read_loop(self, lane: BeamLane) -> None:
        try:
            while True:
                while self._failed is None:
                    with lane.lock:
                        depth = len(lane.inbox)
                    if depth < self.INBOX_DEPTH:
                        break
                    time.sleep(0.005)
                blk = lane.source.next_block(timeout=0.25)
                if blk is None:
                    if lane.source.at_eof:
                        break
                    continue
                with lane.lock:
                    lane.inbox.append(blk)
        except BaseException as e:
            self._failed = self._failed or e
        finally:
            lane.feed_eof = True

    # ---- assembler ----------------------------------------------------

    def _run(self) -> None:
        try:
            self._setup()
            for lane in self.lanes:
                t = threading.Thread(
                    target=self._read_loop, args=(lane,),
                    name="presto-beams-read-%s" % lane.beam_id,
                    daemon=True)
                self._threads.append(t)
                t.start()
            tick = 0
            # every lane needs its real blocks plus two flush pads
            # (the two zero blocks the independent finish() feeds);
            # pad_issued bounds the pipeline against the tick thread
            # lagging the assembler
            while any(lane.feed_state == BeamLane.LIVE
                      or lane.pad_issued < 2
                      for lane in self.lanes):
                bundle = self._assemble(tick)
                if bundle is None:        # reader failure
                    break
                self._enqueue(bundle)
                tick += 1
            if self._failed is None:
                self._enqueue(None)       # EOF sentinel
            else:
                self._done.set()
        except BaseException as e:
            self._failed = e
            self._done.set()

    def _assemble(self, tick: int) -> Optional[dict]:
        """Align every non-done lane's next block into one stacked
        tick.  A lane at feed EOF (or already flushing) contributes a
        zero pad block; a straggler past `qos_wait_s` degrades to a
        quarantined zero gap block (and its late block is discarded
        on arrival)."""
        nchan = self.lanes[0].engine.hdr.nchans
        deadline: Optional[float] = None
        while True:
            if self._failed is not None:
                return None
            waiting = False
            any_ready = False
            for lane in self.lanes:
                if lane.feed_state != BeamLane.LIVE:
                    continue
                with lane.lock:
                    has = bool(lane.inbox)
                if has or lane.feed_eof:
                    any_ready = True
                else:
                    waiting = True
            if not waiting:
                break
            now = time.time()
            if any_ready and deadline is None:
                deadline = now + self.qos_wait_s
            if deadline is not None and now >= deadline:
                break
            time.sleep(0.005)

        data = np.zeros((len(self.lanes), self.blocklen, nchan),
                        np.float32)
        nreal = [0] * len(self.lanes)
        arrivals = [time.time()] * len(self.lanes)
        synth = [False] * len(self.lanes)
        pads = [0] * len(self.lanes)      # 0 = live slice, n = nth pad
        for i, lane in enumerate(self.lanes):
            if lane.feed_state != BeamLane.LIVE:
                lane.pad_issued += 1      # flushing: zero pad
                pads[i] = lane.pad_issued
                continue
            blk = None
            with lane.lock:
                # a block older than this tick is a straggler whose
                # slot was already gap-filled: discard, stay aligned
                while lane.inbox and lane.inbox[0].seq < tick:
                    late = lane.inbox.popleft()
                    lane.dropped_spectra += late.nreal
                    self._c_dropped.labels(
                        beam=lane.beam_id).inc(late.nreal)
                    self.events.emit("beam-drop",
                                     stream=self.mux_id,
                                     beam=lane.beam_id,
                                     seq=late.seq,
                                     spectra=late.nreal)
                if lane.inbox:
                    blk = lane.inbox.popleft()
            if blk is not None:
                data[i] = blk.data
                nreal[i] = blk.nreal
                arrivals[i] = blk.t_arrival
            elif lane.feed_eof:
                # last real block consumed: this tick starts the
                # lane's two-block flush
                lane.feed_state = BeamLane.FLUSHING
                lane.pad_issued = 1
                pads[i] = 1
            else:
                # straggler: degrade to quarantined gap fill
                synth[i] = True
                lo = tick * self.blocklen
                lane.quality.add(lo, lo + self.blocklen, "stall")
                lane.stalled_spectra += self.blocklen
                self._c_stalled.labels(
                    beam=lane.beam_id).inc(self.blocklen)
                self.events.emit("beam-stall", stream=self.mux_id,
                                 beam=lane.beam_id, tick=tick,
                                 spectra=self.blocklen)
            lane.ticks = tick + 1
        return {"tick": tick, "data": data, "nreal": nreal,
                "arrivals": arrivals, "synth": synth, "pads": pads}

    # ---- deadline tick ------------------------------------------------

    #: assembler -> tick-thread bundle backlog bound: the assembler
    #: blocks here when the device chain lags (compile, slow tick), so
    #: backpressure reaches the source rings instead of heap bundles
    TICK_BACKLOG = 4

    def _enqueue(self, bundle: Optional[dict]) -> None:
        while bundle is not None:
            with self._inbox_lock:
                if len(self._inbox) < self.TICK_BACKLOG:
                    break
            if self._failed is not None or self._done.is_set():
                return
            time.sleep(0.005)
        with self._inbox_lock:
            self._inbox.append(bundle)
            if self._tick_out:
                return
            self._tick_out = True
        self.service.submit_callable(
            self._tick, lane="deadline",
            job_id="%s-tick-%06d" % (self.mux_id,
                                     next(self._tick_ids)),
            bucket=("stream", self.mux_id))

    def _tick(self, job) -> dict:
        """Drain the bundle backlog.  A tick that raises has already
        taken its bundle, so the stacked carry cannot go on: the
        failure ends the multiplexer (`failed`, `wait()`; the leases
        are left for another replica to reap), and the scheduler's
        retry of the job raises again instead of skipping a tick."""
        if self._failed is not None:
            raise RuntimeError("multiplexer %s ended by %s: %s" % (
                self.mux_id, type(self._failed).__name__,
                self._failed))
        try:
            return self._drain()
        except BaseException as e:
            self._failed = self._failed or e
            self._done.set()
            raise

    def _drain(self) -> dict:
        processed = 0
        emitted = 0
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    self._tick_out = False
                    break
                bundle = self._inbox.popleft()
            if bundle is None:
                emitted += self._finish()
                continue
            self._point("beam-tick")
            span = self.obs.span("stream:beam-tick",
                                 stream=self.mux_id,
                                 tick=bundle["tick"])
            try:
                emitted += self._process(bundle)
                processed += 1
            finally:
                span.finish()
        return {"stream": self.mux_id, "ticks": processed,
                "triggers": emitted}

    def _process(self, bundle: dict) -> int:
        tick = bundle["tick"]
        # ONE stacked dispatch chain per group, O(1) in beam count
        series_by_lane: Dict[int, Optional[np.ndarray]] = {}
        for rolling, idxs in self.groups:
            data = bundle["data"][idxs]
            out, dispatched = rolling.feed(data)
            if dispatched:
                costmodel.probe(self.obs, "beam_dedisp",
                                numdms=int(rolling._dm_bins.shape[0]),
                                nsub=rolling.nsub, nchan=data.shape[2],
                                numpts=data.shape[1], beams=len(idxs))
                devtel.note_dispatch(self.obs, "beam_dedisp", dispatched)
            self.dispatches += dispatched
            for j, i in enumerate(idxs):
                series_by_lane[i] = (out[j] if out is not None
                                     else None)
        self._c_blocks.inc()
        pending: List[Tuple[BeamLane, Trigger]] = []
        for i, lane in enumerate(self.lanes):
            if lane.state == BeamLane.DONE:
                continue
            frontier = (tick + 1) * self.blocklen
            lane.route_quarantine(frontier)
            series = series_by_lane.get(i)
            padn = bundle["pads"][i]
            if padn == 0:                 # live slice (real or synth)
                if bundle["nreal"][i]:
                    # stamped here (tick thread), not the assembler:
                    # trigger latency reads this and the assembler can
                    # run many bundles ahead
                    lane.last_t_arrival = bundle["arrivals"][i]
                trigs = lane.engine.feed_series(
                    series, bundle["nreal"][i])
            else:                         # assembler-issued flush pad
                lane.state = BeamLane.FLUSHING
                if series is not None and padn <= 2:
                    lane.flush_series.append(series)
                lane.flush_ticks += 1
                trigs = []
                if padn >= 2:
                    trigs = lane.engine.finish_series(
                        lane.flush_series)
                    lane.state = BeamLane.DONE
            pending.extend((lane, tr) for tr in trigs)
            if lane.state == BeamLane.DONE:
                self.events.emit("beam-eof", stream=self.mux_id,
                                 beam=lane.beam_id,
                                 **lane.engine.summary())
        live = sum(1 for lane in self.lanes
                   if lane.state != BeamLane.DONE)
        self._g_beams.set(live)
        return self._emit_pending(pending, final=(live == 0))

    def _frontier_s(self) -> float:
        fronts = [lane.engine._frontier_time()
                  for lane in self.lanes
                  if lane.state != BeamLane.DONE]
        return min(fronts) if fronts else float("inf")

    def _emit_pending(self,
                      pending: List[Tuple[BeamLane, Trigger]],
                      final: bool = False) -> int:
        """Veto -> ledger commit -> event emission, in that order:
        the ledger row is the authoritative emitted set, so a kill
        between commit and emission is recovered (never duplicated)
        by the successor's replay suppression."""
        now = time.time()
        if self.veto.enabled:
            for lane, tr in pending:
                self.veto.add(lane.beam_id, tr)
            ripe, vetoes = self.veto.drain(self._frontier_s(),
                                           final=final)
        else:
            ripe = [(lane.beam_id, tr) for lane, tr in pending]
            vetoes = []
        by_id = {lane.beam_id: lane for lane in self.lanes}
        veto_counts: Dict[str, int] = {}
        for v in vetoes:
            for beam in v.evidence:
                veto_counts[beam] = veto_counts.get(beam, 0) + 1
                by_id[beam].vetoed += 1
                self._c_vetoed.labels(beam=beam).inc()
        out: List[Tuple[BeamLane, Trigger, dict]] = []
        updates: Dict[str, dict] = {}
        for beam, tr in ripe:
            lane = by_id[beam]
            tr.latency_s = max(now - lane.last_t_arrival, 0.0)
            tj = tr.to_json()
            key = BeamLane.trigger_key(tj)
            if key in lane.committed:
                lane.replayed += 1        # predecessor emitted it
                continue
            lane.committed.add(key)
            out.append((lane, tr, tj))
            updates.setdefault(beam, {"triggers": [],
                                      "vetoed": 0})[
                "triggers"].append(
                {k: v for k, v in tj.items() if k != "latency_s"})
        for beam, n in veto_counts.items():
            updates.setdefault(beam, {"triggers": []})["vetoed"] = n
        self._point("beam-commit")
        self._commit(updates)
        for lane, tr, tj in out:
            lane.emitted += 1
            self._c_trigs.inc()
            self._h_latency.labels(stream=self.mux_id,
                                   beam=lane.beam_id).observe(
                tr.latency_s)
            self.events.emit("trigger", stream=self.mux_id,
                             beam=lane.beam_id, **tj)
        for v in vetoes:
            self.events.emit("beam-veto", stream=self.mux_id,
                             **v.to_json())
        return len(out)

    def _commit(self, updates: Dict[str, dict]) -> None:
        if self.ledger is None:
            return
        frontier = self._frontier_s()
        full: Dict[str, dict] = {}
        leases: Dict[str, object] = {}
        for lane in self.lanes:
            # a DONE lane still holds its lease until _finish
            # completes it — its flush-stage triggers commit here
            if lane.lease is None:
                continue
            up = dict(updates.get(lane.beam_id,
                                  {"triggers": [], "vetoed": 0}))
            up["frontier_s"] = (frontier
                                if np.isfinite(frontier) else 0.0)
            full[lane.beam_id] = up
            leases[lane.beam_id] = lane.lease
        if full:
            self.ledger.advance(leases, self.host, full,
                                self.lease_ttl)
        self.ledger.heartbeat(self.host, self.epoch)

    def _finish(self) -> int:
        # final veto drain (pending triggers whose window never
        # closed mid-stream) — all lanes are DONE by now
        ripe_pending: List[Tuple[BeamLane, Trigger]] = []
        n = self._emit_pending(ripe_pending, final=True)
        if self.ledger is not None:
            for lane in self.lanes:
                if lane.lease is None:
                    continue
                if lane.state == BeamLane.DONE:
                    self.ledger.complete(
                        lane.lease, self.host, {},
                        extra={"summary": lane.engine.summary()})
                else:                     # feed died: let another
                    self.ledger.fail(lane.lease, self.host)  # retry
                lane.lease = None
            self.ledger.tombstone(self.host)
        self.events.emit("stream-eof", stream=self.mux_id,
                         **self.summary_totals())
        workdir = getattr(self.service, "workroot", None)
        if workdir:
            try:
                self.write_health(os.path.join(workdir,
                                               "beams.json"))
            except OSError:
                pass
        self._done.set()
        return n

    # ---- views --------------------------------------------------------

    def summary_totals(self) -> dict:
        return {
            "beams": len(self.lanes),
            "triggers": sum(l.emitted for l in self.lanes),
            "vetoed": sum(l.vetoed for l in self.lanes),
            "stalled_spectra": sum(l.stalled_spectra
                                   for l in self.lanes),
            "dropped_spectra": sum(l.dropped_spectra
                                   for l in self.lanes),
            "replayed": sum(l.replayed for l in self.lanes),
            "handoffs": sum(1 for l in self.lanes if l.handoff),
            "dispatches": self.dispatches,
        }

    def summary(self) -> dict:
        out = {"stream": self.mux_id, "host": self.host}
        out.update(self.summary_totals())
        out["per_beam"] = [lane.health() for lane in self.lanes]
        lat = {}
        for lane in self.lanes:
            h = self._h_latency.labels(stream=self.mux_id,
                                       beam=lane.beam_id)
            if h.count:
                lat[lane.beam_id] = h.percentiles((50, 90, 99))
        out["latency"] = lat
        return out

    def write_health(self, path: str) -> None:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(path, json.dumps(
            self.summary(), indent=1, sort_keys=True) + "\n")


# ----------------------------------------------------------------------
# presto-beams CLI
# ----------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="presto-beams",
        description="Multiplex N same-geometry beam feeds into one "
                    "stacked real-time trigger chain")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-tails", type=str, nargs="+",
                     metavar="FILE.fil",
                     help="Tail these filterbank files, one beam "
                          "each (replayable: required for hand-off)")
    src.add_argument("-listen", type=str, metavar="HOST:PORT",
                     help="Accept -beams feeds on consecutive ports "
                          "starting here")
    p.add_argument("-beams", type=int, default=0,
                   help="Beam count for -listen mode")
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-dmstep", type=float, default=1.0)
    p.add_argument("-numdms", type=int, default=8)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-thresh", type=float, default=6.0)
    p.add_argument("-blocklen", type=int, default=0)
    p.add_argument("-ring", type=int, default=16)
    p.add_argument("-stall-timeout", dest="stall_timeout",
                   type=float, default=None)
    p.add_argument("-dedup", type=float, default=0.25)
    p.add_argument("-coincidence", type=int, default=0,
                   help="Veto triggers hitting >= K beams at the "
                        "same time/DM (0/1 = off)")
    p.add_argument("-veto-window", dest="veto_window", type=float,
                   default=0.1,
                   help="Coincidence clustering window (seconds)")
    p.add_argument("-dm-tol", dest="dm_tol", type=float,
                   default=None,
                   help="Also require |dDM| <= this to cluster "
                        "(default: any DM)")
    p.add_argument("-stack", type=int, default=0,
                   help="Beams per stacked device step (0 = "
                        "min(beams, 64))")
    p.add_argument("-qos-wait", dest="qos_wait", type=float,
                   default=0.25,
                   help="Seconds a tick waits for a straggler beam "
                        "before degrading it to gap fill")
    p.add_argument("-fleet", type=str, default=None,
                   help="Fleet directory holding the beam ledger "
                        "(enables lease/fence + hand-off)")
    p.add_argument("-host", type=str, default="replica-0",
                   help="Replica name in the beam ledger")
    p.add_argument("-adopt", action="store_true",
                   help="Reap dead replicas before leasing (the "
                        "successor side of a hand-off)")
    p.add_argument("-lease-ttl", dest="lease_ttl", type=float,
                   default=30.0)
    p.add_argument("-hb-ttl", dest="hb_ttl", type=float,
                   default=10.0)
    p.add_argument("-port", type=int, default=0,
                   help="Serve the HTTP API (/events, /metrics) "
                        "here (0 = off)")
    p.add_argument("-workdir", type=str, default="beams_work")
    p.add_argument("-events", type=str, default=None)
    p.add_argument("-heartbeat", type=float, default=2.0)
    p.add_argument("-json", dest="json_out", type=str, default=None)
    p.add_argument("-timeout", type=float, default=None)
    return p


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    from presto_tpu_torch.serve.server import SearchService, start_http
    cfg = StreamConfig(lodm=args.lodm, dmstep=args.dmstep,
                       numdms=args.numdms, nsub=args.nsub,
                       downsamp=args.downsamp, threshold=args.thresh,
                       blocklen=args.blocklen or None,
                       trigger_dedup_s=args.dedup,
                       ring_capacity=args.ring,
                       stall_timeout_s=args.stall_timeout)
    service = SearchService(args.workdir, events_path=args.events,
                            heartbeat_s=args.heartbeat)
    service.start()
    sources, producers = [], []
    if args.tails:
        for path in args.tails:
            src = RingBlockSource(capacity=cfg.ring_capacity,
                                  policy=cfg.ring_policy,
                                  stall_timeout_s=cfg.stall_timeout_s)
            sources.append(src)
            producers.append(FileTailProducer(src, path,
                                              idle_eof_s=1.0).start())
        print("presto-beams: tailing %d beams" % len(sources))
    else:
        if args.beams < 1:
            print("presto-beams: -listen needs -beams N",
                  file=sys.stderr)
            return 2
        host, _, port = args.listen.rpartition(":")
        for i in range(args.beams):
            src = RingBlockSource(capacity=cfg.ring_capacity,
                                  policy=cfg.ring_policy,
                                  stall_timeout_s=cfg.stall_timeout_s)
            sources.append(src)
            producers.append(SocketProducer(
                src, host or "127.0.0.1", int(port) + i).start())
        print("presto-beams: listening for %d beams on %s:%d.."
              % (args.beams, host or "127.0.0.1", int(port)))
    httpd = None
    if args.port:
        httpd = start_http(service, port=args.port)
        print("presto-beams: HTTP on http://%s:%d"
              % httpd.server_address[:2])
    mux = BeamMultiplexer(
        service, sources, cfg,
        coincidence_k=args.coincidence,
        veto_window_s=args.veto_window, dm_tol=args.dm_tol,
        stack=args.stack, qos_wait_s=args.qos_wait,
        fleet_dir=args.fleet, host=args.host, adopt=args.adopt,
        lease_ttl=args.lease_ttl,
        heartbeat_ttl=args.hb_ttl, device=device).start()
    ok = mux.wait(args.timeout)
    summary = mux.summary()
    summary["ok"] = bool(ok and mux.failed is None)
    if mux.failed is not None:
        summary["error"] = "%s: %s" % (type(mux.failed).__name__,
                                       mux.failed)
    print(json.dumps(summary, sort_keys=True))
    if args.json_out:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(args.json_out,
                          json.dumps(summary, indent=1,
                                     sort_keys=True) + "\n")
    for prod in producers:
        close = getattr(prod, "close", None)
        if close:
            close()
    if httpd is not None:
        httpd.shutdown()
    service.stop()
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
