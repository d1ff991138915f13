"""presto-stream: the live FRB/single-pulse trigger service.

The port of ``presto_tpu/stream/service.py`` on the port's serve core
(serve/server.SearchService): run as ``python -m
presto_tpu_torch.stream.service``.  The device work runs on the card
unless the caller passes device="cpu" (``main(argv, device="cpu")``).

Glues the streaming stack to the serving layer so one resident
process carries BOTH workload classes: batch survey jobs ride the
serve scheduler's throughput lane exactly as before, while the live
feed's blocks are processed by *deadline-lane* tick jobs that always
pop first — a queued backlog of surveys can no longer starve the
trigger path (serve/queue.Lanes; there is no preemption, so the
deadline SLO floor is the longest single survey stage).

Data path:  producer (socket / file tail)  ->  RingBlockSource
(bounded, drop-accounted, quarantine via io/quality)  ->  StreamSearch
(rolling dedispersion + incremental single-pulse search)  ->  triggers
on serve's /events feed (monotonic cursor, heartbeat — a dropped
subscriber resumes with ?since=<cursor> losing nothing).

Every trigger observes `stream_latency_seconds`: wall time from the
arrival of the block that *enabled* the trigger (the newest samples
its finalization needed, queue wait included) to the event emission —
the end-to-end number a trigger's consumer waits on.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import threading
import time
from collections import deque
from typing import List, Optional

from presto_tpu_torch.search.accel import resolve_device
from presto_tpu_torch.stream.rolling import StreamConfig, StreamSearch
from presto_tpu_torch.stream.source import (FileTailProducer,
                                            RingBlockSource,
                                            SocketProducer, StreamBlock)

#: stream_latency_seconds buckets: trigger paths live in the
#: 10ms..10s decades, not the default request-latency spread
LATENCY_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0)


class StreamService:
    """One live feed attached to a SearchService.

    A pump thread moves blocks from the ring into an inbox and keeps
    at most ONE deadline-lane tick job outstanding; the tick (on the
    scheduler thread, where all device work lives) drains the inbox,
    runs the rolling search, and emits triggers.  The single
    outstanding tick is what lets force-submission bypass the queue
    depth bound without unbounded growth.
    """

    def __init__(self, service, source: RingBlockSource,
                 cfg: StreamConfig, stream_id: str = "stream-0",
                 device="cuda"):
        self.device = resolve_device(device)
        self.service = service
        self.source = source
        self.cfg = cfg
        self.stream_id = stream_id
        self.obs = service.obs
        self.events = service.events
        self.engine: Optional[StreamSearch] = None
        self._inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._tick_out = False          # a tick job is outstanding
        self._tick_ids = itertools.count(1)
        self._pump: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._failed: Optional[BaseException] = None
        self._quar_seen = 0             # quality spectra already routed
        self._drops_seen = 0
        self._cands_seen = 0
        self._routed: set = set()       # quarantine intervals routed
        reg = self.obs.metrics
        self._c_blocks = reg.counter(
            "stream_blocks_total", "Live-feed blocks processed")
        self._c_cands = reg.counter(
            "stream_candidates_total",
            "Finalized single-pulse candidates (pre-dedup)")
        self._c_trigs = reg.counter(
            "stream_triggers_total", "Deduplicated triggers emitted")
        self._c_drops = reg.counter(
            "stream_drops_total",
            "Blocks shed under ring backpressure (all quarantined)")
        self._c_gap = reg.counter(
            "stream_gap_spectra_total",
            "Spectra quarantined on the live feed (drops, stalls, "
            "truncation, zero fill)")
        self._g_backlog = reg.gauge(
            "stream_backlog_blocks", "Ring blocks awaiting the search")
        # `beam` label: "-" for a single-beam stream; the beam
        # multiplexer (stream/beams.py) shares this family with one
        # series per beam so latency is attributable per beam
        self._h_latency = reg.histogram(
            "stream_latency_seconds",
            "Sample arrival -> trigger emitted", ("stream", "beam"),
            buckets=LATENCY_BUCKETS)

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "StreamService":
        self._pump = threading.Thread(
            target=self._pump_loop, name="presto-stream-pump",
            daemon=True)
        self._pump.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the stream is fully processed (EOF + flush)."""
        return self._done.wait(timeout)

    @property
    def failed(self) -> Optional[BaseException]:
        return self._failed

    # ---- pump thread --------------------------------------------------

    def _pump_loop(self) -> None:
        try:
            hdr = self.source.wait_header()
            if hdr is None:             # producer died before header
                raise RuntimeError("stream ended before a header")
            self.engine = StreamSearch(hdr, self.cfg, obs=self.obs,
                                       device=self.device)
            self.source.configure(self.engine.blocklen)
            self.events.emit(
                "stream-start", stream=self.stream_id,
                nchan=hdr.nchans, tsamp=hdr.tsamp,
                blocklen=self.engine.blocklen,
                numdms=self.cfg.numdms, maxd=self.engine.maxd)
            while self._failed is None:
                blk = self.source.next_block(timeout=0.25)
                self._g_backlog.set(self.source.backlog)
                if blk is None:
                    if self.source.at_eof:
                        break
                    continue
                self._enqueue(blk)
            if self._failed is None:
                self._enqueue(None)     # EOF sentinel
        except BaseException as e:
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        """End the stream visibly: the first failure is kept, the pump
        stops, and wait() returns with `failed` set."""
        if self._failed is None:
            self._failed = exc
            self.events.emit("stream-fail", stream=self.stream_id,
                             error="%s: %s" % (type(exc).__name__, exc))
        self._done.set()

    def _enqueue(self, item: Optional[StreamBlock]) -> None:
        with self._inbox_lock:
            self._inbox.append(item)
            if self._tick_out:
                return
            self._tick_out = True
        self.service.submit_callable(
            self._tick, lane="deadline",
            job_id="%s-tick-%06d" % (self.stream_id,
                                     next(self._tick_ids)),
            bucket=("stream", self.stream_id))

    # ---- tick (scheduler thread) --------------------------------------

    def _tick(self, job) -> dict:
        """Drain the inbox: all pending blocks (and possibly the EOF
        flush) in one deadline-lane execution.

        A tick that raises has already taken its block from the inbox,
        so the carry cannot go on: the failure ends the stream
        (`failed`, `wait()`), and the scheduler's retry of the job
        raises again instead of pairing the next block with a stale
        carry."""
        if self._failed is not None:
            raise RuntimeError("stream %s ended by %s: %s" % (
                self.stream_id, type(self._failed).__name__,
                self._failed))
        try:
            return self._drain()
        except BaseException as e:
            self._fail(e)
            raise

    def _drain(self) -> dict:
        processed = 0
        triggers = 0
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    # clearing the flag under the same lock _enqueue
                    # takes closes the strand race: a block arriving
                    # after release sees _tick_out False and submits
                    self._tick_out = False
                    break
                item = self._inbox.popleft()
            if item is None:
                triggers += self._finish()
                continue
            span = self.obs.span("stream:block", stream=self.stream_id,
                                 seq=item.seq)
            try:
                self._route_quarantine(item)
                trigs = self.engine.feed_block(item.data, item.nreal)
                self._c_blocks.inc()
                processed += 1
                triggers += self._emit(trigs, item.t_arrival)
            finally:
                span.finish()
        return {"stream": self.stream_id, "blocks": processed,
                "triggers": triggers}

    def _route_quarantine(self, blk: StreamBlock) -> None:
        """Ring drops arrive as synthesized zero blocks carrying their
        interval; everything else (stall fill, truncation, NaN scrub,
        zero runs) lands in the source's quality ledger — route both
        into the engine's offregions and the stream counters."""
        for reason, lo, hi in blk.quarantined:
            self.engine.note_quarantine(lo, hi)
        stats = self.source.stats()
        if stats["dropped_blocks"] > self._drops_seen:
            delta = stats["dropped_blocks"] - self._drops_seen
            self._drops_seen = stats["dropped_blocks"]
            self._c_drops.inc(delta)
            self.events.emit("stream-drop", stream=self.stream_id,
                             blocks=delta,
                             total=stats["dropped_blocks"])
        q = self.source.quality
        if q is None:
            return
        frontier = (blk.seq + 1) * self.engine.blocklen
        fresh = {}
        for iv in q.intervals:
            key = (iv.start, iv.stop, iv.reason)
            if iv.start < frontier and key not in self._routed:
                self._routed.add(key)
                self.engine.note_quarantine(iv.start,
                                            min(iv.stop, frontier))
                fresh[iv.reason] = fresh.get(iv.reason, 0) \
                    + min(iv.stop, frontier) - iv.start
        bad = q.bad_spectra()
        if bad > self._quar_seen:
            self._c_gap.inc(bad - self._quar_seen)
            self._quar_seen = bad
        if fresh:
            self.events.emit("stream-quarantine",
                             stream=self.stream_id, intervals=fresh)

    def _emit(self, trigs: List, t_arrival: float) -> int:
        now = time.time()
        for tr in trigs:
            tr.latency_s = max(now - t_arrival, 0.0)
            self._h_latency.labels(stream=self.stream_id,
                                   beam="-").observe(tr.latency_s)
            self._c_trigs.inc()
            self.events.emit("trigger", stream=self.stream_id,
                             **tr.to_json())
        new = self.engine.candidates - self._cands_seen
        if new > 0:
            self._c_cands.inc(new)
            self._cands_seen = self.engine.candidates
        return len(trigs)

    def _finish(self) -> int:
        t_eof = time.time()
        trigs = self.engine.finish()
        n = self._emit(trigs, t_eof)
        self.events.emit("stream-eof", stream=self.stream_id,
                         **self.engine.summary())
        self._done.set()
        return n

    # ---- views --------------------------------------------------------

    def summary(self) -> dict:
        out = {
            "stream": self.stream_id,
            "source": self.source.stats(),
        }
        if self.engine is not None:
            out["engine"] = self.engine.summary()
            out["latency"] = self._h_latency.labels(
                stream=self.stream_id,
                beam="-").percentiles((50, 90, 99))
        return out


# ----------------------------------------------------------------------
# presto-stream CLI
# ----------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="presto-stream",
        description="Real-time streaming single-pulse trigger service")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-listen", type=str, metavar="HOST:PORT",
                     help="Accept one live filterbank feed here "
                          "(SIGPROC header + packed spectra)")
    src.add_argument("-tail", type=str, metavar="FILE.fil",
                     help="Tail a (possibly growing) filterbank file")
    p.add_argument("-lodm", type=float, default=0.0)
    p.add_argument("-dmstep", type=float, default=1.0)
    p.add_argument("-numdms", type=int, default=8)
    p.add_argument("-nsub", type=int, default=32)
    p.add_argument("-downsamp", type=int, default=1)
    p.add_argument("-thresh", type=float, default=6.0,
                   help="Trigger threshold (sigma)")
    p.add_argument("-blocklen", type=int, default=0,
                   help="Ring block length in spectra (0 = auto)")
    p.add_argument("-ring", type=int, default=16,
                   help="Ring capacity in blocks (drop-oldest beyond)")
    p.add_argument("-stall-timeout", dest="stall_timeout", type=float,
                   default=None,
                   help="Seconds without bytes before zero fill is "
                        "inserted (quarantined) to hold cadence")
    p.add_argument("-dedup", type=float, default=0.25,
                   help="Trigger dedup window in seconds")
    p.add_argument("-port", type=int, default=0,
                   help="Also serve the HTTP API (/events, /metrics) "
                        "on this port (0 = off)")
    p.add_argument("-workdir", type=str, default="stream_work")
    p.add_argument("-events", type=str, default=None,
                   help="Append structured JSON events to this file")
    p.add_argument("-heartbeat", type=float, default=2.0,
                   help="Heartbeat event cadence on /events (0 = off)")
    p.add_argument("-json", dest="json_out", type=str, default=None,
                   help="Write the run summary JSON here")
    p.add_argument("-timeout", type=float, default=None,
                   help="Give up after this many seconds")
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
    source = RingBlockSource(capacity=cfg.ring_capacity,
                             policy=cfg.ring_policy,
                             stall_timeout_s=cfg.stall_timeout_s)
    if args.listen:
        host, _, port = args.listen.rpartition(":")
        producer = SocketProducer(source, host or "127.0.0.1",
                                  int(port)).start()
        print("presto-stream: listening for a feed on %s:%d"
              % producer.address)
    else:
        producer = FileTailProducer(source, args.tail,
                                    idle_eof_s=1.0).start()
        print("presto-stream: tailing %s" % args.tail)
    httpd = None
    if args.port:
        httpd = start_http(service, port=args.port)
        print("presto-stream: HTTP on http://%s:%d (/events, /metrics)"
              % httpd.server_address[:2])
    stream = StreamService(service, source, cfg,
                           device=device).start()
    ok = stream.wait(args.timeout)
    summary = stream.summary()
    summary["ok"] = bool(ok and stream.failed is None)
    if stream.failed is not None:
        summary["error"] = "%s: %s" % (type(stream.failed).__name__,
                                       stream.failed)
    print(json.dumps(summary, sort_keys=True))
    if args.json_out:
        from presto_tpu_torch.io.atomic import atomic_write_text
        atomic_write_text(args.json_out,
                          json.dumps(summary, indent=1,
                                     sort_keys=True) + "\n")
    if httpd is not None:
        httpd.shutdown()
    service.stop()
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
