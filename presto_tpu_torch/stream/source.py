"""Bounded ring-buffer block source for live beam feeds.

Host copy of ``presto_tpu/stream/source.py`` for the PyTorch port, over
the port's io/sigproc decoder and io/quality ledger.

The streaming analog of io/sigproc.FilterbankFile: a producer thread
(socket receiver or file tailer) parses a standard SIGPROC filterbank
header off the wire, decodes packed spectra with the SAME decode
sequence the file reader uses (io/sigproc.decode_spectra_block), and
assembles them into fixed-length channel-ascending blocks in a bounded
ring.  The consumer (stream/rolling.py via stream/service.py) pops
blocks with the same [blocklen, nchan] float32 contract
FilterbankFile.stream_blocks delivers — the reader seam is unchanged,
only the bytes now arrive over time instead of at rest.

Because a live feed cannot be paused, overload and damage become
explicit, *accounted* states instead of crashes:

  * backpressure — the ring is bounded; when the consumer falls
    behind, the oldest undelivered block is shed ("drop-oldest": the
    newest data is the data a trigger search needs) and the gap is
    zero-filled and quarantined as "ring-drop" in a
    io/quality.DataQualityReport, so every dropped spectrum is
    visible in both the quality ledger and the drop counters — zero
    *unaccounted* drops, ever.
  * producer stalls — when no bytes arrive for `stall_timeout_s`
    while mid-stream, zero-fill spectra are inserted to hold the
    real-time cadence and quarantined as "stall"; when the feed
    resumes, an equal number of (now stale) spectra are discarded to
    re-synchronize the stream position with the wall clock.
  * truncation — a connection dying mid-spectrum quarantines the
    partial spectrum as "truncated" and zero-pads it, exactly like
    the file reader's short-read handling.

EOF (producer close) is a normal event: the final partial block is
zero-padded without quarantine, mirroring read_spectra's EOF padding.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from presto_tpu_torch.io.quality import (DataQualityReport,
                                         record_zero_runs, scrub_nonfinite)
from presto_tpu_torch.io.sigproc import (FilterbankHeader,
                                         decode_spectra_block,
                                         read_filterbank_header)


@dataclass
class StreamBlock:
    """One ring slot: a fixed-length block of decoded spectra."""
    seq: int                    # block index in the stream (0-based)
    start: int                  # absolute first spectrum index
    data: np.ndarray            # [blocklen, nchan] float32 ascending
    nreal: int                  # spectra actually received (rest pad)
    t_arrival: float            # wall clock when the block completed
    quarantined: List = field(default_factory=list)  # BadInterval-ish


class RingBlockSource:
    """Bounded producer/consumer ring of decoded spectra blocks.

    Lifecycle: a producer calls set_header() once, then push_spectra()
    repeatedly and eof() at stream end; the consumer calls
    wait_header(), configure(blocklen) (the block geometry depends on
    the DM plan, which needs the header), then next_block() until
    at_eof.  push_spectra blocks until configure() runs — the
    producer cannot outpace the handshake.
    """

    def __init__(self, capacity: int = 16,
                 policy: str = "drop-oldest",
                 stall_timeout_s: Optional[float] = None):
        if policy not in ("drop-oldest", "block"):
            raise ValueError("policy must be drop-oldest|block")
        self.capacity = int(capacity)
        self.policy = policy
        self.stall_timeout_s = stall_timeout_s
        self.header: Optional[FilterbankHeader] = None
        self.blocklen: Optional[int] = None
        self.quality: Optional[DataQualityReport] = None
        self._lock = threading.Lock()
        self._have_header = threading.Event()
        self._configured = threading.Event()
        self._cond = threading.Condition(self._lock)
        self._ring: deque = deque()
        self._partial: Optional[np.ndarray] = None   # [<blocklen, C]
        self._partial_fill = 0
        self._pushed = 0            # spectra accepted from producer
        self._delivered_start = 0   # next spectrum index the consumer
                                    # expects (gap => synthesized)
        self._seq = 0               # blocks completed by the producer
        self._next_seq = 0          # next seq the consumer expects
        self._dropped_blocks = 0
        self._dropped_spectra = 0
        self._stall_spectra = 0
        self._stall_debt = 0        # stale spectra owed after a stall
        self._eof = False
        self._error: Optional[BaseException] = None

    # ---- producer side ----------------------------------------------

    def set_header(self, hdr: FilterbankHeader) -> None:
        self.header = hdr
        self.quality = DataQualityReport(path="<stream>",
                                         nchan=hdr.nchans)
        self._have_header.set()

    def configure(self, blocklen: int) -> None:
        """Fix the block geometry (consumer side, after planning)."""
        if blocklen < 1:
            raise ValueError("blocklen must be >= 1")
        self.blocklen = int(blocklen)
        self._configured.set()

    def push_spectra(self, arr: np.ndarray,
                     quarantine: Optional[str] = None) -> None:
        """Append decoded spectra [n, nchan]; assembles full blocks
        into the ring.  `quarantine` marks the whole span as a bad
        interval of that reason (stall fill, ring-drop synthesis).
        Scrubs NaN/Inf and records zero runs like the file reader."""
        self._configured.wait()
        arr = np.asarray(arr, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.header.nchans:
            raise ValueError("push_spectra expects [n, nchan]")
        with self._lock:
            start = self._pushed
            if quarantine is not None:
                self.quality.add(start, start + len(arr), quarantine)
            else:
                arr = scrub_nonfinite(arr, start, self.quality)
                record_zero_runs(arr, start, self.quality)
            self._pushed += len(arr)
            self.quality.nspectra = self._pushed
            off = 0
            while off < len(arr):
                if self._partial is None:
                    self._partial = np.zeros(
                        (self.blocklen, self.header.nchans),
                        np.float32)
                    self._partial_fill = 0
                take = min(self.blocklen - self._partial_fill,
                           len(arr) - off)
                self._partial[self._partial_fill:
                              self._partial_fill + take] = \
                    arr[off:off + take]
                self._partial_fill += take
                off += take
                if self._partial_fill == self.blocklen:
                    self._commit_block_locked(self.blocklen)

    def _commit_block_locked(self, nreal: int) -> None:
        blk = StreamBlock(
            seq=self._seq,
            start=self._seq * self.blocklen,
            data=self._partial, nreal=nreal,
            t_arrival=time.time())
        self._partial = None
        self._partial_fill = 0
        self._seq += 1
        while len(self._ring) >= self.capacity:
            if self.policy == "block":
                self._cond.wait()
                continue
            shed = self._ring.popleft()
            self._dropped_blocks += 1
            self._dropped_spectra += shed.nreal
            self.quality.add(shed.start, shed.start + self.blocklen,
                             "ring-drop")
        self._ring.append(blk)
        self._cond.notify_all()

    def note_stall_fill(self, n: int) -> None:
        """Producer inserted `n` zero-fill spectra to hold cadence
        through a stall: count them and remember the debt so the SAME
        producer's late data is discarded on resume.  The debt lives
        on the source — with many feeds in one process, one stalled
        beam must never re-sync the wall clock (drop spectra) for
        healthy feeds."""
        with self._lock:
            self._stall_spectra += n
            self._stall_debt += n

    def settle_stall_debt(self, navail: int) -> int:
        """How many of `navail` just-arrived spectra are stale (their
        slots were already zero-filled during this source's stall) and
        must be discarded; decrements the debt by that amount."""
        with self._lock:
            drop = min(self._stall_debt, int(navail))
            self._stall_debt -= drop
            return drop

    def eof(self) -> None:
        """Producer is done: flush the partial block (zero-padded, the
        normal EOF pad — not quarantined) and wake the consumer."""
        with self._lock:
            if self._partial is not None and self._partial_fill:
                self._commit_block_locked(self._partial_fill)
            self._eof = True
            self._cond.notify_all()
        self._have_header.set()     # unblock a header-less consumer
        self._configured.set()

    def fail(self, exc: BaseException) -> None:
        """Producer died un-cleanly; the consumer re-raises."""
        with self._lock:
            self._error = exc
            self._eof = True
            self._cond.notify_all()
        self._have_header.set()
        self._configured.set()

    # ---- consumer side ----------------------------------------------

    def wait_header(self, timeout: Optional[float] = None) \
            -> Optional[FilterbankHeader]:
        self._have_header.wait(timeout)
        if self._error is not None:
            raise self._error
        return self.header

    def next_block(self,
                   timeout: Optional[float] = None
                   ) -> Optional[StreamBlock]:
        """Pop the next block in stream order, synthesizing zero-filled
        quarantined blocks for any ring-drop gap so the consumer's
        two-block dedispersion carry never sees a discontinuity.
        Returns None when nothing is available within `timeout` — check
        `at_eof` to distinguish starvation from end of stream."""
        with self._cond:
            while not self._ring and not self._eof:
                if not self._cond.wait(timeout):
                    return None
            if self._error is not None:
                raise self._error
            if not self._ring:
                return None                       # EOF and drained
            head = self._ring[0]
            if head.seq > self._next_seq:
                # the gap a shed block left: deliver zeros in its
                # place (the quality ledger already recorded it)
                blk = StreamBlock(
                    seq=self._next_seq,
                    start=self._next_seq * self.blocklen,
                    data=np.zeros((self.blocklen,
                                   self.header.nchans), np.float32),
                    nreal=0, t_arrival=head.t_arrival,
                    quarantined=[("ring-drop",
                                  self._next_seq * self.blocklen,
                                  (self._next_seq + 1)
                                  * self.blocklen)])
                self._next_seq += 1
                return blk
            self._ring.popleft()
            self._cond.notify_all()
            self._next_seq = head.seq + 1
            return head

    @property
    def at_eof(self) -> bool:
        with self._lock:
            return self._eof and not self._ring

    @property
    def backlog(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return {
                "pushed_spectra": self._pushed,
                "dropped_blocks": self._dropped_blocks,
                "dropped_spectra": self._dropped_spectra,
                "stall_spectra": self._stall_spectra,
                "stall_debt": self._stall_debt,
                "backlog_blocks": len(self._ring),
                "eof": self._eof,
            }


# ----------------------------------------------------------------------
# Producers
# ----------------------------------------------------------------------

class _SpectraDecoder:
    """Incremental packed-bytes -> spectra decoder: holds the partial
    trailing spectrum between reads (a socket delivers bytes, not
    spectrum-aligned records)."""

    def __init__(self, hdr: FilterbankHeader):
        self.hdr = hdr
        self.bps = hdr.bytes_per_spectrum
        self._buf = b""

    def feed(self, data: bytes) -> np.ndarray:
        buf = self._buf + data
        nspec = len(buf) // self.bps
        self._buf = buf[nspec * self.bps:]
        if nspec == 0:
            return np.zeros((0, self.hdr.nchans), np.float32)
        raw = np.frombuffer(buf[:nspec * self.bps], dtype=np.uint8)
        return decode_spectra_block(self.hdr, raw, nspec)

    @property
    def partial_bytes(self) -> int:
        return len(self._buf)


class _SockFile:
    """Minimal file-face over a connected socket.

    read(n) is exact-n (loops recv; what the header parser needs);
    read1(n) is one recv — whatever is available, None on a read
    timeout (how feed_stream tells a stall from EOF's b"")."""

    def __init__(self, conn: socket.socket):
        self._sock = conn
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        bufs, got = [], 0
        while got < n:
            chunk = self._sock.recv(n - got)
            if not chunk:
                break
            bufs.append(chunk)
            got += len(chunk)
        self._pos += got
        return b"".join(bufs)

    def read1(self, n: int) -> Optional[bytes]:
        try:
            data = self._sock.recv(n)
        except (socket.timeout, TimeoutError):
            return None
        self._pos += len(data)
        return data

    def tell(self) -> int:
        return self._pos

    def seek(self, *a):
        raise OSError("socket streams are not seekable")


def feed_stream(source: RingBlockSource, fileobj,
                read_size: int = 1 << 16,
                faults: Optional[Callable] = None) -> None:
    """Drive a RingBlockSource from any binary stream (socket adapter,
    pipe, file): parse the SIGPROC header, then decode and push
    spectra until EOF.  A trailing partial spectrum is quarantined as
    "truncated" and zero-padded — a producer dying mid-spectrum must
    not lose the spectra before it.

    A None read (only the socket adapter produces one, on its read
    timeout) is a producer stall: zero fill is inserted to hold the
    real-time cadence, quarantined as "stall", and the equal count of
    late spectra is discarded when the feed resumes so the stream
    position stays aligned with the wall clock.  The debt is tracked
    PER SOURCE (RingBlockSource.note_stall_fill / settle_stall_debt),
    never in shared state: one stalled feed re-syncing the clock for
    every healthy feed in the process would skew their gap synthesis.

    `faults` is the chaos seam (testing/chaos.StreamFaults): called as
    faults(spectra_so_far) before every read; it may sleep (stall),
    raise, or close the stream underneath us.
    """
    try:
        hdr = read_filterbank_header(fileobj, "<stream>")
        source.set_header(hdr)
        dec = _SpectraDecoder(hdr)
        reader = (fileobj.read1 if hasattr(fileobj, "read1")
                  else fileobj.read)
        pushed = 0
        while True:
            if faults is not None:
                faults(pushed)
            try:
                data = reader(read_size)
            except (socket.timeout, TimeoutError):
                data = None
            if data is None:
                if source.stall_timeout_s is None:
                    break
                n = max(int(source.stall_timeout_s
                            / max(hdr.tsamp, 1e-9)), 1)
                source.push_spectra(
                    np.zeros((n, hdr.nchans), np.float32),
                    quarantine="stall")
                source.note_stall_fill(n)
                pushed += n
                continue
            if not data:
                break
            spectra = dec.feed(data)
            if len(spectra):
                drop = source.settle_stall_debt(len(spectra))
                if drop:
                    spectra = spectra[drop:]
            if len(spectra):
                source.push_spectra(spectra)
                pushed += len(spectra)
        if dec.partial_bytes:
            # mid-spectrum truncation: quarantine + zero-pad one
            # spectrum so the stream position stays spectrum-aligned
            source.push_spectra(
                np.zeros((1, hdr.nchans), np.float32),
                quarantine="truncated")
        source.eof()
    except BaseException as e:
        source.fail(e)
        raise


class SocketProducer:
    """Listen for ONE live feed connection and pump it into a source.

    Binds host:port (port=0 picks a free one, the test/loadgen
    pattern), accepts a single producer, and runs feed_stream on a
    daemon thread.  `stall_timeout_s` on the source doubles as the
    socket read timeout that makes stall detection possible.
    """

    def __init__(self, source: RingBlockSource,
                 host: str = "127.0.0.1", port: int = 0):
        self.source = source
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()[:2]
        self._thread = threading.Thread(
            target=self._run, name="presto-stream-recv", daemon=True)

    def start(self) -> "SocketProducer":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            conn, _ = self._srv.accept()
        except OSError:
            self.source.eof()
            return
        try:
            if self.source.stall_timeout_s is not None:
                conn.settimeout(self.source.stall_timeout_s)
            feed_stream(self.source, _SockFile(conn))
        except BaseException:
            pass                        # source.fail already recorded
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self._srv.close()

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)


class FileTailProducer:
    """Tail a (possibly still growing) filterbank file into a source.

    Reads whatever exists, then polls for growth every `poll_s`; ends
    the stream after `idle_eof_s` seconds without growth (None = only
    stop() ends it).  The offline replay / "file-at-rest as a feed"
    producer, and the zero-dependency path for tests.
    """

    def __init__(self, source: RingBlockSource, path: str,
                 poll_s: float = 0.05,
                 idle_eof_s: Optional[float] = 0.5,
                 faults: Optional[Callable] = None):
        self.source = source
        self.path = path
        self.poll_s = poll_s
        self.idle_eof_s = idle_eof_s
        self.faults = faults
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="presto-stream-tail", daemon=True)

    def start(self) -> "FileTailProducer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def _run(self) -> None:
        try:
            with open(self.path, "rb") as f:
                hdr = read_filterbank_header(f, self.path)
                self.source.set_header(hdr)
                dec = _SpectraDecoder(hdr)
                idle = 0.0
                pushed = 0
                while not self._stop.is_set():
                    if self.faults is not None:
                        self.faults(pushed)
                    data = f.read(1 << 16)
                    if data:
                        idle = 0.0
                        spectra = dec.feed(data)
                        if len(spectra):
                            self.source.push_spectra(spectra)
                            pushed += len(spectra)
                        continue
                    if self.idle_eof_s is not None \
                            and idle >= self.idle_eof_s:
                        break
                    time.sleep(self.poll_s)
                    idle += self.poll_s
                if dec.partial_bytes:
                    self.source.push_spectra(
                        np.zeros((1, hdr.nchans), np.float32),
                        quarantine="truncated")
            self.source.eof()
        except BaseException as e:
            self.source.fail(e)
