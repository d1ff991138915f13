"""Structured JSON event log for the serving layer.

Host copy of ``presto_tpu/serve/events.py`` for the PyTorch port.

Every lifecycle transition a job makes (enqueue / schedule / compile /
execute / retry / degrade / complete / fail / timeout) emits one JSON
object, so a trace of the service is greppable the way the batch
driver's artifacts are replayable.  Events go to an in-memory ring
(the /events endpoint) and optionally to an append-only JSON-lines
file — one parseable line per event, never partial writes.

Trigger-consumer hardening: every event carries a monotonic `seq`
cursor, `since(cursor)` resumes a reconnecting subscriber from where
it dropped (reporting how many events aged out of the ring if it was
gone too long — lost triggers are *detected*, never silent), and an
optional heartbeat thread emits a periodic `heartbeat` event so a
subscriber can distinguish "no triggers" from "dead service".
"""

from __future__ import annotations

import json
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple


class EventLog:
    """Thread-safe event sink: bounded ring + optional file."""

    def __init__(self, path: Optional[str] = None, keep: int = 4096):
        self._lock = threading.Lock()  # presto-lint: guards(_ring, _counts, _seq, _fh)
        self._ring: deque = deque(maxlen=keep)
        self._counts: Counter = Counter()
        self._seq = 0
        self._path = path
        self._fh = open(path, "a") if path else None
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None

    def emit(self, kind: str, **fields) -> dict:
        """Record one event; returns the event dict (seq/ts stamped)."""
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "ts": time.time(), "kind": kind}
            ev.update(fields)
            self._ring.append(ev)
            self._counts[kind] += 1
            if self._fh is not None:
                self._fh.write(json.dumps(ev, sort_keys=True) + "\n")
                self._fh.flush()
        return ev

    def tail(self, n: int = 100) -> List[dict]:
        with self._lock:
            return list(self._ring)[-n:]

    def cursor(self) -> int:
        """The latest event's seq (0 before any event): poll /events
        once, remember the cursor, resume with since(cursor)."""
        with self._lock:
            return self._seq

    def since(self, cursor: int,
              limit: int = 1000) -> Tuple[List[dict], int, int]:
        """Events with seq > cursor (oldest first, up to `limit`).

        Returns (events, lost, latest): `lost` counts events that aged
        out of the bounded ring before this resume — zero means the
        subscriber rejoined without losing or duplicating anything;
        nonzero is an explicit gap signal (re-sync from artifacts), not
        a silent skip.  `latest` is the newest seq at read time (the
        next cursor even when `limit` truncates the answer)."""
        cursor = max(int(cursor), 0)
        with self._lock:
            latest = self._seq
            if not self._ring:
                return [], max(latest - cursor, 0), latest
            oldest = self._ring[0]["seq"]
            lost = max(min(oldest - 1, latest) - cursor, 0)
            out = [ev for ev in self._ring if ev["seq"] > cursor]
        return out[:limit], lost, latest

    # -- heartbeat ----------------------------------------------------
    def start_heartbeat(self, interval_s: float) -> None:
        """Emit a `heartbeat` event every interval_s seconds (daemon
        thread; idempotent) so /events subscribers can detect a dead
        service instead of mistaking it for a quiet one."""
        if interval_s <= 0 or self._hb_thread is not None:
            return
        self._hb_stop = threading.Event()
        stop = self._hb_stop

        def beat():
            while not stop.wait(interval_s):
                self.emit("heartbeat", interval_s=interval_s)

        self._hb_thread = threading.Thread(
            target=beat, name="presto-serve-heartbeat", daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        self._hb_stop = None
        self._hb_thread = None

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def close(self) -> None:
        self.stop_heartbeat()
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
