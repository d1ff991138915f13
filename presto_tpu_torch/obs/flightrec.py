"""Flight recorder: the last N seconds of telemetry, dumped on death.

Host copy of ``presto_tpu/obs/flightrec.py`` for the PyTorch port.

A bounded ring buffer collects recent telemetry records — finished
spans (wired in by ``Observability``), discrete events (chaos kill
points, scheduler transitions, log lines), whatever a component
chooses to note.  On an unhandled exception, a typed
``PrestoIOError``, or an injected chaos ``SimulatedCrash``, the ring
is dumped atomically (io/atomic.py — a crash during the dump cannot
leave a torn file) to ``<workdir>/flightrec-<ts>.json``, so every
post-mortem starts with what the process was actually doing when it
died instead of a bare traceback.

The dump carries three sections:

  * ``records``   — the ring, oldest first (events + finished spans);
  * ``open_spans``— spans started but unfinished at dump time (the
                    call stack of the death, in span form);
  * ``metrics``   — a registry snapshot, when one is attached.

Recording while disabled costs one branch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from presto_tpu_torch.io.atomic import atomic_write_text

DUMP_PREFIX = "flightrec-"


class FlightRecorder:
    """Thread-safe bounded telemetry ring + atomic post-mortem dump."""

    def __init__(self, capacity: int = 2048, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._seq = 0
        self._dumps = 0

    # -- recording ----------------------------------------------------
    def add(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": time.time(), "kind": kind}
            rec.update(fields)
            self._ring.append(rec)

    def note_span(self, span) -> None:
        """Tracer on_finish hook: finished spans enter the ring."""
        if not self.enabled:
            return
        self.add("span", name=span.name, span_id=span.span_id,
                 parent_id=span.parent_id, trace_id=span.trace_id,
                 duration_s=round(span.duration, 6),
                 status=span.status, thread=span.thread,
                 attrs=dict(span.attrs))

    # -- inspection ---------------------------------------------------
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def last(self, kind: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            ring = list(self._ring)
        for rec in reversed(ring):
            if kind is None or rec["kind"] == kind:
                return rec
        return None

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    # -- post-mortem --------------------------------------------------
    def dump(self, workdir: str, reason: str,
             open_spans: Optional[List] = None,
             metrics: Optional[dict] = None) -> Optional[str]:
        """Atomically write the ring to
        ``<workdir>/flightrec-<stamp>.json``; returns the path (None
        when disabled).  Never raises — a failing dump must not mask
        the exception that triggered it."""
        if not self.enabled:
            return None
        now = time.time()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
        path = os.path.join(
            workdir, "%s%s-%06d.json"
            % (DUMP_PREFIX, stamp, int((now % 1.0) * 1e6)))
        payload = {
            "version": 1,
            "reason": reason,
            "ts": now,
            "pid": os.getpid(),
            "records": self.records(),
            "open_spans": [s.to_json() for s in (open_spans or [])],
        }
        if metrics is not None:
            payload["metrics"] = metrics
        try:
            os.makedirs(workdir, exist_ok=True)
            atomic_write_text(path, json.dumps(payload, indent=1,
                                               sort_keys=True) + "\n")
        except OSError:
            return None
        with self._lock:
            self._dumps += 1
        return path


def find_dumps(workdir: str) -> List[str]:
    """All flight-recorder dumps in a workdir, oldest first."""
    try:
        names = os.listdir(workdir)
    except OSError:
        return []
    return sorted(os.path.join(workdir, n) for n in names
                  if n.startswith(DUMP_PREFIX) and n.endswith(".json"))
