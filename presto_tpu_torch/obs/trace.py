"""Structured tracing: nested spans with contextvar propagation.

Host copy of ``presto_tpu/obs/trace.py`` for the PyTorch port.

A span is one timed operation with a name, attributes, and an
identity (trace_id / span_id / parent_id).  The current span rides a
``contextvars.ContextVar``, so nesting is automatic within a thread:
a serve job's root span threads through scheduler -> plan cache ->
search kernels, and a survey run's spans nest stage -> chunk -> op
without any explicit plumbing.

Threads do NOT inherit context; code that fans work out to workers
captures ``tracer.context()`` (a SpanContext) and passes it as the
``parent=`` of spans started on the worker — the same shape OpenTelemetry
uses for cross-thread propagation.

Finished spans are buffered (bounded), optionally streamed to a JSONL
file (one span per line, append-only), and exportable as Chrome/
Perfetto ``trace_event`` JSON (``write_chrome_trace``), viewable beside
a ``torch.profiler`` trace of the card in the same viewer.

A disabled tracer costs one branch: ``span()`` returns a shared no-op
singleton and records nothing.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

from presto_tpu_torch.io.atomic import atomic_write_text


def _new_id(nhex: int) -> str:
    return uuid.uuid4().hex[:nhex]


class SpanContext:
    """Portable span identity for cross-thread / cross-process
    parenting.  `to_dict`/`from_dict` are the wire form the fleet
    uses to propagate the context through ledger JSON: the router
    stamps it onto the admitted job row, the leasing replica resumes
    it as the explicit `parent=` of the job's root span, so one
    discovery DAG renders as ONE trace even when every node ran on a
    different replica."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d) -> "Optional[SpanContext]":
        """None for anything that is not a usable wire context (a
        row without a trace field, a disabled-tracer stamp)."""
        if not isinstance(d, dict) or not d.get("trace_id"):
            return None
        return cls(str(d["trace_id"]), str(d.get("span_id") or ""))

    def __repr__(self):
        return "SpanContext(%s, %s)" % (self.trace_id, self.span_id)


class Span:
    """One live (or finished) span.  Usable as a context manager or
    finished manually with .finish()."""

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.start = time.time()
        self.end = 0.0
        self.status = "ok"
        self.thread = threading.current_thread().name
        self._token: Optional[contextvars.Token] = None

    @property
    def duration(self) -> float:
        return (self.end or time.time()) - self.start

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def finish(self, status: str = "ok") -> None:
        self._tracer._finish(self, status)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb) -> None:
        self.finish("error: %s" % etype.__name__ if etype else "ok")

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration, 6),
            "status": self.status,
            "thread": self.thread,
            "pid": os.getpid(),
            "attrs": self.attrs,
        }


class _NoopSpan:
    """Shared do-nothing span for the disabled path (one allocation,
    ever)."""

    name = ""
    trace_id = span_id = parent_id = None
    attrs: Dict = {}
    status = "ok"
    duration = 0.0

    def set_attr(self, key, value):
        return self

    def context(self):
        return None

    def finish(self, status: str = "ok"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + finished-span buffer + optional JSONL sink."""

    def __init__(self, enabled: bool = True, keep: int = 8192,
                 jsonl_path: Optional[str] = None, on_finish=None):
        self.enabled = enabled
        self._cv: contextvars.ContextVar = contextvars.ContextVar(
            "presto_tpu_torch_span", default=None)
        self._lock = threading.Lock()  # presto-lint: guards(_finished, _open, _jsonl_fh)
        self._finished: deque = deque(maxlen=keep)
        self._open: Dict[str, Span] = {}
        self._on_finish = on_finish
        self._jsonl_path = jsonl_path
        self._jsonl_fh = None

    # -- span lifecycle -----------------------------------------------
    def span(self, name: str, parent=None, current: bool = True,
             **attrs):
        """Start a span (sets it current for this context unless
        ``current=False`` — sibling spans opened in bulk, e.g. the
        per-job spans of a stacked batch, must not nest into each
        other).  `parent` may be a Span or SpanContext for explicit
        (e.g. cross-thread or cross-process) parenting; default is
        the context's current span."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = self._cv.get()
        if parent is None:
            trace_id, parent_id = _new_id(32), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        sp = Span(self, name, trace_id, _new_id(16), parent_id, attrs)
        if current:
            sp._token = self._cv.set(sp)
        with self._lock:
            self._open[sp.span_id] = sp
        return sp

    def _finish(self, span: Span, status: str) -> None:
        if span.end:                     # idempotent double-finish
            return
        span.end = time.time()
        span.status = status
        if span._token is not None:
            try:
                self._cv.reset(span._token)
            except ValueError:
                # finished from a different context (cross-thread
                # hand-off); current-span restoration is moot there
                pass
            span._token = None
        with self._lock:
            self._open.pop(span.span_id, None)
            self._finished.append(span)
            fh = self._ensure_jsonl()
            if fh is not None:
                fh.write(json.dumps(span.to_json(), sort_keys=True)
                         + "\n")
                fh.flush()
        if self._on_finish is not None:
            self._on_finish(span)

    # -- context ------------------------------------------------------
    def current(self) -> Optional[Span]:
        return self._cv.get()

    def context(self) -> Optional[SpanContext]:
        """Capture the current span's identity for another thread."""
        sp = self._cv.get()
        return None if sp is None else sp.context()

    # -- inspection / export ------------------------------------------
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def open_spans(self) -> List[Span]:
        """Started-but-unfinished spans (what a flight-recorder dump
        wants to show about the moment of death)."""
        with self._lock:
            return sorted(self._open.values(), key=lambda s: s.start)

    def attach_jsonl(self, path: str) -> bool:
        """Late-bind a JSONL streaming sink (the fleet replica wires
        its spans into `<fleet>/obs/<replica>.spans.jsonl` here).
        A sink configured at construction (e.g. `-tracedir`) wins —
        returns False and leaves it untouched."""
        if not self.enabled:
            return False
        with self._lock:
            if self._jsonl_path is not None:
                return False
            self._jsonl_path = path
            return True

    def _ensure_jsonl(self):  # presto-lint: holds(_lock)
        if self._jsonl_path is None:
            return None
        if self._jsonl_fh is None:
            d = os.path.dirname(os.path.abspath(self._jsonl_path))
            os.makedirs(d, exist_ok=True)
            self._jsonl_fh = open(self._jsonl_path, "a")
        return self._jsonl_fh

    def close(self) -> None:
        with self._lock:
            if self._jsonl_fh is not None:
                self._jsonl_fh.close()
                self._jsonl_fh = None


# ----------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ----------------------------------------------------------------------

def chrome_trace(spans: List[Span]) -> dict:
    """Spans -> Chrome ``trace_event`` JSON (complete 'X' events),
    loadable in Perfetto / chrome://tracing."""
    tids: Dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        events.append({
            "name": s.name,
            "cat": "presto_tpu_torch",
            "ph": "X",
            "ts": s.start * 1e6,
            "dur": max(s.end - s.start, 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": tid,
            "args": dict(s.attrs, trace_id=s.trace_id,
                         span_id=s.span_id,
                         parent_id=s.parent_id or "",
                         status=s.status),
        })
    events += [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                "tid": tid, "args": {"name": tname}}
               for tname, tid in tids.items()]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Span]) -> str:
    atomic_write_text(path, json.dumps(chrome_trace(spans)) + "\n")
    return path
