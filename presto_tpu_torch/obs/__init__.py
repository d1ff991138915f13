"""presto_tpu_torch.obs — unified tracing, metrics, and flight recorder.

Host copy of ``presto_tpu/obs/__init__.py`` (with obs/metrics.py,
obs/trace.py and obs/flightrec.py) for the PyTorch port: one metrics
registry, one structured tracer and one flight recorder, bundled by
:class:`Observability` so every subsystem threads a single handle.  The
dispatch telemetry (obs/devtel.py, the counterpart of the JAX package's
obs/jaxtel.py), the analytic kernel-cost book (obs/costmodel.py) and the
card's measured roofline (obs/roofline.py) hang off the same handle;
``flush`` writes the trace files and ``kernel_costs.json``.

Cost contract: everything is off-by-default-cheap.  A disabled
Observability answers every record call with one branch, and a survey
run without observability is byte-identical to an uninstrumented one
(no telemetry files are ever written while disabled).

Enabling it:

  * the serve layer is always observed (a resident service without
    /metrics is blind) — `SearchService` builds an enabled handle;
  * the live stream (stream/) reports through its service's handle;
  * the process default (:func:`get_obs`) is disabled until
    :func:`configure` replaces it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional

from presto_tpu_torch.obs.metrics import MetricsRegistry
from presto_tpu_torch.obs.flightrec import FlightRecorder, find_dumps
from presto_tpu_torch.obs.trace import (NOOP_SPAN, SpanContext, Tracer,
                                  chrome_trace, write_chrome_trace)

__all__ = [
    "ObsConfig", "Observability", "get_obs", "configure",
    "resolve_obs", "MetricsRegistry", "Tracer", "SpanContext",
    "FlightRecorder", "find_dumps", "chrome_trace",
    "write_chrome_trace", "NOOP_SPAN",
]

@dataclass
class ObsConfig:
    """Observability knobs (wire-safe: plain values only)."""
    enabled: bool = False
    #: directory for spans.jsonl + trace.perfetto.json; None defers to
    #: the survey workdir (flush(default_dir=...)) or disables export
    trace_dir: Optional[str] = None
    #: flight-recorder ring capacity (records)
    flightrec_capacity: int = 2048
    #: logical service name stamped on dumps/reports
    service: str = "presto_tpu_torch"


class Observability:
    """One handle bundling registry + tracer + flight recorder."""

    def __init__(self, cfg: Optional[ObsConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg or ObsConfig()
        self.enabled = bool(self.cfg.enabled)
        self.metrics = registry if registry is not None else \
            MetricsRegistry(enabled=self.enabled)
        self.flightrec = FlightRecorder(
            capacity=self.cfg.flightrec_capacity,
            enabled=self.enabled)
        jsonl = (os.path.join(self.cfg.trace_dir, "spans.jsonl")
                 if self.cfg.trace_dir else None)
        self.tracer = Tracer(enabled=self.enabled, jsonl_path=jsonl,
                             on_finish=self.flightrec.note_span)

    # -- convenience fronts -------------------------------------------
    def span(self, name: str, parent=None, **attrs):
        """Start a span (no-op singleton when disabled)."""
        if not self.enabled:
            return NOOP_SPAN
        return self.tracer.span(name, parent=parent, **attrs)

    def event(self, kind: str, **fields) -> None:
        """Record a discrete event into the flight recorder."""
        if not self.enabled:
            return
        self.flightrec.add(kind, **fields)

    def dump_flight(self, workdir: str, reason: str) -> Optional[str]:
        """Post-mortem: dump ring + open spans + metrics snapshot.
        Never raises."""
        if not self.enabled:
            return None
        try:
            path = self.flightrec.dump(
                workdir, reason,
                open_spans=self.tracer.open_spans(),
                metrics=self.metrics.snapshot())
        except Exception:
            return None
        if path is not None:
            self.metrics.counter(
                "flightrec_dumps_total",
                "Flight-recorder post-mortem dumps",
                ("reason",)).labels(reason=reason).inc()
        return path

    def flush(self, default_dir: Optional[str] = None) -> None:
        """Export buffered spans as a Perfetto/Chrome trace into
        cfg.trace_dir (or `default_dir`), then the kernel-cost book as
        kernel_costs.json.  Safe to call repeatedly; a failed trace
        export is dropped, a failed cost-book write raises."""
        if not self.enabled:
            return
        d = self.cfg.trace_dir or default_dir
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            spans = self.tracer.finished()
            if spans:
                write_chrome_trace(
                    os.path.join(d, "trace.perfetto.json"), spans)
                if self.tracer._jsonl_path is None:
                    # no streaming sink configured: snapshot the span
                    # buffer so presto-report still has spans.jsonl
                    import json as _json
                    from presto_tpu_torch.io.atomic import atomic_write_text
                    atomic_write_text(
                        os.path.join(d, "spans.jsonl"),
                        "".join(_json.dumps(s.to_json(),
                                            sort_keys=True) + "\n"
                                for s in spans))
        except Exception:
            pass
        # the kernel-cost book -> kernel_costs.json (no-op when nothing
        # was probed; runs no device work)
        from presto_tpu_torch.obs import costmodel
        costmodel.write_costs(self, d)


# ----------------------------------------------------------------------
# process-wide default handle
# ----------------------------------------------------------------------

_default: Optional[Observability] = None
_default_lock = threading.Lock()


def get_obs() -> Observability:
    """The process default Observability (disabled until configure()
    replaces it)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Observability(ObsConfig())
    return _default


def configure(cfg: ObsConfig) -> Observability:
    """Replace the process default (tests, app entry points)."""
    global _default
    with _default_lock:
        _default = Observability(cfg)
    return _default


def resolve_obs(obj) -> Observability:
    """Normalize a SurveyConfig-style ``obs`` field: None -> the
    process default, ObsConfig -> a fresh handle, Observability ->
    itself."""
    if obj is None:
        return get_obs()
    if isinstance(obj, Observability):
        return obj
    if isinstance(obj, ObsConfig):
        return Observability(obj)
    raise TypeError("obs must be ObsConfig or Observability, not %r"
                    % type(obj).__name__)
