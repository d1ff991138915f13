"""Per-stage wall-clock accounting for the survey driver and the apps.

Host copy of ``StageTimer``, ``app_timer`` and ``LatencyStats`` from
``presto_tpu/utils/timing.py`` for the PyTorch port.  StageTimer has no
telemetry hooks (spans, profiler traces); it also keeps every closed
interval per name in ``samples``, so a caller can read per-trial times
(e.g. the polish of each DM).  LatencyStats is a view over the obs
metrics registry (``latency_seconds{name=...}``), so the serve layer's
/metrics JSON and its Prometheus text read the same numbers.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class LatencyStats:
    """Per-name latency samples with percentile accounting — the
    serving layer's /metrics backbone.  Each name is one child of a
    shared registry histogram (`latency_seconds{name=...}`): lifetime
    count/sum plus a bounded window of recent samples for p50/p90/p99
    (nearest-rank, old samples age out).  Thread-safe: the service
    records from scheduler and HTTP threads.

    Pass `registry` (obs MetricsRegistry) to share the serve layer's
    registry; by default a private always-enabled registry backs the
    instance."""

    METRIC = "latency_seconds"

    def __init__(self, window: int = 2048, registry=None):
        if registry is None:
            from presto_tpu_torch.obs.metrics import MetricsRegistry
            registry = MetricsRegistry(enabled=True)
        self.registry = registry
        self._hist = registry.histogram(
            self.METRIC, "Recorded latency samples by name",
            ("name",), window=window)

    def record(self, name: str, seconds: float) -> None:
        self._hist.labels(name=name).observe(float(seconds))

    def percentiles(self, name: str,
                    qs=(50, 90, 99)) -> Dict[str, float]:
        """Nearest-rank percentiles over the sample window."""
        return self._hist.labels(name=name).percentiles(qs)

    def snapshot(self) -> Dict[str, dict]:
        """{name: {count, mean_s, p50_s, p90_s, p99_s, max_s}} for
        every recorded name (the /metrics `latency` block)."""
        out = {}
        for labels, child in self._hist.children():
            count = child.count
            xs = child.samples()
            if not count or not xs:
                continue
            pcts = child.percentiles()
            out[dict(labels)["name"]] = {
                "count": count,
                "mean_s": round(child.sum / count, 6),
                "p50_s": round(pcts["p50"], 6),
                "p90_s": round(pcts["p90"], 6),
                "p99_s": round(pcts["p99"], 6),
                "max_s": round(max(xs), 6),
            }
        return out


class StageTimer:
    """Accumulates named per-stage wall times; prints a summary table.
    ``mark`` closes the current stage and opens the next; ``stage`` is a
    context manager for a named interval inside one (reported under the
    stage that was open when it first ran).  With ``stats`` (a
    LatencyStats) every closed stage also records a latency sample (a
    resident service's per-stage percentiles); with ``obs`` (an enabled
    Observability) every ``mark``ed stage is a ``stage:<name>`` span and
    a ``survey_stage_seconds{stage=...}`` sample."""

    def __init__(self, stats: Optional[LatencyStats] = None, obs=None):
        self.stages: Dict[str, float] = {}
        self.samples: Dict[str, List[float]] = {}
        self._inner: Dict[str, Optional[str]] = {}
        self._t0 = time.time()
        self._cur: Optional[tuple] = None
        self._stats = stats
        self._obs = obs if (obs is not None
                            and getattr(obs, "enabled", False)) else None
        self._span = None

    def _close(self, name: str, dt: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self.samples.setdefault(name, []).append(dt)
        if self._stats is not None:
            self._stats.record(name, dt)
        if self._obs is not None:
            self._obs.metrics.histogram(
                "survey_stage_seconds", "Survey stage wall time",
                ("stage",)).labels(stage=name).observe(dt)

    def mark(self, name: Optional[str]) -> None:
        """Sequential accounting: close the current stage (if any) and
        open `name` (None = just close)."""
        now = time.time()
        if self._cur is not None:
            cname, t0 = self._cur
            self._close(cname, now - t0)
        if self._span is not None:
            self._span.finish()
            self._span = None
        self._cur = (name, now) if name else None
        if name and self._obs is not None:
            self._span = self._obs.span("stage:" + name, stage=name)

    @contextmanager
    def stage(self, name: str):
        self._inner.setdefault(name, self._cur[0] if self._cur else None)
        t0 = time.time()
        try:
            yield
        finally:
            self._close(name, time.time() - t0)

    def report(self, file=None) -> str:
        total = time.time() - self._t0
        lines = ["Per-stage wall times:"]

        def line(label, dt):
            lines.append("  %-24s %8.2f s  (%4.1f%%)"
                         % (label, dt, 100.0 * dt / max(total, 1e-9)))
        outer = [n for n in self.stages if n not in self._inner]
        for name in outer + [None]:
            if name is not None:
                line(name, self.stages[name])
            for inner, parent in self._inner.items():
                if parent == name or (name is None and parent not in outer):
                    line("  of which " + inner, self.stages[inner])
        lines.append("  %-24s %8.2f s" % ("TOTAL", total))
        text = "\n".join(lines)
        print(text, file=file or sys.stdout)
        return text


@contextmanager
def app_timer(prog: str):
    """Wrap an app main: on exit print the reference's closing block
    (user/system/total CPU + wall time, accelsearch.c:301-308)."""
    t0 = time.time()
    c0 = os.times()
    try:
        yield
    finally:
        wall = time.time() - t0
        c1 = os.times()
        print("%s: user %.1f s, system %.1f s, wall %.1f s"
              % (prog, c1.user - c0.user, c1.system - c0.system, wall))
