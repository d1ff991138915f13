"""Process-wide metrics registry (obs layer).

Host copy of ``presto_tpu/obs/metrics.py`` for the PyTorch port: the
same instruments, the same Prometheus text for the same operations.

One vocabulary for every counter the system keeps: the serve layer's
job/queue accounting, the live stream's counters and latency
histograms and the ingest quality tallies all register
Counter/Gauge/Histogram instruments here instead of growing private
int fields.  The registry renders two ways:

  * Prometheus text exposition (``render_prometheus``) — what a
    scrape of ``GET /metrics`` with ``Accept: text/plain`` returns;
  * a JSON snapshot (``snapshot``) — the machine-readable twin used
    by ``presto-report`` and tests.

Thread-safety is per-child: instruments take one small lock around a
few arithmetic ops, never around user code, so recording from the
scheduler thread, HTTP handler threads, and the survey driver at once
is safe.  Disabled registries cost one branch per record call — a
survey run without observability must be indistinguishable from an
uninstrumented one.

Histograms keep classic cumulative le-buckets for exposition *and* a
bounded window of recent raw samples for nearest-rank percentiles —
the same formula ``utils/timing.LatencyStats`` has always used, which
is now a thin view over these histograms (one source of truth).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

#: default latency buckets (seconds) — wide enough for both a single
#: kernel launch and a full multi-DM survey stage
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                   math.inf)

#: default per-histogram-child sample window for percentiles
DEFAULT_WINDOW = 2048


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as integers."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return "%d" % int(f)
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _label_suffix(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in labels)


class _Child:
    """One (metric, label-values) time series."""

    def __init__(self, family: "_Family",
                 labels: Tuple[Tuple[str, str], ...]):
        self._family = family
        self._labels = labels
        self._lock = threading.Lock()


class CounterChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._family.registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._family.registry.enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._family.registry.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_max(self, value: float) -> None:
        """High-water-mark update (live-buffer peaks etc.)."""
        if not self._family.registry.enabled:
            return
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramChild(_Child):
    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._count = 0
        self._sum = 0.0
        self._bucket_counts = [0] * len(family.buckets)
        self._window: deque = deque(maxlen=family.window)

    def observe(self, value: float) -> None:
        if not self._family.registry.enabled:
            return
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            for i, ub in enumerate(self._family.buckets):
                if v <= ub:
                    self._bucket_counts[i] += 1
                    break
            self._window.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def samples(self) -> List[float]:
        """The current percentile window (recent raw samples)."""
        with self._lock:
            return list(self._window)

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Nearest-rank percentiles over the sample window — the exact
        formula LatencyStats has always reported."""
        xs = sorted(self.samples())
        if not xs:
            return {"p%d" % q: 0.0 for q in qs}
        n = len(xs)
        return {"p%d" % q:
                xs[min(n - 1, max(0, (n * q + 99) // 100 - 1))]
                for q in qs}

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        with self._lock:
            counts = list(self._bucket_counts)
        out, acc = [], 0
        for ub, c in zip(self._family.buckets, counts):
            acc += c
            out.append((ub, acc))
        return out


class _Family:
    """A named metric plus its per-label-value children."""

    kind = "untyped"
    child_cls = _Child

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str, labelnames: Tuple[str, ...]):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()  # presto-lint: guards(_children)
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}
        if not self.labelnames:
            self._default = self._make_child(())
        else:
            self._default = None

    def _make_child(self, labels):  # presto-lint: holds(_lock)
        child = self.child_cls(self, labels)
        self._children[labels] = child
        return child

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                "%s expects labels %r, got %r"
                % (self.name, self.labelnames, tuple(kv)))
        key = tuple((k, str(kv[k])) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(key)
            return child

    def children(self) -> List[Tuple[Tuple[Tuple[str, str], ...],
                                     _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # label-less convenience: the family proxies its single child
    def _solo(self) -> _Child:
        if self._default is None:
            raise ValueError("%s has labels %r; use .labels()"
                             % (self.name, self.labelnames))
        return self._default


class CounterFamily(_Family):
    kind = "counter"
    child_cls = CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    @property
    def value(self) -> float:
        return self._solo().value

    def total(self) -> float:
        """Sum over every label combination."""
        return sum(c.value for _, c in self.children())


class GaugeFamily(_Family):
    kind = "gauge"
    child_cls = GaugeChild

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set_max(self, value: float) -> None:
        self._solo().set_max(value)

    @property
    def value(self) -> float:
        return self._solo().value


class HistogramFamily(_Family):
    kind = "histogram"
    child_cls = HistogramChild

    def __init__(self, registry, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS, window=DEFAULT_WINDOW):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        self.window = int(window)
        super().__init__(registry, name, help, labelnames)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self._solo().percentiles(qs)


class MetricsRegistry:
    """Get-or-create instrument registry.

    Re-registering a name returns the existing family (so independent
    components sharing a registry converge on one time series), but a
    kind or label mismatch is a programming error and raises.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()  # presto-lint: guards(_families)
        self._families: "Dict[str, _Family]" = {}

    # -- registration -------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r already registered as %s%r"
                        % (name, fam.kind, fam.labelnames))
                return fam
            fam = cls(self, name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help,
                                   tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help,
                                   tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets=DEFAULT_BUCKETS,
                  window: int = DEFAULT_WINDOW) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help,
                                   tuple(labelnames), buckets=buckets,
                                   window=window)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- exposition ---------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append("# HELP %s %s"
                             % (fam.name, fam.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (fam.name, fam.kind))
            for labels, child in fam.children():
                if isinstance(child, HistogramChild):
                    for ub, acc in child.cumulative_buckets():
                        ls = labels + (("le", _fmt(ub)),)
                        lines.append("%s_bucket%s %s"
                                     % (fam.name, _label_suffix(ls),
                                        _fmt(acc)))
                    lines.append("%s_sum%s %s"
                                 % (fam.name, _label_suffix(labels),
                                    _fmt(child.sum)))
                    lines.append("%s_count%s %s"
                                 % (fam.name, _label_suffix(labels),
                                    _fmt(child.count)))
                else:
                    lines.append("%s%s %s"
                                 % (fam.name, _label_suffix(labels),
                                    _fmt(child.value)))
        return "\n".join(lines) + "\n"

    def export_state(self) -> Dict[str, dict]:
        """Full, *mergeable* registry state (the fleet-aggregation
        wire format, obs/fleetagg.py).  Unlike `snapshot`, histograms
        carry their raw bucket counts AND the percentile sample
        window, so N replicas' exports can be bucket-merged into one
        fleet-wide histogram whose nearest-rank percentiles equal a
        single shared registry's.  `inf` bucket bounds are encoded as
        None (strict-JSON safe)."""
        fams: Dict[str, dict] = {}
        for fam in self.families():
            series = []
            for labels, child in fam.children():
                entry: dict = {"labels": dict(labels)}
                if isinstance(child, HistogramChild):
                    with child._lock:
                        entry.update({
                            "count": child._count,
                            "sum": child._sum,
                            "bucket_counts": list(
                                child._bucket_counts),
                            "samples": list(child._window),
                        })
                else:
                    entry["value"] = child.value
                series.append(entry)
            ent = {"kind": fam.kind, "help": fam.help,
                   "labelnames": list(fam.labelnames),
                   "series": series}
            if isinstance(fam, HistogramFamily):
                ent["buckets"] = [None if b == math.inf else b
                                  for b in fam.buckets]
                ent["window"] = fam.window
            fams[fam.name] = ent
        return {"families": fams}

    def snapshot(self) -> Dict[str, dict]:
        """JSON twin of the exposition (presto-report, tests)."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            series = []
            for labels, child in fam.children():
                entry: dict = {"labels": dict(labels)}
                if isinstance(child, HistogramChild):
                    pcts = child.percentiles()
                    entry.update({
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "p50": round(pcts["p50"], 6),
                        "p90": round(pcts["p90"], 6),
                        "p99": round(pcts["p99"], 6),
                    })
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out
