"""On-card measurement harness (tune layer).

PyTorch counterpart of ``presto_tpu/tune/runner.py``.  Timing a
candidate honestly means separating its first call from steady state,
waiting for the card's work, and surviving candidates that are very
slow or do not fit:

  * the first ``warmup`` calls of a candidate are excluded from the
    statistic (they pay kernel-library loads and allocator growth) and
    booked through obs/devtel (``jax_compiles_total{kind=
    "tune:<family>"}``);
  * steady reps are median-of-k, each timed with CUDA events around the
    call on a card (``torch.cuda.Event``; the host clock with a CPU
    device or a caller's ``timer``);
  * a candidate whose first steady rep is ``prune_factor`` slower than
    the best-so-far median is PRUNED;
  * a candidate past ``timeout_s`` of accumulated wall time stops and
    keeps the reps it has;
  * a candidate that raises ``torch.cuda.OutOfMemoryError`` is
    QUARANTINED (status "oom") and the sweep goes on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def _is_oom(exc: BaseException) -> bool:
    return (isinstance(exc, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(exc).lower())


@dataclass
class Measurement:
    """One candidate's timing verdict."""
    config: dict
    status: str                       # ok | pruned | timeout | oom | error
    median_s: Optional[float] = None
    compile_s: Optional[float] = None
    reps: int = 0
    samples: List[float] = field(default_factory=list)
    error: str = ""

    @property
    def usable(self) -> bool:
        return self.median_s is not None and self.status in (
            "ok", "pruned", "timeout")


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class TuneRunner:
    """Sweep a family's candidates over one shape and pick the
    fastest.  ``device`` (default "cuda"; a CPU device must be asked
    for) decides the clock: CUDA events on a card, the host clock on
    the CPU; a ``timer`` (seconds) replaces both."""

    def __init__(self, k: int = 5, warmup: int = 1,
                 timeout_s: float = 30.0, prune_factor: float = 3.0,
                 timer: Optional[Callable[[], float]] = None, obs=None,
                 device="cuda"):
        from presto_tpu_torch.search.accel import resolve_device
        if obs is None:
            from presto_tpu_torch.obs import get_obs
            obs = get_obs()
        self.device = resolve_device(device)
        self.k = max(1, int(k))
        self.warmup = max(0, int(warmup))
        self.timeout_s = float(timeout_s)
        self.prune_factor = float(prune_factor)
        self.timer = timer
        self.clock = timer or time.perf_counter
        self.obs = obs

    def _timed(self, fn) -> float:
        """Seconds of one fn() call, its device work included."""
        if self.timer is None and self.device.type == "cuda":
            with torch.cuda.device(self.device):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                fn()
                t1.record()
                t1.synchronize()
                return t0.elapsed_time(t1) * 1e-3
        t0 = self.clock()
        fn()
        return self.clock() - t0

    # -- one candidate -------------------------------------------------

    def measure(self, fn: Callable[[], object], config: dict,
                family: str = "?",
                best_so_far: Optional[float] = None) -> Measurement:
        """Time one candidate's bench callable (``fn`` runs its device
        work)."""
        m = Measurement(config=dict(config), status="ok")
        sp = self.obs.span("tune:candidate", family=family,
                           config=repr(config))
        budget0 = self.clock()
        try:
            for _ in range(self.warmup):
                m.compile_s = self._timed(fn)
        except (KeyboardInterrupt, SystemExit):
            sp.finish("error: interrupted")
            raise
        except BaseException as e:
            m.status = "oom" if _is_oom(e) else "error"
            m.error = "%s: %s" % (type(e).__name__, e)
            self._count_candidate(family, m.status)
            sp.finish("error: %s" % m.status)
            return m
        if m.compile_s is not None:
            from presto_tpu_torch.obs import devtel
            devtel.note_compile(self.obs, kind="tune:%s" % family,
                                seconds=m.compile_s)
        try:
            for rep in range(self.k):
                m.samples.append(self._timed(fn))
                m.reps += 1
                if (best_so_far is not None and rep == 0
                        and m.samples[0] > self.prune_factor * best_so_far):
                    m.status = "pruned"
                    break
                if self.clock() - budget0 > self.timeout_s:
                    m.status = "timeout"
                    break
        except (KeyboardInterrupt, SystemExit):
            sp.finish("error: interrupted")
            raise
        except BaseException as e:
            if not m.samples:
                m.status = "oom" if _is_oom(e) else "error"
                m.error = "%s: %s" % (type(e).__name__, e)
                self._count_candidate(family, m.status)
                sp.finish("error: %s" % m.status)
                return m
            m.status = "error"
            m.error = "%s: %s" % (type(e).__name__, e)
        if m.samples:
            m.median_s = _median(m.samples)
        self._count_candidate(family, m.status)
        sp.finish()
        return m

    # -- one (family, shape) sweep -------------------------------------

    def sweep(self, family: str, shape_key: str,
              candidates: Sequence[Tuple[dict, Callable[[], object]]],
              ) -> Tuple[Optional[Measurement], List[Measurement]]:
        """Measure every (config, bench) candidate; returns (winner,
        all measurements).  The winner is the usable candidate with the
        lowest median; None when nothing ran."""
        sp = self.obs.span("tune:sweep", family=family,
                           shape=shape_key, n=len(candidates))
        t0 = time.time()
        results: List[Measurement] = []
        best: Optional[Measurement] = None
        for config, fn in candidates:
            m = self.measure(fn, config, family=family,
                             best_so_far=best.median_s
                             if best is not None else None)
            results.append(m)
            if m.usable and (best is None or m.median_s < best.median_s):
                best = m
        if self.obs.enabled:
            self.obs.metrics.histogram(
                "tune_sweep_seconds",
                "Wall time of one (family, shape) tuning sweep",
                ("family",)).labels(family=family).observe(
                    time.time() - t0)
        sp.finish()
        return best, results

    def _count_candidate(self, family: str, status: str) -> None:
        if not self.obs.enabled:
            return
        reg = self.obs.metrics
        reg.counter("tune_candidates_total",
                    "Tuning candidates measured",
                    ("family",)).labels(family=family).inc()
        if status == "pruned":
            reg.counter("tune_candidates_pruned_total",
                        "Tuning candidates stopped early (too slow)",
                        ("family",)).labels(family=family).inc()
        elif status == "oom":
            reg.counter("tune_candidates_quarantined_total",
                        "Tuning candidates quarantined (OOM)",
                        ("family",)).labels(family=family).inc()
