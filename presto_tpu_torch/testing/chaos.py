"""Fault injection for the survey's and the elastic layer's kill points.

Host copy of the parts of ``presto_tpu/testing/chaos.py`` the port's
survey and elastic runs use: the survey calls
``cfg.fault_injector.point("stage-name")`` at stage and chunk
boundaries, and the elastic loop at its shard points; a scheduled
FaultInjector raises SimulatedCrash there (or exits the process, or
stalls it).  Tests catch the crash, run again and hold the resumed run's
artifacts to an uninterrupted run's bytes.  SimulatedCrash derives from
BaseException, so recovery code that catches Exception cannot swallow
an injected kill.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional


class SimulatedCrash(BaseException):
    """Injected process death at a named kill point."""

    def __init__(self, point: str):
        self.point = point
        super().__init__("simulated crash at kill point %r" % point)


class FaultInjector:
    """Fires once at the Nth matching kill point.

    Parameters
    ----------
    kill_at : substring a point name must contain to count (None
        matches every point).
    kill_after : fire on the Nth matching call (1-based) — so a
        multi-process test can kill the Nth barrier/shard rather than
        the first.  `kill_after_n` is an accepted alias.
    mode : "raise" raises SimulatedCrash (in-process tests);
        "exit" calls os._exit(EXIT_CODE), a real kill, for runs in
        subprocesses;
        "stall" sleeps `stall_seconds` at the point — a member stuck
        in a collective (or wedged on IO) rather than dead, the case
        barrier timeouts and lease expiry must bound.
    """

    EXIT_CODE = 43

    def __init__(self, kill_at: Optional[str] = None,
                 kill_after: int = 1, mode: str = "raise",
                 kill_after_n: Optional[int] = None,
                 stall_seconds: float = 3600.0):
        if mode not in ("raise", "exit", "stall", "off"):
            raise ValueError("mode must be raise|exit|stall|off")
        if kill_after_n is not None:
            kill_after = kill_after_n
        self.kill_at = kill_at
        self.kill_after = max(1, int(kill_after))
        self.mode = mode
        self.stall_seconds = float(stall_seconds)
        self.fired: Optional[str] = None
        self.matched = 0
        self.points_seen: List[str] = []

    def point(self, name: str) -> None:
        """Instrumentation hook: called by the pipeline at kill
        points.  No-op once fired (so a resumed in-process run with
        the same injector proceeds)."""
        self.points_seen.append(name)
        if self.fired is not None or self.mode == "off":
            return
        if self.kill_at is not None and self.kill_at not in name:
            return
        self.matched += 1
        if self.matched < self.kill_after:
            return
        self.fired = name
        if self.mode == "exit":
            kill_process()
        if self.mode == "stall":
            stall_collective(self.stall_seconds)
            return
        raise SimulatedCrash(name)


def kill_process(exit_code: int = FaultInjector.EXIT_CODE) -> None:
    """Hard process death — no atexit, no finally blocks, no flushes.
    The multi-process analog of SimulatedCrash: a preempted or
    OOM-killed cluster member."""
    os._exit(exit_code)


def stall_collective(seconds: float = 3600.0) -> None:
    """Wedge the calling thread, simulating a member stuck inside a
    collective (or on dead storage).  Peers must make progress via
    barrier timeouts and lease expiry — never by waiting this out."""
    time.sleep(seconds)


def run_to_completion(fn: Callable, max_crashes: int = 32):
    """Drive `fn` through injected crashes: call it until it returns
    without raising SimulatedCrash (the kill-resume loop in one
    line).  Returns fn()'s result."""
    last: Optional[SimulatedCrash] = None
    for _ in range(max_crashes):
        try:
            return fn()
        except SimulatedCrash as e:
            last = e
            continue
    raise RuntimeError(
        "still crashing after %d resumes (last kill point: %r)"
        % (max_crashes, last.point if last is not None else None)
    ) from last
