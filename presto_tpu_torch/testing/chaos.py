"""Fault injection: kill points, serve and live-feed faults, corrupt files.

Host copy of ``presto_tpu/testing/chaos.py`` for the port.  The survey calls
``cfg.fault_injector.point("stage-name")`` at stage and chunk
boundaries, and the elastic loop at its shard points; a scheduled
FaultInjector raises SimulatedCrash there (or exits the process, or
stalls it).  Tests catch the crash, run again and hold the resumed run's
artifacts to an uninterrupted run's bytes.  SimulatedCrash derives from
BaseException, so recovery code that catches Exception cannot swallow
an injected kill.  `TransientFaults` fails a serve job's first
attempts, `StreamFaults` stalls or kills a live feed at a spectrum
count, and the file corrupters (`truncate_file`, `bitflip_file`,
`zero_fill_file`, `ShortReadFile`) damage an observation on disk.
"""

from __future__ import annotations

import os
import random
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


class TransientFaults:
    """serve-scheduler fault injector: fail the first `fail_attempts`
    execution attempts of each (matching) job, then let it succeed.
    With fail_attempts >= the retry budget this is the poisoned-job
    case the queue's max_retry_depth bound must contain."""

    def __init__(self, fail_attempts: int = 1,
                 exc: Callable[[str], Exception] = RuntimeError,
                 match: Optional[Callable] = None):
        self.fail_attempts = fail_attempts
        self.exc = exc
        self.match = match
        self.calls = 0

    def __call__(self, job, attempt: int) -> None:
        self.calls += 1
        if self.match is not None and not self.match(job):
            return
        if attempt <= self.fail_attempts:
            raise self.exc("injected transient device error "
                           "(job %s attempt %d)"
                           % (getattr(job, "job_id", "?"), attempt))


# Beam-multiplexer kill points (stream/beams.py fires these through
# its FaultInjector hook).  The authoritative runtime copy lives next
# to the code that fires them; re-exported here so chaos harnesses can
# schedule beam kills without importing the stream layer.
BEAM_KILL_POINTS = ("beam-tick", "beam-commit", "beam-handoff")

# Federation kill points (serve/federation.py fires these through its
# FaultInjector hook).  The authoritative runtime copy lives next to the
# code that fires them; re-exported here so chaos harnesses can kill
# whole fleets without importing the serve layer.
FED_KILL_POINTS = ("fleet-dead", "pre-readmit", "post-readmit",
                   "zombie-fleet-commit")

# Fleet replica kill points (serve/fleet.FleetReplica fires these when
# its ``kill_on`` names one): a lease granted, a batch lease granted, a
# leased job in the local queue, a fold or triage node leased, the DAG
# fan-out computed but not committed, the fan-out committed.
FLEET_KILL_POINTS = ("job-leased", "batch-leased", "job-enqueued",
                     "mid-fold", "mid-triage", "fold-fanout",
                     "post-sift-commit")


class StreamFaults:
    """Live-feed fault schedule: the producer-side chaos seam for
    presto_tpu_torch/stream (feed_stream / FileTailProducer call this as
    faults(spectra_pushed_so_far) before every read).

    schedule: list of (at_spectra, kind, arg) triples, fired once each
    when the feed position passes `at_spectra`:

      ("stall", seconds)   — sleep, simulating a wedged backend; with
                             a source stall_timeout the gap becomes
                             quarantined zero fill.
      ("raise", exc)       — die mid-stream (connection loss); the
                             source quarantines the partial spectrum
                             and EOFs.
    """

    def __init__(self, schedule):
        self.schedule = sorted(
            (int(at), kind, arg) for at, kind, arg in schedule)
        self.fired: List[tuple] = []

    def __call__(self, pushed: int) -> None:
        while self.schedule and self.schedule[0][0] <= pushed:
            at, kind, arg = self.schedule.pop(0)
            self.fired.append((at, kind, arg))
            if kind == "stall":
                time.sleep(float(arg))
            elif kind == "raise":
                raise (arg if isinstance(arg, BaseException)
                       else RuntimeError(str(arg)))
            else:
                raise ValueError("unknown stream fault %r" % kind)


# ----------------------------------------------------------------------
# On-disk corruption (ingest fuzzing)
# ----------------------------------------------------------------------

def truncate_file(path: str, keep_bytes: Optional[int] = None,
                  keep_frac: Optional[float] = None) -> int:
    """Truncate `path`; returns the new size."""
    size = os.path.getsize(path)
    if keep_bytes is None:
        keep_bytes = int(size * (1.0 if keep_frac is None
                                 else keep_frac))
    keep_bytes = max(0, min(size, keep_bytes))
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    return keep_bytes


def bitflip_file(path: str, nflips: int = 1, seed: int = 0,
                 lo: int = 0, hi: Optional[int] = None) -> List[int]:
    """Flip `nflips` random bits in [lo, hi) (deterministic per seed);
    returns the byte offsets touched."""
    size = os.path.getsize(path)
    hi = size if hi is None else min(hi, size)
    if hi <= lo:
        return []
    rng = random.Random(seed)
    offsets = []
    with open(path, "r+b") as f:
        for _ in range(nflips):
            off = rng.randrange(lo, hi)
            bit = rng.randrange(8)
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ (1 << bit)]))
            offsets.append(off)
    return offsets


def zero_fill_file(path: str, offset: int, length: int) -> None:
    """Overwrite [offset, offset+length) with zeros (the dropped-block
    signature many backends write on packet loss)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(b"\x00" * length)


class ShortReadFile:
    """File-object wrapper whose reads go dry after `budget` bytes —
    simulates a reader racing a truncation/unmount without touching
    the disk.  Proxies seek/tell/close to the underlying file."""

    def __init__(self, f, budget: int):
        self._f = f
        self.budget = budget

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            data = self._f.read(self.budget)
        else:
            data = self._f.read(min(n, max(self.budget, 0)))
        self.budget -= len(data)
        return data

    def __getattr__(self, name):
        return getattr(self._f, name)
