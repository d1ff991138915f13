"""Durable per-tenant usage ledger: `<fleet>/usage.jsonl`.

Host copy of ``presto_tpu/serve/usage.py`` for the PyTorch port.

The fleet's decision signals (per-tenant SLO debt, the `/scale`
advisory, device-seconds admission) need an accounting record that
survives replica death and router restarts — a registry counter dies
with its process and a snapshot is only as old as its publisher.  So
every **fence-checked** terminal ledger transition appends one row
here (serve/jobledger.py calls `append` right after the commit
landed): the job's tenant, plan bucket, DAG id, terminal state, and
the admit→lease-wait→execute→commit phase decomposition in seconds.
The `execute` phase IS the device-seconds metering — the same float
the committing replica observes into `job_e2e_seconds{phase,bucket}`,
so per-tenant usage sums reconcile exactly against the fleet metric
aggregation.

Crash model (the append-only twin of `io/atomic`):

  * one row = one complete JSON line written in a SINGLE ``os.write``
    on an ``O_APPEND`` fd, fsync'd before the append returns —
    concurrent replicas interleave whole lines, never bytes (a tiny
    lockdir serializes writers across processes anyway);
  * a crash mid-append can at worst leave a torn FINAL line with no
    trailing newline.  Readers skip it (`rows` accepts only complete,
    parseable lines) and the next writer truncates it away before
    appending (`_repair`), so the ledger is always parseable and
    never contains a partial row;
  * double counting is fenced out: the append happens strictly
    AFTER the epoch-fence check inside the job ledger's commit
    transaction (and before the ledger state flips, so a job the
    fleet observes as terminal has always been metered) — a fenced
    zombie replica never reaches it.  The one residual case, a crash
    between the append and the ledger save, re-admits the job and
    the redo's row supersedes: `rows()` dedups by ``job_id``, last
    row wins.

Metering is always on (the JAX package's ``PRESTO_TPU_USAGE=0`` switch
is not carried over); usage is bookkeeping about jobs, never part of
the data path.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional

from presto_tpu_torch.io.atomic import atomic_write_bytes
from presto_tpu_torch.pipeline.leaseledger import _LockDir

USAGE_NAME = "usage.jsonl"


def usage_path(fleetdir: str) -> str:
    return os.path.join(os.path.abspath(fleetdir), USAGE_NAME)


class UsageLedger:
    """Append-only, crash-tolerant JSONL usage journal."""

    def __init__(self, fleetdir: str):
        self.path = usage_path(fleetdir)
        self._lock = _LockDir(self.path + ".lock", timeout=10.0)
        # offset-checkpointed read state: (inode, byte offset) of the
        # consumed complete-line prefix plus its parsed rows, so a
        # campaign-scale ledger is parsed O(new rows) per read, not
        # O(ledger).  A compaction (os.replace -> new inode) or a
        # truncation beneath the checkpoint resets to a full reread.
        self._ckpt: Optional[tuple] = None
        self._raw: List[dict] = []
        self._dedup_byid: Dict[str, int] = {}
        self._dedup_rows: List[dict] = []

    # -- writing --------------------------------------------------------

    @staticmethod
    def _write(fd: int, data: bytes) -> None:
        """The single-syscall append (seam: the chaos tests replace
        this with a torn write + SimulatedCrash)."""
        os.write(fd, data)

    def _repair(self, fd: int) -> int:
        """Truncate a torn final line (a predecessor died mid-append)
        so the file ends at a row boundary.  Returns bytes dropped."""
        size = os.fstat(fd).st_size
        if size == 0:
            return 0
        os.lseek(fd, size - 1, os.SEEK_SET)
        if os.read(fd, 1) == b"\n":
            return 0
        # walk back to the last complete row
        keep = 0
        os.lseek(fd, 0, os.SEEK_SET)
        data = os.read(fd, size)
        nl = data.rfind(b"\n")
        keep = nl + 1 if nl >= 0 else 0
        os.ftruncate(fd, keep)
        return size - keep

    def append(self, row: Dict) -> str:
        """Durably append one usage row; returns the ledger path."""
        data = (json.dumps(row, sort_keys=True) + "\n").encode()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with self._lock():
            fd = os.open(self.path,
                         os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                self._repair(fd)
                self._write(fd, data)
                os.fsync(fd)
            finally:
                with contextlib.suppress(OSError):
                    os.close(fd)
        return self.path

    # -- compaction -----------------------------------------------------

    def compact(self) -> int:
        """Rewrite the ledger as its deduplicated row set (one line
        per surviving job_id, last row wins) via an atomic same-dir
        replace under the writer lock.  Superseded redo rows — the
        only rows dedup ever drops — are garbage a campaign-scale
        ledger accretes under churn; dropping them changes no reader's
        view (`rows()` is byte-for-byte the same before and after).
        Returns the number of rows dropped.  A torn final line is
        repaired first, exactly as a writer would, so torn-tail
        semantics are unchanged."""
        try:
            st = os.stat(self.path)
        except OSError:
            return 0
        if st.st_size == 0:
            return 0
        with self._lock():
            fd = os.open(self.path, os.O_RDWR, 0o644)
            try:
                self._repair(fd)
                os.lseek(fd, 0, os.SEEK_SET)
                data = os.read(fd, os.fstat(fd).st_size)
            finally:
                with contextlib.suppress(OSError):
                    os.close(fd)
            raw = self._parse(data)
            kept = self._dedup(raw)
            if len(kept) == len(raw):
                return 0
            out = b"".join(
                json.dumps(rec, sort_keys=True).encode() + b"\n"
                for rec in kept)
            atomic_write_bytes(self.path, out)
        self._reset_cache()
        return len(raw) - len(kept)

    # -- reading --------------------------------------------------------

    @staticmethod
    def _parse(data: bytes) -> List[dict]:
        out: List[dict] = []
        for line in data.split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @staticmethod
    def _dedup(raw: List[dict]) -> List[dict]:
        byid: Dict[str, int] = {}
        out: List[dict] = []
        for rec in raw:
            jid = rec.get("job_id")
            if jid is None:
                out.append(rec)
                continue
            if jid in byid:
                out[byid[jid]] = rec
            else:
                byid[jid] = len(out)
                out.append(rec)
        return out

    def _reset_cache(self) -> None:
        self._ckpt = None
        self._raw = []
        self._dedup_byid = {}
        self._dedup_rows = []

    def _absorb(self, fresh: List[dict]) -> None:
        """Fold newly-read rows into both caches (raw append order and
        the job_id-deduplicated view) — O(new rows)."""
        self._raw.extend(fresh)
        for rec in fresh:
            jid = rec.get("job_id")
            if jid is None:
                self._dedup_rows.append(rec)
                continue
            at = self._dedup_byid.get(jid)
            if at is None:
                self._dedup_byid[jid] = len(self._dedup_rows)
                self._dedup_rows.append(rec)
            else:
                self._dedup_rows[at] = rec

    def _refresh(self) -> None:
        """Advance the checkpoint over any bytes appended since the
        last read.  Only complete newline-terminated lines are ever
        consumed, so a torn tail is left for the next pass (and a
        writer's `_repair` truncation never reaches beneath the
        checkpoint — it cuts exactly at the last complete line)."""
        try:
            st = os.stat(self.path)
        except OSError:
            self._reset_cache()
            return
        ino, off = self._ckpt if self._ckpt else (None, 0)
        if ino != st.st_ino or st.st_size < off:
            # replaced (compacted) or rewritten: reread from byte 0
            self._reset_cache()
            off = 0
        if st.st_size == off:
            self._ckpt = (st.st_ino, off)
            return
        try:
            with open(self.path, "rb") as f:
                f.seek(off)
                data = f.read()
        except OSError:
            self._reset_cache()
            return
        nl = data.rfind(b"\n")
        if nl < 0:
            self._ckpt = (st.st_ino, off)
            return
        self._absorb(self._parse(data[:nl + 1]))
        self._ckpt = (st.st_ino, off + nl + 1)

    def raw_rows(self) -> List[dict]:
        """Every complete parseable row, in append order (torn or
        corrupt lines skipped, never fatal).  Incremental: repeat
        calls parse only bytes appended since the previous call."""
        self._refresh()
        return list(self._raw)

    def rows(self) -> List[dict]:
        """raw_rows deduplicated by job_id (last row wins — a redo
        after a crash-between-commit-and-append supersedes), append
        order preserved.  Incremental like raw_rows."""
        self._refresh()
        return list(self._dedup_rows)
