"""Generic leased-item ledger: lease, heartbeat and epoch fencing (host).

Host copy of ``presto_tpu/pipeline/leaseledger.py``, without its
flight-recorder events and without the fleet job ledger's policies
(the port has no serve layer yet); the elastic DM-shard ledger
(pipeline/shardledger.py) binds it to DM shards.

  * **Items** are leased rows in one JSON ledger file.  Every public
    mutator is transactional: take the lock directory, reload the
    ledger from disk, apply, write the whole file back atomically, so
    concurrent hosts always act on the latest accepted state and a kill
    mid-mutation loses nothing but that mutation.
  * **Heartbeats** are small per-host atomic files (liveness never
    contends with the ledger lock).  A host may write a *tombstone*
    heartbeat on a graceful exit, so the reaper treats it as dead at
    once instead of waiting out the TTL.
  * **Epoch fencing**: the ledger carries an epoch, bumped whenever
    membership changes.  Every lease records the epoch it was granted
    under; `complete()` is accepted only while the item is still leased
    to that owner under that epoch, so a zombie host (declared dead, its
    process lingering) never lands a late write: its staged outputs are
    deleted before they can replace a journaled artifact.
  * **Staged commits**: workers never write final artifact names.  They
    stage outputs beside the targets and hand the staged map to
    `complete()`, which does fence check -> rename -> size + CRC journal
    *under the ledger lock*.

State machine per item::

    pending --lease--> leased --complete--> done
       ^                 |                   |
       |   (lease expiry, owner death,      | (artifact fails
       |    explicit fail)                  |  size+CRC verify)
       +---------------- reap --------------+
"""
from __future__ import annotations

import contextlib
import errno
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch.io.atomic import atomic_write_text, file_checksum

HEARTBEAT_PREFIX = ".hb-"

PENDING, LEASED, DONE, FAILED = "pending", "leased", "done", "failed"


class LedgerError(Exception):
    """Base class for ledger protocol violations."""


class StaleLeaseError(LedgerError):
    """A write attempted under a lease the cluster has fenced off —
    the zombie-host case.  The staged outputs were discarded."""

    def __init__(self, item_id: str, host: str, epoch: int,
                 current_epoch: int, why: str):
        self.item_id = item_id
        self.host = host
        self.epoch = epoch
        self.current_epoch = current_epoch
        self.why = why
        super().__init__(
            "stale write rejected: %r by %r under epoch %d "
            "(cluster epoch %d): %s"
            % (item_id, host, epoch, current_epoch, why))


@dataclass
class ItemLease:
    """A granted item lease (what the worker computes against).
    `data` is a copy of the item's extra row fields (e.g. the shard's
    DM rows)."""
    item_id: str
    epoch: int                     # fence token for complete()
    expires: float
    data: dict = field(default_factory=dict)


@dataclass
class ReapReport:
    """What one reap pass changed."""
    dead_hosts: List[str] = field(default_factory=list)
    redone: List[str] = field(default_factory=list)
    epoch: int = 0
    bumped: bool = False


class _LockDir:
    """Tiny cross-process mutex: os.mkdir is atomic on POSIX.  A lock
    older than `stale` seconds is presumed abandoned by a killed
    process and broken — safe here because every mutation under the
    lock ends in an atomic whole-file replace, so a breaker can never
    observe a half-written ledger."""

    def __init__(self, path: str, timeout: float = 30.0,
                 stale: float = 30.0, poll: float = 0.02,
                 error=LedgerError):
        self.path = path
        self.timeout = timeout
        self.stale = stale
        self.poll = poll
        self.error = error

    @contextlib.contextmanager
    def __call__(self):
        deadline = time.time() + self.timeout
        while True:
            try:
                os.mkdir(self.path)
                break
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise
                try:
                    age = time.time() - os.path.getmtime(self.path)
                except OSError:
                    continue               # raced with the releaser
                if age > self.stale:
                    with contextlib.suppress(OSError):
                        os.rmdir(self.path)
                    continue
                if time.time() > deadline:
                    raise self.error(
                        "could not acquire ledger lock %s within %.1fs"
                        % (self.path, self.timeout))
                time.sleep(self.poll)
        try:
            yield
        finally:
            with contextlib.suppress(OSError):
                os.rmdir(self.path)


class LeaseLedger:
    """Leased-item journal for one shared working directory.

    Class attributes subclasses set:

      LEDGER_NAME   ledger filename inside the workdir
      ITEMS_KEY     JSON key the item table lives under (kept
                    distinct per domain so the on-disk schemas of the
                    ledgers stay self-describing)
      ERROR / STALE exception classes raised by this ledger
    """

    LEDGER_NAME = "items.json"
    ITEMS_KEY = "items"
    ERROR = LedgerError
    STALE = StaleLeaseError

    def __init__(self, workdir: str, name: Optional[str] = None):
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.path = os.path.join(self.workdir,
                                 name or self.LEDGER_NAME)
        self._lock = _LockDir(self.path + ".lock", error=self.ERROR)

    # -- raw state ----------------------------------------------------
    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                state = json.load(f)
            if not isinstance(state, dict):
                raise ValueError("ledger is not an object")
        except (OSError, ValueError):
            state = {}
        state.setdefault("version", 1)
        state.setdefault("epoch", 0)
        state.setdefault(self.ITEMS_KEY, {})
        state.setdefault("hosts", {})
        return state

    def _save(self, state: dict) -> None:
        atomic_write_text(self.path, json.dumps(
            state, indent=1, sort_keys=True) + "\n")

    def read(self) -> dict:
        """Lock-free snapshot (monitoring / tests)."""
        return self._load()

    def _items(self, state: dict) -> dict:
        return state[self.ITEMS_KEY]

    @property
    def epoch(self) -> int:
        return int(self._load()["epoch"])

    # -- membership ---------------------------------------------------
    def join(self, host: str, addr: Optional[str] = None,
             now: Optional[float] = None) -> int:
        """Register (or re-register) a host; returns the epoch it
        joins under.  A host re-joining after being declared dead is
        admitted at the current epoch — its fenced leases were already
        re-admitted, so it simply starts fresh.  Joining also clears a
        previous incarnation's tombstone heartbeat."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            state["hosts"][host] = {"joined": now, "alive": True,
                                    "addr": addr,
                                    "epoch": int(state["epoch"])}
            self._save(state)
            epoch = int(state["epoch"])
        _ts, tombstoned = self._hb_record(host)
        if tombstoned:
            self.heartbeat(host, epoch, now=now)
        return epoch

    def heartbeat_path(self, host: str) -> str:
        return os.path.join(self.workdir, HEARTBEAT_PREFIX + host
                            + ".json")

    def heartbeat(self, host: str, epoch: int,
                  now: Optional[float] = None) -> None:
        """Cheap liveness signal: one small atomic file per host, no
        ledger lock taken."""
        now = time.time() if now is None else now
        atomic_write_text(self.heartbeat_path(host), json.dumps(
            {"host": host, "ts": now, "epoch": int(epoch)}) + "\n")

    def tombstone(self, host: str,
                  now: Optional[float] = None) -> None:
        """Final heartbeat of a gracefully-departing host: marks it
        dead *immediately* so the reaper re-admits anything it still
        holds without waiting out the heartbeat TTL."""
        now = time.time() if now is None else now
        atomic_write_text(self.heartbeat_path(host), json.dumps(
            {"host": host, "ts": now, "tombstone": True}) + "\n")

    def _hb_record(self, host: str) -> Tuple[Optional[float], bool]:
        """(last heartbeat ts, tombstoned?) for one host."""
        try:
            with open(self.heartbeat_path(host)) as f:
                rec = json.load(f)
            return float(rec["ts"]), bool(rec.get("tombstone"))
        except (OSError, ValueError, KeyError, TypeError):
            return None, False

    def last_heartbeat(self, host: str) -> Optional[float]:
        return self._hb_record(host)[0]

    def alive_hosts(self, now: Optional[float] = None,
                    ttl: float = 15.0) -> List[str]:
        now = time.time() if now is None else now
        state = self._load()
        out = []
        for host, h in sorted(state["hosts"].items()):
            if not h.get("alive", False):
                continue
            hb, tombstoned = self._hb_record(host)
            if tombstoned:
                continue
            seen = hb if hb is not None else float(h.get("joined", 0))
            if now - seen <= ttl:
                out.append(host)
        return out

    # -- item bookkeeping ---------------------------------------------
    @staticmethod
    def _new_row(extra: Optional[dict] = None) -> dict:
        row = {
            "state": PENDING,
            "owner": None,
            "lease_epoch": None,
            "lease_expires": None,
            "artifacts": {},
            "redos": 0,
        }
        if extra:
            row.update(extra)
        return row

    def ensure_items(self, specs: Sequence[Tuple[str, dict]],
                     meta: Optional[dict] = None) -> int:
        """Idempotently create item rows.  `specs` is a sequence of
        (item_id, extra-fields dict).  Existing rows keep their state
        (that is the resume contract); returns the not-done count."""
        with self._lock():
            state = self._load()
            if meta:
                state.setdefault("meta", {}).update(meta)
            items = self._items(state)
            for iid, extra in specs:
                items.setdefault(iid, self._new_row(extra))
            pending = sum(1 for s in items.values()
                          if s["state"] not in (DONE, FAILED))
            self._save(state)
            return pending

    def _pick_pending(self, state: dict,
                      now: float) -> Optional[str]:
        """The lease scheduling policy: the item id to grant next, or
        None.  Called under the ledger lock; may mutate `state`
        bookkeeping (it is saved with the grant).  Base policy: first
        pending id in sorted order."""
        for iid in sorted(self._items(state)):
            if self._items(state)[iid]["state"] == PENDING:
                return iid
        return None

    def _make_lease(self, item_id: str, row: dict, epoch: int):
        data = {k: v for k, v in row.items()
                if k not in ("state", "owner", "lease_epoch",
                             "lease_expires", "artifacts", "redos")}
        return ItemLease(item_id, epoch,
                         float(row["lease_expires"]), data)

    def lease(self, host: str, ttl: float,
              now: Optional[float] = None):
        """Claim the next pending item for `host` (per the scheduling
        policy); None when nothing is currently pending (all leased or
        terminal)."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            h = state["hosts"].get(host)
            if h is not None and not h.get("alive", True):
                # false-positive death (slow heartbeat): rejoin at the
                # current epoch and carry on
                h["alive"] = True
                h["epoch"] = int(state["epoch"])
            iid = self._pick_pending(state, now)
            if iid is None:
                self._save(state)
                return None
            row = self._items(state)[iid]
            row["state"] = LEASED
            row["owner"] = host
            row["lease_epoch"] = int(state["epoch"])
            row["lease_expires"] = now + ttl
            row["leased_at"] = now
            self._save(state)
            return self._make_lease(iid, row, int(state["epoch"]))

    def renew(self, lease, host: str, ttl: float,
              now: Optional[float] = None) -> bool:
        """Extend a held lease (long items).  False when the lease
        was fenced off meanwhile."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            if (row is None or row["state"] != LEASED
                    or row["owner"] != host
                    or int(row["lease_epoch"]) != int(lease.epoch)):
                return False
            row["lease_expires"] = now + ttl
            self._save(state)
            return True

    @staticmethod
    def _fence_why(row: Optional[dict], lease, host: str) \
            -> Optional[str]:
        """The fence check: None when the commit may land, else the
        reason it must be rejected."""
        if row is None:
            return "unknown item"
        if row["state"] != LEASED:
            return "item is %s, not leased" % row["state"]
        if row["owner"] != host:
            return "lease owned by %r" % row["owner"]
        if int(row["lease_epoch"]) != int(lease.epoch):
            return "lease epoch %s superseded" % row["lease_epoch"]
        return None

    def _reject_stale(self, state: dict, lease, host: str,
                      staged: Dict[str, str], why: str):
        for tmp in staged.values():
            with contextlib.suppress(OSError):
                os.remove(tmp)
        raise self.STALE(lease.item_id, host, int(lease.epoch),
                         int(state["epoch"]), why)

    def _commit_row(self, state: dict, lease, host: str,
                    staged: Dict[str, str], row: dict, now: float,
                    extra: Optional[dict] = None) -> Dict[str, dict]:
        """The commit body shared by complete() and subclass commit
        transactions: rename each
        staged file onto its final path, journal size+CRC, and flip
        the row to done.  Must run under the ledger lock, AFTER the
        fence check; the caller saves the state."""
        arts: Dict[str, dict] = {}
        for final, tmp in sorted(staged.items()):
            os.replace(tmp, final)
            rel = os.path.relpath(os.path.abspath(final),
                                  self.workdir)
            arts[rel] = {"size": os.path.getsize(final),
                         "checksum": file_checksum(final)}
        row["state"] = DONE
        row["owner"] = host
        row["lease_epoch"] = None
        row["lease_expires"] = None
        row["artifacts"] = arts
        row["completed_epoch"] = int(state["epoch"])
        row["completed_at"] = now
        if extra:
            row.update(extra)
        return arts

    def complete(self, lease, host: str, staged: Dict[str, str],
                 now: Optional[float] = None,
                 extra: Optional[dict] = None) -> Dict[str, dict]:
        """Commit a computed item: fence-check, rename each staged
        file onto its final path, journal size+CRC — all under the
        ledger lock.  `staged` maps final absolute path -> staged
        temp path; `extra` fields are merged into the accepted row
        (a result summary).  Raises the STALE error
        (after deleting the staged files) when the lease was fenced
        off; a journaled artifact is then never overwritten."""
        now = time.time() if now is None else now
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            why = self._fence_why(row, lease, host)
            if why is not None:
                self._reject_stale(state, lease, host, staged, why)
            arts = self._commit_row(state, lease, host, staged, row,
                                    now, extra)
            self._save(state)
            return arts

    def fail(self, lease, host: str) -> None:
        """Voluntarily release a held lease back to pending (compute
        error on this host; let another host try)."""
        with self._lock():
            state = self._load()
            row = self._items(state).get(lease.item_id)
            if (row is not None and row["state"] == LEASED
                    and row["owner"] == host
                    and int(row["lease_epoch"]) == int(lease.epoch)):
                self._readmit(row)
                self._save(state)

    def readmit_owned(self, host: str) -> List[str]:
        """Re-admit every lease held by `host` — called by a
        *restarting* host on join (a fresh incarnation cannot have
        in-flight work, so any lease under its name is a dead one).
        Bumps the epoch when anything was re-admitted, fencing off the
        dead incarnation's possible late writes."""
        redone = []
        with self._lock():
            state = self._load()
            items = self._items(state)
            for iid in sorted(items):
                row = items[iid]
                if row["state"] == LEASED and row["owner"] == host:
                    self._readmit(row)
                    redone.append(iid)
            if redone:
                state["epoch"] = int(state["epoch"]) + 1
            self._save(state)
        return redone

    @staticmethod
    def _readmit(row: dict) -> None:
        row["state"] = PENDING
        row["owner"] = None
        row["lease_epoch"] = None
        row["lease_expires"] = None
        row["redos"] = int(row.get("redos", 0)) + 1

    # -- failure detection / redo -------------------------------------
    def _dead_by_heartbeat(self, state: dict, now: float,
                           ttl: float) -> List[str]:
        """Alive-marked hosts whose heartbeat is stale or tombstoned."""
        out = []
        for host, h in sorted(state["hosts"].items()):
            if not h.get("alive", False):
                continue
            hb, tombstoned = self._hb_record(host)
            seen = hb if hb is not None else float(h.get("joined", 0))
            if tombstoned or now - seen > ttl:
                out.append(host)
        return out

    def reap(self, heartbeat_ttl: float,
             now: Optional[float] = None) -> ReapReport:
        """One failure-detection pass: mark hosts with stale (or
        tombstoned) heartbeats dead, re-admit their leases plus any
        lease past expiry, bump the epoch when anything changed.  Safe
        to call from every host (idempotent under the lock)."""
        now = time.time() if now is None else now
        report = ReapReport()
        with self._lock():
            state = self._load()
            for host in self._dead_by_heartbeat(state, now,
                                                heartbeat_ttl):
                state["hosts"][host]["alive"] = False
                report.dead_hosts.append(host)
            dead = {host for host, h in state["hosts"].items()
                    if not h.get("alive", False)}
            items = self._items(state)
            for iid in sorted(items):
                row = items[iid]
                if row["state"] != LEASED:
                    continue
                expired = (row["lease_expires"] is not None
                           and now > float(row["lease_expires"]))
                if row["owner"] in dead or expired:
                    self._readmit(row)
                    report.redone.append(iid)
            if report.dead_hosts or report.redone:
                state["epoch"] = int(state["epoch"]) + 1
                report.bumped = True
            report.epoch = int(state["epoch"])
            self._save(state)
        return report

    def verify_done(self) -> List[str]:
        """Verify-not-trust for completed items: any done item whose
        journaled artifacts are missing, resized, or checksum-stale on
        disk is re-admitted (its stale files are deleted so nothing
        can resurrect them).  Returns the re-admitted item ids."""
        redone = []
        with self._lock():
            state = self._load()
            items = self._items(state)
            for iid in sorted(items):
                row = items[iid]
                if row["state"] != DONE:
                    continue
                ok = True
                for rel, ent in row.get("artifacts", {}).items():
                    p = os.path.join(self.workdir, rel)
                    if (not os.path.exists(p)
                            or os.path.getsize(p) != ent.get("size")
                            or file_checksum(p) != ent.get(
                                "checksum")):
                        ok = False
                        break
                if ok:
                    continue
                for rel in row.get("artifacts", {}):
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(self.workdir, rel))
                row["artifacts"] = {}
                self._readmit(row)
                redone.append(iid)
            self._save(state)
        return redone

    # -- progress -----------------------------------------------------
    def counts(self) -> Dict[str, int]:
        state = self._load()
        out = {PENDING: 0, LEASED: 0, DONE: 0}
        for row in self._items(state).values():
            out[row["state"]] = out.get(row["state"], 0) + 1
        return out

    def all_done(self) -> bool:
        state = self._load()
        items = self._items(state)
        return bool(items) and all(s["state"] == DONE
                                   for s in items.values())

    def redo_set(self, heartbeat_ttl: float,
                 now: Optional[float] = None) -> List[str]:
        """The items a reap pass *would* re-admit right now (dead
        owners or expired leases) — computed without mutating."""
        now = time.time() if now is None else now
        state = self._load()
        dead = set(self._dead_by_heartbeat(state, now, heartbeat_ttl))
        dead |= {host for host, h in state["hosts"].items()
                 if not h.get("alive", False)}
        out = []
        items = self._items(state)
        for iid in sorted(items):
            row = items[iid]
            if row["state"] != LEASED:
                continue
            expired = (row["lease_expires"] is not None
                       and now > float(row["lease_expires"]))
            if row["owner"] in dead or expired:
                out.append(iid)
        return out
