"""Per-survey DM-shard ledger, the redo unit of elastic runs (host).

Host copy of ``presto_tpu/pipeline/shardledger.py``.  The reference's
mpiprepsubband partitions the DM axis statically over MPI ranks, so a
lost rank loses its rows; here every **DM shard** (a contiguous run of
DM-trial rows) is a *leased* row in ``shards.json``, and any surviving
host can lease and recompute a dead member's rows again, since each
shard's computation is deterministic given its spec.  The lease,
heartbeat, epoch-fencing and staged-commit mechanics are
pipeline/leaseledger.LeaseLedger's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch.pipeline.leaseledger import (  # noqa: F401
    DONE, HEARTBEAT_PREFIX, LEASED, PENDING, LeaseLedger, LedgerError,
    ReapReport, StaleLeaseError)

LEDGER_NAME = "shards.json"


class ShardLedgerError(LedgerError):
    """Base class for shard-ledger protocol violations."""


class StaleEpochError(StaleLeaseError, ShardLedgerError):
    """A write attempted under a lease the cluster has fenced off —
    the zombie-worker case.  The staged outputs were discarded."""

    def __init__(self, shard_id: str, host: str, epoch: int,
                 current_epoch: int, why: str):
        super().__init__(shard_id, host, epoch, current_epoch, why)
        self.shard_id = shard_id


@dataclass
class Lease:
    """A granted shard lease (what the worker computes against)."""
    shard_id: str
    rows: Tuple[int, int]          # [lo, hi) DM-row indices
    epoch: int                     # fence token for complete()
    expires: float

    @property
    def item_id(self) -> str:      # generic-ledger lease protocol
        return self.shard_id


class ShardLedger(LeaseLedger):
    """Leased-shard journal for one survey working directory.

    Every public mutator is transactional: it takes the lock, reloads
    the ledger from disk, applies the change, and writes the whole
    file back atomically — so concurrent hosts always act on the
    latest accepted state and a kill mid-mutation loses nothing but
    that mutation.
    """

    LEDGER_NAME = LEDGER_NAME
    ITEMS_KEY = "shards"
    ERROR = ShardLedgerError
    STALE = StaleEpochError
    EV_LEASE = "shard-lease"
    EV_DONE = "shard-done"
    EV_REDO = "shard-redo"
    EV_STALE = "stale-write-rejected"
    EV_HOST_DEAD = "host-dead"
    EV_EPOCH_BUMP = "epoch-bump"

    # -- shard bookkeeping --------------------------------------------
    def ensure_shards(self, specs: Sequence[Tuple[str, int, int]],
                      meta: Optional[dict] = None) -> int:
        """Idempotently create shard rows.  `specs` is a sequence of
        (shard_id, row_lo, row_hi).  Existing rows keep their state
        (that is the resume contract); returns the pending count."""
        return self.ensure_items(
            [(sid, {"rows": [int(lo), int(hi)]})
             for sid, lo, hi in specs], meta=meta)

    def _make_lease(self, item_id: str, row: dict,
                    epoch: int) -> Lease:
        return Lease(item_id, tuple(row["rows"]), epoch,
                     float(row["lease_expires"]))


def make_dm_shards(numdms: int, shard_rows: int,
                   prefix: str = "dm") -> List[Tuple[str, int, int]]:
    """Split the DM axis [0, numdms) into ledger shard specs of up to
    `shard_rows` rows each."""
    if numdms <= 0:
        return []
    shard_rows = max(1, int(shard_rows))
    return [("%s%04d" % (prefix, i // shard_rows),
             i, min(i + shard_rows, numdms))
            for i in range(0, numdms, shard_rows)]
