"""Per-survey artifact journal (the verify half of crash-safe resume).

Host copy of ``presto_tpu/pipeline/manifest.py`` for the PyTorch port,
which imports nothing from the JAX package.

The survey's checkpoint contract used to be "a stage is skipped when
its outputs already exist" — which trusts whatever bytes happen to be
on disk, including a file truncated by a kill or rotted by a bad disk.
With io/atomic.py a *partial* artifact can no longer land under its
final name, and this journal closes the remaining gap: after each
stage completes, run_survey records every output's size + CRC-32 here;
on resume an artifact is trusted only when it exists AND matches its
journal entry.  Anything missing, unjournaled (e.g. written by a run
killed between the rename and the journal update, or by a pre-journal
version of the code), truncated, or checksum-stale is deleted and its
stage redone — safe because every stage is deterministic.

The journal itself (`manifest.json`) is written atomically, so it is
always a consistent snapshot of some prefix of the survey's progress.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

from presto_tpu_torch.io.atomic import atomic_write_text, file_checksum

MANIFEST_NAME = "manifest.json"

#: verify() statuses that mean "redo the stage that makes this file"
STALE = ("missing", "unjournaled", "size-mismatch", "checksum-mismatch")


class SurveyManifest:
    """size+checksum journal for one survey working directory."""

    def __init__(self, workdir: str):
        self.workdir = os.path.abspath(workdir)
        self.path = os.path.join(self.workdir, MANIFEST_NAME)
        # relpath -> {"size": int, "checksum": str, "stage": str}
        self.entries: Dict[str, dict] = {}

    # -- persistence --------------------------------------------------
    @classmethod
    def load(cls, workdir: str) -> "SurveyManifest":
        m = cls(workdir)
        try:
            with open(m.path) as f:
                obj = json.load(f)
            entries = obj.get("artifacts", {})
            if isinstance(entries, dict):
                m.entries = {str(k): dict(v)
                             for k, v in entries.items()}
        except (OSError, ValueError):
            # missing or corrupt journal: start empty — every artifact
            # then reads as unjournaled and its stage is redone, the
            # safe direction.
            m.entries = {}
        return m

    def save(self) -> None:
        atomic_write_text(self.path, json.dumps(
            {"version": 1, "artifacts": self.entries},
            indent=1, sort_keys=True) + "\n")

    # -- recording ----------------------------------------------------
    def _key(self, path: str) -> str:
        return os.path.relpath(os.path.abspath(path), self.workdir)

    def record(self, path: str, stage: str = "",
               save: bool = False) -> None:
        self.entries[self._key(path)] = {
            "size": os.path.getsize(path),
            "checksum": file_checksum(path),
            "stage": stage,
        }
        if save:
            self.save()

    def record_many(self, paths: Iterable[str], stage: str = "",
                    save: bool = True) -> None:
        for p in paths:
            self.record(p, stage=stage)
        if save:
            self.save()

    def forget(self, path: str) -> None:
        self.entries.pop(self._key(path), None)

    def stage_of(self, path: str) -> str:
        """Stage tag recorded for `path` ('' when unjournaled) — lets
        in-place mutators (zapbirds) distinguish done from pending."""
        entry = self.entries.get(self._key(path))
        return str(entry.get("stage", "")) if entry else ""

    # -- verification -------------------------------------------------
    def verify(self, path: str) -> str:
        """'ok' | 'missing' | 'unjournaled' | 'size-mismatch' |
        'checksum-mismatch' for one artifact."""
        if not os.path.exists(path):
            return "missing"
        entry = self.entries.get(self._key(path))
        if entry is None:
            return "unjournaled"
        if os.path.getsize(path) != entry.get("size"):
            return "size-mismatch"
        if file_checksum(path) != entry.get("checksum"):
            return "checksum-mismatch"
        return "ok"

    def valid(self, path: str) -> bool:
        return self.verify(path) == "ok"

    def invalidate_stale(self, paths: Iterable[str],
                         remove: bool = True) -> List[str]:
        """Return the stale subset of `paths`; with remove=True the
        on-disk stragglers are deleted (so globs can't resurrect them)
        and their journal entries dropped."""
        stale = []
        for p in paths:
            status = self.verify(p)
            if status == "ok":
                continue
            stale.append(p)
            if remove and os.path.exists(p):
                try:
                    os.remove(p)
                except OSError:
                    pass
            self.forget(p)
        return stale
