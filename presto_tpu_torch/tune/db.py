"""Persistent, schema-versioned tuning database (tune layer).

PyTorch counterpart of ``presto_tpu/tune/db.py``; :class:`TuneDB` is
the JAX package's.  One JSON file maps a *device fingerprint* to the
best measured config per (kernel family, shape key):

    {"schema": 1,
     "entries": {
       "<fingerprint>": {
         "<family>": {
           "<shape_key>": {"config": {...}, "median_s": 0.0042,
                           "reps": 5, "measured_at": 1754..,
                           "source": "presto-tune"}}}}}

The fingerprint is the card's (platform ``cuda``, its name, compute
capability and count, the torch and CUDA versions, and a hash over the
CUDA kernel sources and their wrappers): a result measured on one card
or against one kernel revision never drives another.  The port keeps
its own default path (``~/.cache/presto_tpu_torch/tune.json``), so a JAX
package's DB is never read as the card's.  Loads are defensive (a
corrupted, truncated or stale-schema file reads as an empty DB with
``load_error`` set and a warning); saves go through ``io/atomic`` and
re-read the file first, merging under keep-the-best (lowest median_s).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = 1

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_db_path() -> str:
    """The port's default tuning-DB path (``tune.configure(db_path=)``
    or a caller's ``db_path`` overrides it)."""
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "presto_tpu_torch", "tune.json")


# ----------------------------------------------------------------------
# device fingerprint
# ----------------------------------------------------------------------

#: files whose text feeds the kernel-source hash: the CUDA kernels, the
#: wrappers that launch them and the out-of-core FFT whose block size is
#: tuned (editing any re-tunes)
_KERNEL_SOURCES = (
    "csrc/plane_build.cu",
    "csrc/stage_reduce.cu",
    "search/build_cuda.py",
    "search/accel_cuda.py",
    "ops/oocfft.py",
)


def kernel_source_hash() -> str:
    """Short stable hash over the CUDA kernel sources and wrappers."""
    h = hashlib.sha1()
    for rel in _KERNEL_SOURCES:
        with open(os.path.join(_PKG, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def device_fingerprint() -> Dict[str, str]:
    """The identity a tuning result is valid for.  Fields:

      platform      "cuda" with a card visible, else "cpu"
      device_kind   torch.cuda.get_device_name ("NVIDIA H100 80GB HBM3")
      capability    compute capability ("9.0")
      device_count  visible cards
      torch, cuda   library versions (codegen changes re-tune)
      kernel_hash   hash of the CUDA kernels and their wrappers
    """
    import torch
    if torch.cuda.is_available():
        platform = "cuda"
        kind = torch.cuda.get_device_name(0)
        cap = "%d.%d" % torch.cuda.get_device_capability(0)
        count = torch.cuda.device_count()
    else:
        platform, kind, cap, count = "cpu", "cpu", "none", 0
    return {
        "platform": platform,
        "device_kind": str(kind),
        "capability": cap,
        "device_count": str(int(count)),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "kernel_hash": kernel_source_hash(),
    }


def fingerprint_key(fp: Optional[Dict[str, str]] = None) -> str:
    """Canonical string form of a fingerprint dict (the DB key)."""
    fp = fp or device_fingerprint()
    return "|".join("%s=%s" % (k, fp[k]) for k in sorted(fp))


# ----------------------------------------------------------------------
# the DB
# ----------------------------------------------------------------------

class TuneDB:
    """In-memory view of the tuning database.

    ``entries`` is the raw nested dict (fingerprint -> family ->
    shape_key -> record).  ``load_error`` records why a file on disk
    was unusable (None when the load was clean or the file absent).
    """

    def __init__(self, entries: Optional[dict] = None,
                 load_error: Optional[str] = None):
        self.entries: dict = entries if entries is not None else {}
        self.load_error = load_error

    # -- load/save -----------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TuneDB":
        """Defensive load: any structural problem (unparsable JSON,
        wrong schema, non-dict entries) yields an EMPTY db with
        ``load_error`` set and a warning — tuned runs then degrade to
        built-in defaults instead of crashing."""
        if not os.path.exists(path):
            return cls()
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(
                "tuning DB %s is unreadable (%s) — falling back to "
                "default configs" % (path, e), RuntimeWarning,
                stacklevel=2)
            return cls(load_error="unreadable: %s" % e)
        if not isinstance(raw, dict) or \
                raw.get("schema") != SCHEMA_VERSION:
            got = raw.get("schema") if isinstance(raw, dict) else None
            warnings.warn(
                "tuning DB %s has schema %r (want %d) — falling back "
                "to default configs" % (path, got, SCHEMA_VERSION),
                RuntimeWarning, stacklevel=2)
            return cls(load_error="stale schema: %r" % (got,))
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(
                "tuning DB %s has a malformed entries table — falling "
                "back to default configs" % path, RuntimeWarning,
                stacklevel=2)
            return cls(load_error="malformed entries")
        return cls(entries=entries)

    def save(self, path: str) -> None:
        """Merge-save: re-read whatever is on disk now, fold this DB
        in under keep-the-best, and atomically replace the file — two
        concurrent tuners both land, each key keeping its fastest
        measurement."""
        from presto_tpu_torch.io.atomic import atomic_write_text
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        on_disk = TuneDB.load(path)
        merged = TuneDB(entries=json.loads(json.dumps(on_disk.entries)))
        merged.merge(self)
        atomic_write_text(path, json.dumps(
            {"schema": SCHEMA_VERSION, "entries": merged.entries},
            indent=1, sort_keys=True))
        self.entries = merged.entries

    # -- record/lookup/merge -------------------------------------------

    def record(self, fingerprint: str, family: str, shape_key: str,
               config: dict, median_s: float, reps: int = 0,
               source: str = "presto-tune") -> None:
        fam = self.entries.setdefault(fingerprint, {}) \
                          .setdefault(family, {})
        old = fam.get(shape_key)
        if old is not None and self._valid(old) \
                and float(old["median_s"]) <= float(median_s):
            return                      # keep the faster measurement
        fam[shape_key] = {
            "config": dict(config),
            "median_s": float(median_s),
            "reps": int(reps),
            "measured_at": time.time(),
            "source": source,
        }

    def lookup(self, fingerprint: str, family: str,
               shape_key: str) -> Optional[dict]:
        """The best config for (fingerprint, family, shape_key), or
        None.  Malformed records are treated as absent."""
        rec = self.entries.get(fingerprint, {}) \
                          .get(family, {}).get(shape_key)
        if not self._valid(rec):
            return None
        return dict(rec["config"])

    def merge(self, other: "TuneDB") -> None:
        """Keep-the-best union: for every (fingerprint, family,
        shape_key) present in either DB, retain the record with the
        lowest median_s."""
        for fp, fams in other.entries.items():
            if not isinstance(fams, dict):
                continue
            for family, shapes in fams.items():
                if not isinstance(shapes, dict):
                    continue
                for shape_key, rec in shapes.items():
                    if not self._valid(rec):
                        continue
                    self.record(fp, family, shape_key,
                                rec["config"],
                                float(rec["median_s"]),
                                reps=int(rec.get("reps", 0)),
                                source=str(rec.get("source",
                                                   "merge")))

    # -- introspection -------------------------------------------------

    def families(self, fingerprint: str) -> Dict[str, dict]:
        """{family: {shape_key: record}} for one fingerprint."""
        fams = self.entries.get(fingerprint, {})
        return fams if isinstance(fams, dict) else {}

    def size(self) -> Tuple[int, int]:
        """(fingerprints, total shape-key records)."""
        n = 0
        for fams in self.entries.values():
            if not isinstance(fams, dict):
                continue
            for shapes in fams.values():
                if isinstance(shapes, dict):
                    n += len(shapes)
        return len(self.entries), n

    @staticmethod
    def _valid(rec) -> bool:
        return (isinstance(rec, dict)
                and isinstance(rec.get("config"), dict)
                and isinstance(rec.get("median_s"), (int, float)))
