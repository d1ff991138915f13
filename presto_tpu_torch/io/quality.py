"""Ingest quarantine: data-quality accounting for the raw-data readers.

Host copy of ``presto_tpu/io/quality.py`` for the PyTorch port, which
imports nothing from the JAX package.

The readers (io/sigproc.py, io/psrfits.py) must not crash — or worse,
silently emit garbage — when an observation contains truncated reads,
NaN/Inf samples, or dropped/zero-filled blocks.  Instead each reader
carries a DataQualityReport: bad stretches are scrubbed to a pad value
on the way out, recorded here as typed intervals, and later converted
into rfifind mask entries (zap_intervals) so the whole downstream
pipeline treats detector damage exactly like RFI.

The report serializes to `<base>_quality.json` (written atomically) so
a survey's quarantine decisions are themselves a durable, inspectable
artifact.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from presto_tpu_torch.io.atomic import atomic_write_text

#: reasons a stretch of spectra can be quarantined.  "ring-drop" and
#: "stall" belong to the live-feed path (the JAX package's stream/source.py):
#: blocks shed under ring-buffer backpressure, and zero-fill inserted
#: to hold real-time cadence across a producer stall.
REASONS = ("nan-inf", "zero-fill", "truncated", "dropped-rows",
           "short-read", "ring-drop", "stall")

#: minimum run of consecutive all-zero spectra flagged as zero-fill.
#: Real zero-fill (backend dropouts, padded gaps) comes in long runs;
#: a handful of legitimately-zero spectra in quantized noise must not
#: trigger quarantine.
ZERO_RUN_MIN = 64


@dataclass
class BadInterval:
    """[start, stop) spectra quarantined for `reason`."""
    start: int
    stop: int
    reason: str

    @property
    def nspectra(self) -> int:
        return self.stop - self.start

    def to_json(self) -> dict:
        return {"start": int(self.start), "stop": int(self.stop),
                "reason": self.reason}


@dataclass
class DataQualityReport:
    """Per-observation quarantine ledger (one per open reader)."""
    path: str = ""
    nspectra: int = 0
    nchan: int = 0
    intervals: List[BadInterval] = field(default_factory=list)
    #: samples (not spectra) individually scrubbed, e.g. isolated NaNs
    scrubbed_samples: int = 0

    # -- recording ----------------------------------------------------
    def add(self, start: int, stop: int, reason: str) -> None:
        """Record [start, stop) as bad; overlapping/adjacent intervals
        of the same reason merge so repeated reads of a region do not
        inflate the ledger."""
        if stop <= start:
            return
        start, stop = int(start), int(stop)
        merged = []
        for iv in self.intervals:
            if iv.reason == reason and iv.start <= stop \
                    and start <= iv.stop:
                start = min(start, iv.start)
                stop = max(stop, iv.stop)
            else:
                merged.append(iv)
        merged.append(BadInterval(start, stop, reason))
        merged.sort(key=lambda iv: (iv.start, iv.stop, iv.reason))
        self.intervals = merged

    # -- queries ------------------------------------------------------
    @property
    def clean(self) -> bool:
        return not self.intervals and not self.scrubbed_samples

    def bad_spectra(self) -> int:
        """Distinct spectra covered by any bad interval."""
        covered = 0
        last = -1
        for iv in sorted(self.intervals, key=lambda v: v.start):
            lo = max(iv.start, last)
            if iv.stop > lo:
                covered += iv.stop - lo
                last = iv.stop
        return covered

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for iv in self.intervals:
            out[iv.reason] = out.get(iv.reason, 0) + iv.nspectra
        return out

    def zap_intervals(self, ptsperint: int,
                      numint: Optional[int] = None) -> List[int]:
        """rfifind interval indices overlapping any bad stretch — the
        bridge from quarantine to the existing mask machinery."""
        if ptsperint <= 0:
            return []
        ints = set()
        for iv in self.intervals:
            lo = iv.start // ptsperint
            hi = (iv.stop - 1) // ptsperint
            ints.update(range(lo, hi + 1))
        if numint is not None:
            ints = {i for i in ints if 0 <= i < numint}
        return sorted(ints)

    def summary(self) -> str:
        if self.clean:
            return "data quality: clean"
        cnt = self.counts()
        frac = (self.bad_spectra() / self.nspectra
                if self.nspectra else 0.0)
        return ("data quality: %d/%d spectra quarantined (%.2f%%): %s"
                % (self.bad_spectra(), self.nspectra, 100 * frac,
                   ", ".join("%s=%d" % kv for kv in sorted(cnt.items()))))

    # -- metrics ------------------------------------------------------
    def publish(self, registry) -> None:
        """Fold this report's tallies into an obs MetricsRegistry so
        ingest health is visible on a live /metrics scrape, not only
        in per-run `<base>_quality.json` files:

          ingest_reports_total                one per published report
          ingest_scrubbed_samples_total       NaN/Inf samples scrubbed
          ingest_quarantined_spectra_total{reason=...}
                                              spectra per quarantine
                                              reason (zero-fill,
                                              short-read, ...)
        """
        registry.counter(
            "ingest_reports_total",
            "Data-quality reports published").inc()
        if self.scrubbed_samples:
            registry.counter(
                "ingest_scrubbed_samples_total",
                "Samples scrubbed (NaN/Inf replaced with pad)"
            ).inc(self.scrubbed_samples)
        counts = self.counts()
        if counts:
            c = registry.counter(
                "ingest_quarantined_spectra_total",
                "Spectra quarantined by the ingest readers",
                ("reason",))
            for reason, n in counts.items():
                c.labels(reason=reason).inc(n)

    # -- (de)serialization --------------------------------------------
    def to_json(self) -> dict:
        return {"path": self.path, "nspectra": int(self.nspectra),
                "nchan": int(self.nchan),
                "scrubbed_samples": int(self.scrubbed_samples),
                "bad_spectra": self.bad_spectra(),
                "counts": self.counts(),
                "intervals": [iv.to_json() for iv in self.intervals]}

    def write(self, path: str) -> str:
        atomic_write_text(path, json.dumps(self.to_json(), indent=1,
                                           sort_keys=True) + "\n")
        return path

    @classmethod
    def from_json(cls, obj: dict) -> "DataQualityReport":
        rep = cls(path=obj.get("path", ""),
                  nspectra=int(obj.get("nspectra", 0)),
                  nchan=int(obj.get("nchan", 0)),
                  scrubbed_samples=int(obj.get("scrubbed_samples", 0)))
        for iv in obj.get("intervals", []):
            rep.intervals.append(BadInterval(int(iv["start"]),
                                             int(iv["stop"]),
                                             str(iv["reason"])))
        return rep

    @classmethod
    def read(cls, path: str) -> "DataQualityReport":
        with open(path) as f:
            return cls.from_json(json.load(f))


def merge_reports(reports: Sequence[DataQualityReport],
                  path: str = "") -> DataQualityReport:
    out = DataQualityReport(path=path)
    for r in reports:
        out.nspectra = max(out.nspectra, r.nspectra)
        out.nchan = max(out.nchan, r.nchan)
        out.scrubbed_samples += r.scrubbed_samples
        for iv in r.intervals:
            out.add(iv.start, iv.stop, iv.reason)
    return out


# ----------------------------------------------------------------------
# Block scrubbers (shared by the readers' decode paths)
# ----------------------------------------------------------------------

def scrub_nonfinite(block: np.ndarray, start: int,
                    report: Optional[DataQualityReport],
                    padval: float = 0.0) -> np.ndarray:
    """Replace NaN/Inf samples with `padval`, recording the affected
    spectra (rows) as 'nan-inf' intervals.  Returns the block (scrubbed
    in place when writable, else a scrubbed copy)."""
    bad = ~np.isfinite(block)
    if not bad.any():
        return block
    if not block.flags.writeable:
        block = block.copy()
        bad = ~np.isfinite(block)
    nbad = int(bad.sum())
    block[bad] = padval
    if report is not None:
        report.scrubbed_samples += nbad
        rows = np.flatnonzero(bad.any(axis=1))
        for lo, hi in _runs(rows):
            report.add(start + lo, start + hi + 1, "nan-inf")
    return block


def record_zero_runs(block: np.ndarray, start: int,
                     report: Optional[DataQualityReport],
                     min_run: int = ZERO_RUN_MIN) -> None:
    """Record runs of >= min_run consecutive all-zero spectra as
    'zero-fill' (a backend dropout signature).  Detection only — the
    zeros stay, exactly like the reference's padded blocks; the mask
    integration is what removes them from the search."""
    if report is None or block.shape[0] < min_run:
        return
    zero_rows = np.flatnonzero(~block.any(axis=1))
    for lo, hi in _runs(zero_rows):
        if hi - lo + 1 >= min_run:
            report.add(start + lo, start + hi + 1, "zero-fill")


def _runs(indices: np.ndarray):
    """Yield (first, last) for each run of consecutive indices."""
    if indices.size == 0:
        return
    breaks = np.flatnonzero(np.diff(indices) > 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [indices.size - 1]])
    for s, e in zip(starts, ends):
        yield int(indices[s]), int(indices[e])
