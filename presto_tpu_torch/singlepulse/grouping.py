"""Cross-DM grouping and rating of single-pulse events (rrattrap).

Host copy of ``presto_tpu/singlepulse/grouping.py`` for the PyTorch
port.

The reference's bin/rrattrap.py (823 LoC) groups .singlepulse events
that are close in (time, DM) and rates each group by the shape of its
sigma-vs-DM curve: real broadband single pulses peak in S/N at their
true DM and decay to either side, while RFI is strongest at DM~0 or
shows no DM structure.  Ranks follow the reference's ladder:

  1 noise     — too few members
  2 ungraded  — enough members, ambiguous DM structure
  3 ok        — S/N peaks away from the DM edges
  4 good      — clean rise-and-fall around a peak DM > min_dm
  5 excellent — good + strong peak (peak/edge S/N ratio > 1.3)
  6 awesome   — excellent + high absolute S/N

This is a behavioral re-implementation (same inputs, same artifact
columns, same rank semantics), not a line port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from presto_tpu_torch.search.singlepulse import SPCandidate


@dataclass
class SinglePulseGroup:
    cands: List[SPCandidate] = field(default_factory=list)
    rank: int = 0

    @property
    def numcands(self) -> int:
        return len(self.cands)

    @property
    def min_dm(self) -> float:
        return min(c.dm for c in self.cands)

    @property
    def max_dm(self) -> float:
        return max(c.dm for c in self.cands)

    @property
    def max_sigma(self) -> float:
        return max(c.sigma for c in self.cands)

    @property
    def best_cand(self) -> SPCandidate:
        return max(self.cands, key=lambda c: c.sigma)

    @property
    def center_time(self) -> float:
        return float(np.median([c.time for c in self.cands]))

    @property
    def duration(self) -> float:
        ts = [c.time for c in self.cands]
        return max(ts) - min(ts)

    def __str__(self) -> str:
        b = self.best_cand
        return ("rank %d  N=%4d  DM %7.2f-%7.2f  best: DM=%7.2f "
                "sigma=%6.2f t=%10.4f" %
                (self.rank, self.numcands, self.min_dm, self.max_dm,
                 b.dm, b.sigma, b.time))


def auto_dm_thresh(cands: Sequence[SPCandidate]) -> float:
    """DM link distance from the trial spacing: the reference groups
    events on ADJACENT DM trials (rrattrap.py uses a trial-index
    neighborhood), so the equivalent absolute threshold is ~2 trial
    steps."""
    dms = np.unique([c.dm for c in cands])
    if dms.size < 2:
        return 0.5
    return 2.0 * float(np.median(np.diff(dms))) + 1e-9


def group_candidates(cands: Sequence[SPCandidate],
                     time_thresh: float = 0.1,
                     dm_thresh: Optional[float] = None
                     ) -> List[SinglePulseGroup]:
    """Greedy transitive grouping: events within time_thresh seconds
    AND dm_thresh DM units of any group member join that group
    (rrattrap.py Group creation semantics).  dm_thresh=None adapts to
    the DM trial spacing.  Implemented as a union-find sweep over
    time-sorted events for O(n·w) behavior instead of the reference's
    O(n^2) pairwise pass.
    """
    if dm_thresh is None:
        dm_thresh = auto_dm_thresh(cands)
    order = sorted(range(len(cands)), key=lambda i: cands[i].time)
    parent = list(range(len(cands)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj

    # sliding window over time; pairwise check only inside the window
    for a in range(len(order)):
        ia = order[a]
        ta = cands[ia].time
        for b in range(a + 1, len(order)):
            ib = order[b]
            if cands[ib].time - ta > time_thresh:
                break
            if abs(cands[ib].dm - cands[ia].dm) <= dm_thresh:
                union(ia, ib)

    buckets: Dict[int, SinglePulseGroup] = {}
    for i in range(len(cands)):
        buckets.setdefault(find(i), SinglePulseGroup()).cands.append(
            cands[i])
    groups = list(buckets.values())
    for g in groups:
        g.cands.sort(key=lambda c: c.dm)
    return groups


def rank_groups(groups: Sequence[SinglePulseGroup],
                min_group: int = 30, min_dm: float = 2.0,
                sigma_thresh: float = 8.0) -> None:
    """Assign ranks in place (rrattrap.py rate-the-groups semantics)."""
    for g in groups:
        g.rank = _rank_one(g, min_group, min_dm, sigma_thresh)


def _rank_one(g: SinglePulseGroup, min_group: int, min_dm: float,
              sigma_thresh: float) -> int:
    if g.numcands < max(min_group // 6, 3):
        return 1
    if g.numcands < min_group:
        return 2
    dms = np.array([c.dm for c in g.cands])
    sig = np.array([c.sigma for c in g.cands])
    # sigma-vs-DM profile in 5 DM bands (the reference splits the span
    # and compares max sigma per band)
    edges = np.linspace(dms.min(), dms.max() + 1e-9, 6)
    band_max = np.zeros(5)
    for i in range(5):
        in_band = (dms >= edges[i]) & (dms < edges[i + 1])
        band_max[i] = sig[in_band].max() if in_band.any() else 0.0
    peak_band = int(np.argmax(band_max))
    peak = band_max[peak_band]
    edge = max(band_max[0], band_max[4])
    if peak_band in (0, 4):
        return 2                      # strongest at a DM edge: suspect
    if g.best_cand.dm < min_dm:
        return 2                      # peaks at ~zero DM: RFI-like
    rank = 3
    # rise-and-fall test with 5% slack (band maxima are noisy)
    rising = np.all(np.diff(band_max[:peak_band + 1]) >= -0.05 * peak)
    falling = np.all(np.diff(band_max[peak_band:]) <= 0.05 * peak)
    if rising and falling:
        rank = 4
    if rank == 4 and edge > 0 and peak / edge > 1.3:
        rank = 5
    if rank == 5 and peak >= 1.5 * sigma_thresh:
        rank = 6
    return rank


def read_and_group(paths: Sequence[str], time_thresh: float = 0.1,
                   dm_thresh: Optional[float] = None,
                   min_group: int = 30,
                   min_dm: float = 2.0, min_sigma: float = 0.0
                   ) -> List[SinglePulseGroup]:
    """rrattrap main flow: read many per-DM .singlepulse files, group,
    rank, and return groups sorted by (rank desc, max_sigma desc)."""
    from presto_tpu_torch.search.singlepulse import read_singlepulse
    cands: List[SPCandidate] = []
    for p in paths:
        cands.extend(c for c in read_singlepulse(p)
                     if c.sigma >= min_sigma)
    groups = group_candidates(cands, time_thresh, dm_thresh)
    rank_groups(groups, min_group=min_group, min_dm=min_dm)
    groups.sort(key=lambda g: (-g.rank, -g.max_sigma))
    return groups


def write_groups(path: str, groups: Sequence[SinglePulseGroup],
                 min_rank: int = 0) -> None:
    """groups.txt artifact: one summary line + member rows per group."""
    with open(path, "w") as f:
        f.write("# rank N dm_lo dm_hi best_dm best_sigma best_time\n")
        for g in groups:
            if g.rank < min_rank:
                continue
            b = g.best_cand
            f.write("%d %d %.2f %.2f %.2f %.2f %.6f\n" % (
                g.rank, g.numcands, g.min_dm, g.max_dm, b.dm, b.sigma,
                b.time))
