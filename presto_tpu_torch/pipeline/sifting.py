"""Cross-DM candidate sifting for acceleration-search output.

Host copy of ``presto_tpu/pipeline/sifting.py`` for the PyTorch port,
which imports nothing from the JAX package.

Reference: lib/python/sifting.py — collect *_ACCEL_<z> candidates over
all DM trials, reject implausible ones (period range, known birdies,
significance thresholds, rogue harmonic powers), collapse duplicates
across DMs into "hits" on the strongest detection, strip harmonics of
stronger fundamentals, and drop candidates whose DM behavior is wrong
(too few DM hits, peak at very low DM, gaps in the DM hit list — real
pulsars persist over a contiguous DM span peaking away from zero).

Candidate lists are tiny (thousands); this is pure host Python by
design, same as the reference.  The numerics differ only in sort
stability, not semantics.
"""

from __future__ import annotations

import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Module-level defaults (sifting.py:20-37)
R_ERR = 1.1              # Fourier bin tolerance for "same" candidate
LONG_PERIOD = 15.0       # s
SHORT_PERIOD = 0.0005    # s
SIGMA_THRESHOLD = 6.0
C_POW_THRESHOLD = 100.0
HARM_POW_CUTOFF = 8.0

@dataclass
class SiftPolicy:
    """One survey's sifting thresholds — the knobs the reference's
    survey drivers set as sifting-module globals
    (PALFA_presto_search.py:47-52)."""
    sigma_threshold: float = SIGMA_THRESHOLD
    c_pow_threshold: float = C_POW_THRESHOLD
    short_period: float = SHORT_PERIOD
    long_period: float = LONG_PERIOD
    harm_pow_cutoff: float = HARM_POW_CUTOFF
    r_err: float = R_ERR


DM_RE = re.compile(r"DM(\d+\.\d{2})")


def default_known_birds_f() -> List[Tuple[float, float]]:
    """(freq, err) pairs from the shipped default birdie list
    (power-mains harmonics).  OPT-IN — pass the result as
    known_birds_f (e.g. ACCEL_sift -defaultbirds); the reference's
    ACCEL_sift recipe defaults to an empty birdie list, so the sift
    never rejects by default."""
    from presto_tpu_torch.ops.rednoise import read_birds_bary
    from presto_tpu_torch.utils.catalog import default_birds_path
    path = default_birds_path()
    if not path:
        return []
    return [(f, w) for (f, w, _b) in read_birds_bary(path)]

HARM_RATIOS = [(3, 2), (5, 2), (2, 3), (4, 3), (5, 3),
               (3, 4), (5, 4), (2, 5), (3, 5), (4, 5)]


@dataclass
class Candidate:
    """One accelsearch candidate (sifting.py:167-206)."""
    candnum: int
    sigma: float
    numharm: int
    ipow_det: float       # incoherent (summed) power
    cpow: float           # coherent power
    r: float              # Fourier bin of the fundamental
    z: float
    DMstr: str
    filename: str
    T: float
    harm_pows: Optional[np.ndarray] = None
    note: str = ""
    snr: float = 0.0
    hits: List[Tuple[float, float, float]] = field(default_factory=list)
    # each hit: (DM, snr, sigma)

    def __post_init__(self):
        self.path, self.filename = os.path.split(self.filename)
        self.DM = float(self.DMstr)
        self.f = self.r / self.T
        self.p = 1.0 / self.f if self.f > 0 else np.inf
        if not self.hits:
            self.hits = [(self.DM, self.snr, self.sigma)]

    def add_as_hit(self, other: "Candidate") -> None:
        self.hits.extend(other.hits)

    def harms_to_snr(self) -> None:
        """Approximate SNR from harmonic powers (sifting.py:200-205)."""
        amps = np.maximum(np.asarray(self.harm_pows, np.float64) - 1.0,
                          0.0)
        self.snr = float(np.sqrt(amps).sum())
        self.hits = [(self.DM, self.snr, self.sigma)]

    def __str__(self) -> str:
        cand = "%s:%d" % (self.filename, self.candnum)
        return ("%-65s   %7.2f  %6.2f  %6.2f  %s   %7.1f  %7.1f  "
                "%12.6f  %10.2f  %8.2f" %
                (cand, self.DM, self.snr, self.sigma,
                 ("%2d" % self.numharm).center(7), self.ipow_det,
                 self.cpow, self.p * 1000.0, self.r, self.z))


class Candlist:
    """Sift container (sifting.py:208-1097) with bad/dupe tracking."""

    def __init__(self, cands: Optional[List[Candidate]] = None):
        self.cands: List[Candidate] = list(cands) if cands else []
        self.badcands: Dict[str, List[Candidate]] = {}
        self.duplicates: List[Candidate] = []

    # -- container protocol -------------------------------------------
    def __len__(self):
        return len(self.cands)

    def __iter__(self):
        return iter(self.cands)

    def __getitem__(self, i):
        return self.cands[i]

    def __add__(self, other):
        out = Candlist(self.cands + other.cands)
        out.badcands = {k: list(v) for k, v in self.badcands.items()}
        for k, v in other.badcands.items():
            out.badcands.setdefault(k, []).extend(v)
        out.duplicates = self.duplicates + other.duplicates
        return out

    def extend(self, other):
        # carry rejected/duplicate candidates too, so aggregated lists
        # keep the full rejection bookkeeping (sifting.py semantics)
        self.cands.extend(other.cands)
        for k, v in other.badcands.items():
            self.badcands.setdefault(k, []).extend(v)
        self.duplicates.extend(other.duplicates)

    def sort_by_sigma(self):
        self.cands.sort(key=lambda c: (-c.sigma, -c.ipow_det))

    def _mark_bad(self, idx: int, why: str):
        self.badcands.setdefault(why, []).append(self.cands.pop(idx))

    # -- rejections (sifting.py:536-731) ------------------------------
    def reject_longperiod(self, long_period: float = LONG_PERIOD):
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if c.p > long_period:
                c.note = "period %.3f s > %.3f s" % (c.p, long_period)
                self._mark_bad(i, "longperiod")

    def reject_shortperiod(self, short_period: float = SHORT_PERIOD):
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if c.p < short_period:
                c.note = "period %.5g s < %.5g s" % (c.p, short_period)
                self._mark_bad(i, "shortperiod")

    def reject_knownbirds(self, known_birds_f: Sequence = (),
                          known_birds_p: Sequence = ()):
        """known_birds_f: (freq Hz, err Hz); known_birds_p: (ms, err)."""
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            bad = False
            for bird, err in known_birds_f:
                if abs(c.f - bird) < err:
                    c.note = "freq matches birdie %.6g Hz" % bird
                    bad = True
                    break
            if not bad:
                for bird, err in known_birds_p:
                    if abs(c.p * 1000.0 - bird) < err:
                        c.note = "period matches birdie %.6g ms" % bird
                        bad = True
                        break
            if bad:
                self._mark_bad(i, "knownbirds")

    def reject_threshold(self, sigma_threshold: float = SIGMA_THRESHOLD,
                         c_pow_threshold: float = C_POW_THRESHOLD):
        """Single-harmonic cands may pass on coherent power alone
        (sifting.py:620-659)."""
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if c.numharm == 1:
                if c.sigma < sigma_threshold and c.cpow < c_pow_threshold:
                    c.note = "sigma %.2f and cpow %.1f below thresholds" \
                        % (c.sigma, c.cpow)
                    self._mark_bad(i, "threshold")
            elif c.sigma < sigma_threshold:
                c.note = "sigma %.2f below threshold" % c.sigma
                self._mark_bad(i, "threshold")

    def reject_harmpowcutoff(self,
                             harm_pow_cutoff: float = HARM_POW_CUTOFF):
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if c.harm_pows is None or not len(c.harm_pows):
                continue
            if float(np.max(c.harm_pows)) < harm_pow_cutoff:
                c.note = "all harmonics below power %g" % harm_pow_cutoff
                self._mark_bad(i, "harmpowcutoff")

    def reject_rogueharmpow(self):
        """Drop cands dominated by a single high-numbered harmonic
        (sifting.py:681-715)."""
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if c.harm_pows is None or len(c.harm_pows) < 2:
                continue
            maxharm = int(np.argmax(c.harm_pows))
            maxpow = float(c.harm_pows[maxharm])
            sorted_pows = np.sort(np.asarray(c.harm_pows, np.float64))
            rest = float(sorted_pows[:-1].sum())
            if ((c.numharm >= 8 and maxharm > 4 and maxpow > 2 * rest)
                    or (c.numharm >= 4 and maxharm > 2
                        and maxpow > 3 * rest)):
                c.note = "dominated by harmonic %d" % (maxharm + 1)
                self._mark_bad(i, "rogueharmpow")

    def default_rejection(self, known_birds_f=(), known_birds_p=(),
                          policy: "SiftPolicy" = None):
        pol = policy or SiftPolicy()
        self.reject_longperiod(pol.long_period)
        self.reject_shortperiod(pol.short_period)
        self.reject_knownbirds(known_birds_f, known_birds_p)
        self.reject_threshold(pol.sigma_threshold, pol.c_pow_threshold)
        self.reject_harmpowcutoff(pol.harm_pow_cutoff)
        self.reject_rogueharmpow()

    # -- dedup / harmonic / DM sifts ----------------------------------
    def remove_duplicate_candidates(self, r_err: float = R_ERR):
        """Collapse same-r detections across DMs onto the strongest,
        recording the others as hits (sifting.py:732-791)."""
        self.cands.sort(key=lambda c: c.r)
        ii = 0
        while ii < len(self.cands):
            jj = ii + 1
            while (jj < len(self.cands)
                   and abs(self.cands[ii].r - self.cands[jj].r) < r_err):
                jj += 1
            if jj == ii + 1:
                ii += 1
                continue
            matches = self.cands[ii:jj]
            best = max(matches, key=lambda c: (c.sigma, c.ipow_det))
            for m in matches:
                if m is best:
                    continue
                best.add_as_hit(m)
                m.note = "duplicate of %s:%d" % (best.filename,
                                                 best.candnum)
                self.duplicates.append(m)
            self.cands[ii:jj] = [best]
            # best may still collect more matches; don't advance
            # (sifting.py:783-786)
        self.sort_by_sigma()

    def remove_harmonics(self, r_err: float = R_ERR):
        """Drop weaker candidates that are integer or simple-ratio
        harmonics of stronger ones (sifting.py:793-881)."""
        if not self.cands:
            return
        self.sort_by_sigma()
        f_err0 = r_err / self.cands[0].T
        ii = 0
        while ii < len(self.cands) - 1:
            fund = self.cands[ii]
            jj = len(self.cands) - 1
            while jj > ii:
                harm = self.cands[jj]
                zap, harmstr = False, ""
                for factor in range(1, 17):
                    if abs(fund.f - harm.f * factor) < f_err0 * factor:
                        zap, harmstr = True, "1/%d" % factor
                        break
                    if abs(fund.f - harm.f / factor) < f_err0 / factor:
                        zap, harmstr = True, "%d" % factor
                        break
                if not zap:
                    for numer, denom in HARM_RATIOS:
                        factor = numer / denom
                        if abs(fund.f - harm.f * factor) < f_err0 * factor:
                            zap, harmstr = True, "%d/%d" % (denom, numer)
                            break
                if zap:
                    harm.note = ("harmonic (%s) of %s:%d"
                                 % (harmstr, fund.filename, fund.candnum))
                    self._mark_bad(jj, "harmonic")
                jj -= 1
            ii += 1

    def remove_DM_problems(self, numdms: int, dmlist: Sequence[float],
                           low_DM_cutoff: float):
        """Reject cands with too few DM hits, peak at very low DM, or
        gaps in the DM hit sequence (sifting.py:883-966)."""
        dms = np.unique(np.asarray([float(d) for d in dmlist]))
        dmdict = {"%.2f" % d: i for i, d in enumerate(dms)}
        self.sort_by_sigma()
        for i in reversed(range(len(self.cands))):
            c = self.cands[i]
            if len(c.hits) < numdms:
                c.note = "only %d DM hits (< %d)" % (len(c.hits), numdms)
                self._mark_bad(i, "dmproblem")
                continue
            imax = int(np.argmax([h[2] for h in c.hits]))
            if float(c.hits[imax][0]) <= low_DM_cutoff:
                c.note = "peak sigma at DM %.2f <= cutoff %.2f" % (
                    c.hits[imax][0], low_DM_cutoff)
                self._mark_bad(i, "dmproblem")
                continue
            if len(c.hits) > 1:
                idx = np.sort([dmdict["%.2f" % h[0]] for h in c.hits])
                if int(np.min(np.diff(idx))) > 1:
                    c.note = "gaps in the DM hit list"
                    self._mark_bad(i, "dmproblem")

    # -- reporting ----------------------------------------------------
    def summary_lines(self) -> List[str]:
        lines = ["#" + "file:candnum".center(66) + "DM".center(9)
                 + "SNR".center(8) + "sigma".center(8)
                 + "numharm".center(9) + "ipow".center(9)
                 + "cpow".center(9) + "P(ms)".center(14)
                 + "r".center(12) + "z".center(8)]
        for c in self.cands:
            lines.append(str(c))
        return lines

    def to_file(self, path: str):
        from presto_tpu_torch.io.atomic import atomic_open
        with atomic_open(path, "w") as f:
            f.write("\n".join(self.summary_lines()) + "\n")
            for c in self.cands:
                for dm, snr, sig in sorted(c.hits):
                    f.write("  DM=%6.2f SNR=%5.2f Sigma=%5.2f\n"
                            % (dm, snr, sig))


# ----------------------------------------------------------------------
# Reading our accelsearch artifacts
# ----------------------------------------------------------------------

def candlist_from_accelfile(filename: str) -> Candlist:
    """Parse one *_ACCEL_<z> text file written by
    presto_tpu_torch.apps.accelsearch.write_accel_file."""
    from presto_tpu_torch.io.infodata import read_inf
    base = filename[:filename.rfind("_ACCEL")]
    info = read_inf(base)
    T = float(info.N) * info.dt
    m = DM_RE.search(filename)
    dmstr = m.group(1) if m else "%.2f" % info.dm
    cands = []
    with open(filename) as f:
        lines = f.readlines()[3:]
    for line in lines:
        if not line.strip() or not line[0].isdigit():
            continue
        parts = line.split()
        candnum = int(parts[0])
        sigma = float(parts[1])
        ipow = float(parts[2])
        cpow = float(parts[3])
        numharm = int(parts[4])
        r = float(parts[7])
        z = float(parts[9])
        c = Candidate(candnum=candnum, sigma=sigma, numharm=numharm,
                      ipow_det=ipow, cpow=cpow, r=r, z=z, DMstr=dmstr,
                      filename=filename, T=T)
        c.snr = np.sqrt(max(ipow - numharm, 0.0))
        c.hits = [(c.DM, c.snr, c.sigma)]
        cands.append(c)
    return Candlist(cands)


def read_candidates(filenames: Sequence[str],
                    prelim_reject: bool = True,
                    known_birds_f=(), known_birds_p=(),
                    policy: "SiftPolicy" = None) -> Candlist:
    """Aggregate candidates over many DM trials
    (sifting.py:1203-1230).

    Ingestion order is made deterministic here — the file list is
    sorted before reading — because exact-tie resolution in the
    duplicate/harmonic sifts follows encounter order: a glob whose
    order depends on the filesystem would make the sifted list (and
    therefore a discovery DAG's fold fan-out set) differ across
    hosts byte-for-byte identical inputs."""
    out = Candlist()
    for fn in sorted(filenames):
        cl = candlist_from_accelfile(fn)
        if prelim_reject:
            cl.default_rejection(known_birds_f, known_birds_p, policy)
        out.extend(cl)
    return out


def select_fold_candidates(cl: Candlist, fold_top: int = 3,
                           fold_sigma: Optional[float] = None,
                           max_folds: int = 150,
                           max_folds_per_pass: Optional[tuple] = None,
                           pass_zmaxes: Sequence[int] = (),
                           policy=None,
                           accounting: Optional[dict] = None
                           ) -> List[Candidate]:
    """The survey drivers' fold-selection policy, factored so the
    batch survey (pipeline/survey.py) and the discovery-DAG sift /
    triage nodes (serve/dag.py) fan out the SAME candidates.

    With ``fold_sigma`` set: fold everything at or above it, capped at
    ``max_folds`` — or, with ``max_folds_per_pass``, capped per accel
    pass (aligned with ``pass_zmaxes``, e.g. GBNCC's 20-lo + 10-hi
    split).  Otherwise: the top ``fold_top`` by sigma.

    ``policy`` is the opt-in triage seam: a callable
    ``policy(selected, cl, accounting) -> selected`` (e.g.
    `triage.TriagePolicy`) applied to the heuristic selection.  A
    policy may only reorder/drop — it sees the heuristic result, so
    every survivor folds with exactly the parameters an untriaged
    run would use.  ``None`` (the default) is the byte-stable
    heuristic path.

    ``accounting``, when a dict is passed, is filled with selection
    bookkeeping: ``above_sigma``, ``selected``, and — the per-pass
    trap this signature grew around — ``untagged_dropped``, the
    above-sigma candidates whose filename matched NO ``_ACCEL_<z>``
    pass tag and which the per-pass caps therefore silently excluded
    (also surfaced as a RuntimeWarning)."""
    ranked = sorted(cl.cands, key=lambda c: -c.sigma)
    acct = accounting if accounting is not None else {}
    acct.setdefault("untagged_dropped", 0)
    acct.setdefault("untagged", [])
    if fold_sigma is not None:
        above = [c for c in ranked if c.sigma >= fold_sigma]
        acct["above_sigma"] = len(above)
        if max_folds_per_pass:
            if len(max_folds_per_pass) != len(pass_zmaxes):
                raise ValueError(
                    "max_folds_per_pass has %d caps for %d accel "
                    "passes" % (len(max_folds_per_pass),
                                len(pass_zmaxes)))
            tags = tuple("_ACCEL_%d" % z for z in pass_zmaxes)
            untagged = [c for c in above
                        if not any(c.filename.endswith(t)
                                   for t in tags)]
            if untagged:
                # historically a SILENT drop: an above-sigma
                # candidate from a pass the caps don't name (stale
                # pass_zmaxes, a renamed ACCEL table) simply never
                # folded.  The exclusion stands (the caps define the
                # budget) but it is now counted and surfaced.
                acct["untagged_dropped"] = len(untagged)
                acct["untagged"] = [
                    (c.filename, c.candnum, c.sigma)
                    for c in untagged]
                warnings.warn(
                    "select_fold_candidates: %d above-sigma "
                    "candidate(s) match no _ACCEL_<zmax> pass tag "
                    "(passes %s) and are excluded from the per-pass "
                    "fold caps — first: %s:%d (sigma %.2f)"
                    % (len(untagged),
                       list(pass_zmaxes), untagged[0].filename,
                       untagged[0].candnum, untagged[0].sigma),
                    RuntimeWarning, stacklevel=2)
            top = []
            for tag, cap in zip(tags, max_folds_per_pass):
                top += [c for c in above
                        if c.filename.endswith(tag)][:cap]
        else:
            top = above[:max_folds]
    else:
        acct["above_sigma"] = len(ranked)
        top = ranked[:fold_top]
    acct["selected"] = len(top)
    if policy is not None:
        top = policy(top, cl, acct)
        acct["selected"] = len(top)
    return top


def sift_candidates(filenames: Sequence[str], numdms_min: int = 2,
                    low_DM_cutoff: float = 2.0,
                    known_birds_f=(), known_birds_p=(),
                    r_err: float = None,
                    policy: "SiftPolicy" = None) -> Candlist:
    """The ACCEL_sift.py recipe (python/ACCEL_sift.py:40-76):
    read -> reject -> dedup across DMs -> DM checks -> harmonics.
    An explicit r_err beats the policy's; default R_ERR otherwise."""
    if r_err is None:
        r_err = policy.r_err if policy is not None else R_ERR
    cl = read_candidates(filenames, True, known_birds_f, known_birds_p,
                         policy)
    dmlist = sorted({c.DMstr for c in cl})
    cl.remove_duplicate_candidates(r_err)
    if len(dmlist) > 1:
        cl.remove_DM_problems(numdms_min, dmlist, low_DM_cutoff)
    cl.remove_harmonics(r_err)
    cl.sort_by_sigma()
    return cl
