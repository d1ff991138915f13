"""Deterministic candidate featurization for triage scoring.

Host copy of ``presto_tpu/triage/features.py`` for the PyTorch port;
the borderline fold features fold on the caller's device.

Every feature is derived from state the sift stage already holds —
the ACCEL/.cand table fields on `pipeline/sifting.Candidate` (sigma,
powers, harmonic count, r/z), the cross-DM-trial hit list the
duplicate sift accumulated, and the pass provenance encoded in the
ACCEL filename — so featurizing a million sift survivors is pure
host arithmetic, no device work and no file reads.

For *borderline* candidates only, `fold_profile_features` adds two
measured features (folded-profile reduced chi^2 and peak/RMS) through
the stacked folds (`search/prepfold.fold_series_batch`
-> `ops/fold.fold_data_batch`): the whole borderline set folds as ONE
batched drizzle dispatch per stack geometry, the same coalescing the
DAG fold stage rides.

Determinism contract: `featurize` is a pure function of the candidate
list (same candidates in the same order => the same float64 matrix on
any host), which is what makes a seeded model's ranking reproducible
across runs and filesystems.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np

#: column names of the featurize() matrix, in order (persisted into
#: the weights file so a stale model never silently scores a
#: different feature layout)
FEATURE_NAMES = (
    "sigma",            # sift sigma (the heuristic's whole story)
    "log_ipow",         # log1p incoherent summed power
    "log_cpow",         # log1p coherent power
    "cpow_frac",        # cpow / ipow: power concentration
    "log2_numharm",     # harmonic structure
    "snr",              # sqrt(ipow - numharm)
    "dm",               # trial DM
    "abs_z",            # |z|: accel provenance
    "log_f",            # log10 spin frequency
    "n_hits",           # DM-trial support (dedup'd hit count)
    "hit_sigma_span",   # max-min sigma across the DM hits
    "hit_snr_max",      # strongest single-trial SNR
    "hit_dm_span",      # DM extent of the support
    "pass_z",           # zmax of the accel pass that found it
)

_PASS_RE = re.compile(r"_ACCEL_(\d+)$")


def _pass_zmax(filename: str) -> float:
    m = _PASS_RE.search(filename or "")
    return float(m.group(1)) if m else -1.0


def featurize(cands: Sequence) -> np.ndarray:
    """[n, len(FEATURE_NAMES)] float64 feature matrix for a list of
    `pipeline/sifting.Candidate` rows.  Pure, order-preserving, and
    deterministic — no RNG, no file or device access."""
    out = np.zeros((len(cands), len(FEATURE_NAMES)), np.float64)
    for i, c in enumerate(cands):
        hits = list(c.hits or ())
        hsig = [float(h[2]) for h in hits]
        hsnr = [float(h[1]) for h in hits]
        hdm = [float(h[0]) for h in hits]
        ipow = max(float(c.ipow_det), 0.0)
        cpow = max(float(c.cpow), 0.0)
        out[i] = (
            float(c.sigma),
            np.log1p(ipow),
            np.log1p(cpow),
            cpow / ipow if ipow > 0 else 0.0,
            np.log2(max(int(c.numharm), 1)),
            float(c.snr),
            float(c.DM),
            abs(float(c.z)),
            np.log10(max(float(c.f), 1e-12)),
            float(len(hits)),
            (max(hsig) - min(hsig)) if hsig else 0.0,
            max(hsnr) if hsnr else 0.0,
            (max(hdm) - min(hdm)) if hdm else 0.0,
            _pass_zmax(c.filename),
        )
    return out


# ----------------------------------------------------------------------
# borderline fold features (one batched dispatch per geometry)
# ----------------------------------------------------------------------

#: names of the measured fold-feature columns appended for borderline
#: candidates (zeros + the absent flag when not computed)
FOLD_FEATURE_NAMES = ("fold_redchi", "fold_peak_rms")


def fold_profile_features(items: Sequence[Tuple[str, float, float]],
                          obs=None, device="cuda") -> np.ndarray:
    """[n, 2] measured fold features for ``items`` of
    ``(datfile, f0, fd0)``: the -nosearch folded profile's reduced
    chi^2 and its (peak-mean)/RMS.

    Items are grouped by the fold stack signature
    (`apps/prepfold.fold_stack_key`) and each group folds through
    `fold_series_batch` as ONE stacked drizzle dispatch — for a
    single-search borderline set (shared N/dt) that is one dispatch
    for the whole set, the coalescing the issue's budget math counts
    on.  A candidate whose .inf or .dat cannot be read scores on its
    cheap features alone (zeros here), as in the JAX package; the folds
    run on ``device``, and a fold that fails raises (no fallback)."""
    from presto_tpu_torch.apps.prepfold import (fold_geometry,
                                                fold_stack_key)
    from presto_tpu_torch.io.datfft import read_dat_with_inf
    from presto_tpu_torch.search.prepfold import (FoldConfig,
                                                  finish_fold_nosearch,
                                                  fold_series_batch)
    out = np.zeros((len(items), 2), np.float64)
    groups: dict = {}
    for idx, (datfile, f0, fd0) in enumerate(items):
        try:
            N, dt, proflen, subdiv = fold_geometry(datfile, f0, fd0)
        except Exception:
            continue
        key = fold_stack_key(N, dt, proflen, 64, subdiv)
        groups.setdefault(key, []).append(
            (idx, datfile, f0, fd0, proflen))
    for key in sorted(groups):
        rows = groups[key]
        batch, kept = [], []
        for idx, datfile, f0, fd0, proflen in rows:
            try:
                series, info = read_dat_with_inf(datfile)
            except Exception:
                continue
            cfg = FoldConfig(proflen=proflen, npart=64, nsub=1,
                             search_p=False, search_pd=False,
                             search_dm=False)
            batch.append((series, float(info.dt), f0, fd0, 0.0,
                          cfg, 0.0, 0.0))
            kept.append(idx)
        if not batch:
            continue
        results = finish_fold_nosearch(
            fold_series_batch(batch, device=device, obs=obs),
            device=device, obs=obs)
        for idx, res in zip(kept, results):
            prof = np.asarray(res.best_prof, np.float64)
            rms = float(prof.std())
            peak = (float(prof.max() - prof.mean()) / rms
                    if rms > 0 else 0.0)
            out[idx] = (float(res.best_redchi), peak)
    return out
