"""Calibration: label candidates for free against injected ground
truth, train the ranker, and report recall-at-budget.

Host copy of ``presto_tpu/triage/calibrate.py`` for the PyTorch port;
training and scoring run on the caller's ``device``.

The labeling trick (the whole reason triage can be trusted at all):
`models/inject.py` (the port's own) writes a ground-truth sidecar
(``<out>_injected.json``) beside every injected file, so any survey
or campaign that processed injected data carries its own eval set —
a sifted candidate matching an injected pulsar's (period, DM) within
tolerance (any harmonic) is a positive, everything else a negative.
``presto-triage`` rides that loop: featurize -> label -> seeded
train -> recall-at-budget report, continuously, with no human
labels.

The acceptance report comes from `synthetic_campaign` +
`acceptance_report`: a seeded multi-observation campaign of noise +
injected candidates, trained on a held-out prefix, evaluated on the
rest — recall at a fold reduction, deterministic under the seed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch.models.inject import truth_sidecar_path
from presto_tpu_torch.triage.features import featurize
from presto_tpu_torch.triage.model import TriageModel, train_model

#: harmonic ratios a matched candidate may sit at relative to the
#: injected spin frequency (ACCEL candidates routinely lock onto
#: harmonics and subharmonics)
_MAX_HARM = 16


def truth_matches(cands: Sequence, truth: Sequence[dict],
                  f_tol: float = 0.02, dm_tol: float = 3.0) \
        -> List[Optional[int]]:
    """Per-candidate index into ``truth`` (None = unmatched): the
    candidate's frequency sits within ``f_tol`` (fractional) of
    k*f_true or f_true/k for some harmonic k, and its DM within
    ``dm_tol`` of the injected DM."""
    out: List[Optional[int]] = []
    for c in cands:
        hit = None
        for ti, rec in enumerate(truth):
            ft = float(rec.get("f") or 0.0)
            if ft <= 0:
                p = float(rec.get("period") or 0.0)
                if p <= 0:
                    continue
                ft = 1.0 / p
            if abs(float(c.DM) - float(rec.get("dm", 0.0))) > dm_tol:
                continue
            for k in range(1, _MAX_HARM + 1):
                for f_h in (ft * k, ft / k):
                    if abs(float(c.f) - f_h) <= f_tol * f_h:
                        hit = ti
                        break
                if hit is not None:
                    break
            if hit is not None:
                break
        out.append(hit)
    return out


def label_candidates(cands: Sequence, truth: Sequence[dict],
                     f_tol: float = 0.02, dm_tol: float = 3.0) \
        -> np.ndarray:
    """[n] 0/1 labels: 1 where the candidate matches an injected
    pulsar."""
    m = truth_matches(cands, truth, f_tol=f_tol, dm_tol=dm_tol)
    return np.array([0.0 if x is None else 1.0 for x in m])


def recall_at_budget(cands: Sequence, scores: np.ndarray,
                     truth: Sequence[dict], budget: int,
                     f_tol: float = 0.02, dm_tol: float = 3.0) \
        -> Dict[str, float]:
    """Fraction of injected pulsars matched by at least one candidate
    inside the top-``budget`` by score (a pulsar recovered by ANY of
    its harmonics counts once)."""
    if not truth:
        return {"recall": 1.0, "budget": int(budget), "truth": 0}
    order = np.argsort(-np.asarray(scores, np.float64),
                       kind="stable")[:max(int(budget), 0)]
    kept = [cands[i] for i in order]
    matched = {m for m in truth_matches(kept, truth, f_tol=f_tol,
                                        dm_tol=dm_tol)
               if m is not None}
    return {"recall": len(matched) / len(truth),
            "budget": int(budget), "truth": len(truth),
            "recovered": len(matched)}


def train_on_observations(obs_sets: Sequence[Tuple[Sequence, Sequence[dict]]],
                          seed: int = 0, obs=None, init=None,
                          device="cuda") -> TriageModel:
    """Train one model over many (candidates, truth) observation
    pairs — the calibration loop's core, on ``device``.  Fully
    seeded (``init`` as in `train_model`); emits the
    ``triage-calibrate`` event when an obs context is provided."""
    Xs, ys = [], []
    for cands, truth in obs_sets:
        if not cands:
            continue
        Xs.append(featurize(cands))
        ys.append(label_candidates(cands, truth))
    if not Xs:
        raise ValueError("no candidates to train on")
    X = np.concatenate(Xs, axis=0)
    y = np.concatenate(ys, axis=0)
    model = train_model(X, y, seed=seed, init=init, device=device)
    if obs is not None:
        obs.events.emit("triage-calibrate", observations=len(obs_sets),
                        candidates=int(X.shape[0]),
                        positives=int(y.sum()), seed=int(seed))
    return model


# ----------------------------------------------------------------------
# synthetic campaign (the acceptance rig)
# ----------------------------------------------------------------------

def synthetic_observation(rng, n_noise: int = 400, n_psr: int = 2,
                          T: float = 120.0):
    """(candidates, truth): one synthetic observation's sifted
    survivors — a noise population whose sigma tail overlaps the
    injected pulsars', so a bare sigma cut cannot reach high recall
    at a tight budget, while DM-trial support / harmonic structure /
    power concentration separate the classes the way they do on real
    ACCEL tables."""
    from presto_tpu_torch.pipeline.sifting import Candidate
    cands, truth = [], []

    def _mk(num, sigma, numharm, ipow, cpow, r, z, dm, hits):
        c = Candidate(candnum=num, sigma=round(sigma, 2),
                      numharm=numharm, ipow_det=round(ipow, 2),
                      cpow=round(cpow, 2), r=round(r, 2),
                      z=round(z, 2), DMstr="%.2f" % dm,
                      filename="synth_DM%.2f_ACCEL_0" % dm, T=T)
        c.snr = float(np.sqrt(max(ipow - numharm, 0.0)))
        c.hits = hits
        return c

    num = 1
    for _ in range(n_noise):
        sigma = float(rng.gamma(2.0, 1.4) + 4.0)      # tail past 12
        dm = float(rng.uniform(2.0, 95.0))
        ipow = float(rng.gamma(2.0, 4.0) + 4.0)
        nh = int(rng.choice([1, 1, 1, 2, 2, 4]))
        # real ACCEL semantics: a single-harmonic candidate has
        # cpow == ipow (frac 1.0); incoherent summing only dilutes
        cpow = ipow if nh == 1 \
            else ipow * float(rng.uniform(0.35, 0.8))
        hits = [(dm, np.sqrt(max(ipow - nh, 0.0)), sigma)]
        for _extra in range(int(rng.poisson(0.3))):
            hits.append((dm + float(rng.normal(0, 1.0)),
                         float(rng.uniform(2, 4)),
                         sigma * float(rng.uniform(0.5, 0.9))))
        cands.append(_mk(num, sigma, nh, ipow, cpow,
                         float(rng.uniform(50, 5e4)),
                         float(rng.normal(0, 40.0)), dm,
                         sorted(hits)))
        num += 1
    for _ in range(n_psr):
        f = float(rng.uniform(0.8, 40.0))
        dm = float(rng.uniform(10.0, 80.0))
        sigma = float(rng.uniform(6.0, 60.0))
        nh = int(rng.choice([4, 8, 8, 16]))
        ipow = float(sigma ** 2 * rng.uniform(1.2, 1.8) + nh)
        nhits = int(rng.integers(6, 14))
        hits = sorted(
            (dm + float(rng.normal(0, 0.8)),
             float(np.sqrt(ipow) * rng.uniform(0.5, 1.0)),
             sigma * float(rng.uniform(0.6, 1.0)))
            for _h in range(nhits))
        # harmonic summing: the coherent (fundamental) power is a
        # ~1/nh slice of the summed power, a bit more for peaked
        # profiles — frac WELL BELOW a single-harmonic noise cand's
        cpow = ipow / nh * float(rng.uniform(1.0, 2.0))
        cands.append(_mk(num, sigma, nh, ipow,
                         min(cpow, ipow), f * T,
                         float(rng.normal(0, 6.0)), dm, hits))
        truth.append({"t": 0.0, "dm": dm, "f": f, "period": 1.0 / f,
                      "snr": sigma})
        num += 1
    return cands, truth


def synthetic_campaign(seed: int = 20, n_obs: int = 12, **kw):
    """[(candidates, truth)] for ``n_obs`` seeded observations."""
    rng = np.random.default_rng(int(seed))
    return [synthetic_observation(rng, **kw) for _ in range(n_obs)]


def acceptance_report(seed: int = 20, n_obs: int = 12,
                      train_frac: float = 0.5,
                      reduction: float = 5.0, device="cuda") -> dict:
    """The acceptance payload (the JAX package's TRIAGE_r20.json
    shape), trained and scored on ``device``: train on the first
    ``train_frac`` observations, evaluate recall on the rest at a
    fold budget ``reduction``x smaller than the heuristic
    selection's, and report both numbers plus determinism evidence
    (the eval ranking hashed twice from two independent scoring
    passes)."""
    import hashlib
    campaign = synthetic_campaign(seed=seed, n_obs=n_obs)
    n_train = max(int(n_obs * train_frac), 1)
    model = train_on_observations(campaign[:n_train], seed=seed,
                                  device=device)
    per_obs, rank_hashes = [], []
    deterministic = True
    tot_truth = tot_recovered = tot_heur = tot_folds = 0
    for cands, truth in campaign[n_train:]:
        scores = model.score_candidates(cands, device=device)
        scores2 = model.score_candidates(cands, device=device)
        order = np.argsort(-scores, kind="stable")
        rank_hashes.append(hashlib.sha256(
            (",".join(str(int(i)) for i in order)).encode())
            .hexdigest())
        deterministic &= np.array_equal(
            order, np.argsort(-scores2, kind="stable"))
        budget = max(int(len(cands) // reduction), 1)
        r = recall_at_budget(cands, scores, truth, budget)
        per_obs.append({"candidates": len(cands), **r})
        tot_truth += r["truth"]
        tot_recovered += r["recovered"]
        tot_heur += len(cands)
        tot_folds += budget
    return {
        "schema": 1,
        "seed": int(seed),
        "observations": {"total": n_obs, "train": n_train,
                         "eval": n_obs - n_train},
        "trained_on": int(model.trained_on),
        "recall": (tot_recovered / tot_truth) if tot_truth else 1.0,
        "injected": tot_truth,
        "recovered": tot_recovered,
        "heuristic_folds": tot_heur,
        "triage_folds": tot_folds,
        "fold_reduction": (tot_heur / tot_folds) if tot_folds else 0.0,
        "folds_avoided": tot_heur - tot_folds,
        "deterministic_ranking": bool(deterministic),
        "rank_hashes": rank_hashes,
        "per_observation": per_obs,
    }


# ----------------------------------------------------------------------
# sidecar discovery
# ----------------------------------------------------------------------

def find_truth_sidecars(paths: Sequence[str]) -> List[str]:
    """Existing ``*_injected.json`` sidecars for a list of data
    files (the DAG/campaign auto-discovery: plan_dag stamps these
    into the triage node spec so recall rides real traffic)."""
    out = []
    for p in paths:
        side = truth_sidecar_path(p)
        if os.path.exists(side):
            out.append(side)
    return out


def load_truth(path: str) -> List[dict]:
    """Records from one sidecar (empty on any structural problem —
    recall reporting degrades, selection never breaks)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return []
    recs = raw.get("injected") if isinstance(raw, dict) else None
    return [r for r in recs or [] if isinstance(r, dict)]
