"""The triage ranker: a small logistic scorer with a schema-versioned,
atomically-written weights file.

PyTorch counterpart of ``presto_tpu/triage/model.py``.  The score is
plain torch ops on the caller's device (default "cuda"; the JAX package
jits it with XLA) and training is full-batch gradient descent under
``torch.autograd``.  The weights file keeps the JAX package's schema 1
byte for byte (``TriageModel.to_doc``/``save``/``load_model``), so a
file saved by either package loads in the other.  There is no
environment override of the weights location: the path is an argument
(``TriagePolicy(weights_path=)``; None leaves the policy unconfigured,
the heuristic selection).

The durability rules are tune/db.py's, because the failure economics
are the same — a learned artifact must never be trusted over ground
truth, and a bad file on disk must never take the pipeline down:

  * loads are *defensive*: a missing, corrupted, stale-schema, or
    feature-layout-mismatched weights file degrades to ``None`` with
    a warning (callers then run the heuristic sigma rank, byte-equal
    to an untriaged run);
  * saves go through ``io/atomic``;
  * training is fully seeded: the init is ``init=(w0, b0)`` when given,
    else normals drawn from ``torch.Generator().manual_seed(seed)``
    (not the JAX package's ``jax.random.PRNGKey`` normals, which a
    torch generator cannot reproduce), then full-batch deterministic
    gradient descent, so the same labeled set, init and device give
    the same weights on every run.

Scoring is one batched call per candidate batch: standardize, clamp,
affine, sigmoid.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.triage.features import (FEATURE_NAMES,
                                              FOLD_FEATURE_NAMES,
                                              featurize,
                                              fold_profile_features)

SCHEMA_VERSION = 1

#: the weights file's conventional basename (the JAX package's)
WEIGHTS_BASENAME = "triage_weights.json"


@dataclass
class TriageModel:
    """Logistic scorer over the featurize() columns (plus optional
    measured fold-feature columns for borderline rescoring)."""

    w: List[float]
    b: float
    mean: List[float]
    scale: List[float]
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    #: weights for the borderline fold features (empty -> the model
    #: never consults measured fold features)
    fold_w: List[float] = field(default_factory=list)
    seed: int = 0
    trained_on: int = 0

    # -- scoring -------------------------------------------------------

    def score(self, X: np.ndarray, device="cuda") -> np.ndarray:
        """[n] scores in (0, 1) for an [n, F] feature matrix — one
        batched float32 call on ``device`` for the whole batch."""
        from presto_tpu_torch.search.accel import resolve_device
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[1] != len(self.w):
            raise ValueError("feature matrix is %r for %d weights"
                             % (X.shape, len(self.w)))
        device = resolve_device(device)
        if X.shape[0] == 0:
            return np.zeros(0)
        return _score(_f32(X, device), _f32(self.w, device),
                      _f32(self.b, device), _f32(self.mean, device),
                      _f32(self.scale, device)).cpu().numpy().astype(
                          np.float64)

    def score_candidates(self, cands: Sequence,
                         device="cuda") -> np.ndarray:
        return self.score(featurize(cands), device=device)

    def fold_adjust(self, scores: np.ndarray,
                    fold_feats: np.ndarray) -> np.ndarray:
        """Rescore with the measured fold features folded in (only
        meaningful for the borderline rows fold_feats was computed
        for; rows of zeros are adjusted by exactly 0)."""
        if not self.fold_w:
            return scores
        adj = np.asarray(fold_feats, np.float64) @ np.asarray(
            self.fold_w[:fold_feats.shape[1]], np.float64)
        return np.clip(scores + adj, 0.0, 1.0)

    # -- persistence ---------------------------------------------------

    def to_doc(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "kind": "triage-logistic",
            "feature_names": list(self.feature_names),
            "fold_feature_names": list(
                FOLD_FEATURE_NAMES[:len(self.fold_w)]),
            "w": [float(x) for x in self.w],
            "b": float(self.b),
            "mean": [float(x) for x in self.mean],
            "scale": [float(x) for x in self.scale],
            "fold_w": [float(x) for x in self.fold_w],
            "seed": int(self.seed),
            "trained_on": int(self.trained_on),
        }

    def save(self, path: str) -> None:
        from presto_tpu_torch.io.atomic import atomic_write_text
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        atomic_write_text(path, json.dumps(self.to_doc(), indent=1,
                                           sort_keys=True))


def load_model(path: str) \
        -> Tuple[Optional[TriageModel], Optional[str]]:
    """Defensive load: ``(model, None)`` on success, ``(None, why)``
    on any structural problem (missing file is ``(None, None)`` —
    absent is not an error, just unconfigured).  A poisoned or stale
    weights file must degrade the selection to the heuristic sigma
    rank, never crash it."""
    if not os.path.exists(path):
        return None, None
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        warnings.warn(
            "triage weights %s are unreadable (%s) — falling back to "
            "the heuristic fold selection" % (path, e),
            RuntimeWarning, stacklevel=2)
        return None, "unreadable: %s" % e
    why = _doc_why(raw)
    if why is not None:
        warnings.warn(
            "triage weights %s rejected (%s) — falling back to the "
            "heuristic fold selection" % (path, why),
            RuntimeWarning, stacklevel=2)
        return None, why
    return TriageModel(
        w=[float(x) for x in raw["w"]], b=float(raw["b"]),
        mean=[float(x) for x in raw["mean"]],
        scale=[float(x) for x in raw["scale"]],
        feature_names=tuple(raw["feature_names"]),
        fold_w=[float(x) for x in raw.get("fold_w") or []],
        seed=int(raw.get("seed", 0)),
        trained_on=int(raw.get("trained_on", 0))), None


def _doc_why(raw) -> Optional[str]:
    if not isinstance(raw, dict):
        return "not a JSON object"
    if raw.get("schema") != SCHEMA_VERSION:
        return "stale schema: %r" % (raw.get("schema"),)
    names = raw.get("feature_names")
    if tuple(names or ()) != FEATURE_NAMES:
        return "feature layout mismatch"
    for key in ("w", "mean", "scale"):
        v = raw.get(key)
        if not isinstance(v, list) or len(v) != len(FEATURE_NAMES) \
                or not all(isinstance(x, (int, float)) for x in v):
            return "malformed %r" % key
    if not isinstance(raw.get("b"), (int, float)):
        return "malformed 'b'"
    return None


# ----------------------------------------------------------------------
# score + seeded training (torch ops on the caller's device)
# ----------------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64),
                           dtype=torch.float32).to(device)


#: standardized features are clamped to +/- this many training-set
#: sigmas at score time: a candidate far outside the training
#: distribution (a 60-sigma pulsar scored by a model trained on
#: 6-14-sigma injections) saturates a feature's pull instead of
#: letting one wild column swamp every other signal
Z_CLIP = 8.0


def _score(X, w, b, mean, scale) -> torch.Tensor:
    """sigmoid(clip((X - mean) / scale) @ w + b) in float32: the JAX
    package's jitted score, term for term."""
    from presto_tpu_torch.search.accel import check_full_f32_matmul
    check_full_f32_matmul(X.device, "the triage score")
    Z = (X - mean[None, :]) / scale[None, :]
    Z = torch.clamp(Z, -Z_CLIP, Z_CLIP)
    return torch.sigmoid(Z @ w + b)


def train_model(X: np.ndarray, y: np.ndarray, seed: int = 0,
                epochs: int = 300, lr: float = 0.5,
                l2: float = 1e-3, init=None,
                device="cuda") -> TriageModel:
    """Seeded full-batch logistic regression on ``device``: the JAX
    package's loss, step and epoch count, float64 host-side
    standardization, float32 descent.  ``init=(w0, b0)`` sets the
    starting weights (the JAX package's init, to hold the two against
    each other); without it ``w0`` is 0.01 times normals drawn from
    ``torch.Generator().manual_seed(seed)`` and ``b0`` is 0.  The same
    labeled set, init and device yield the same weights."""
    from presto_tpu_torch.search.accel import (check_full_f32_matmul,
                                               resolve_device)
    device = resolve_device(device)
    check_full_f32_matmul(device, "triage training")
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    if X.ndim != 2 or X.shape[0] != y.shape[0] or X.shape[0] == 0:
        raise ValueError("bad training set: X %r, y %r"
                         % (X.shape, y.shape))
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale[scale <= 0] = 1.0
    Z = _f32((X - mean[None, :]) / scale[None, :], device)
    yj = _f32(y, device)
    if init is None:
        gen = torch.Generator().manual_seed(int(seed))
        w = 0.01 * torch.randn(X.shape[1], generator=gen,
                               dtype=torch.float32)
        b = torch.zeros((), dtype=torch.float32)
    else:
        w = torch.tensor(np.asarray(init[0], np.float32).reshape(
            X.shape[1]))
        b = torch.as_tensor(np.float32(init[1]))
    w = w.to(device)
    b = b.to(device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(int(epochs)):
        w.requires_grad_(True)
        b.requires_grad_(True)
        logits = Z @ w + b
        nll = torch.mean(torch.logaddexp(zero, logits) - yj * logits)
        loss = nll + l2 * torch.sum(w * w)
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w = w - lr * gw
            b = b - lr * gb
    w = w.detach().cpu().numpy()
    return TriageModel(
        w=[float(x) for x in w], b=float(b.detach().cpu()),
        mean=[float(x) for x in mean],
        scale=[float(x) for x in scale],
        seed=int(seed), trained_on=int(X.shape[0]))


# ----------------------------------------------------------------------
# the policy seam
# ----------------------------------------------------------------------

@dataclass
class TriagePolicy:
    """The opt-in fold-selection policy: rank the heuristic
    selection's candidates by learned score and keep the top
    ``budget``.

    Plugs into `pipeline/sifting.select_fold_candidates(policy=...)`,
    so the batch survey and the DAG triage node triage the SAME
    candidates.  Contract: the policy only ever *reorders and
    truncates* the heuristic selection — a selected candidate folds
    with exactly the parameters the heuristic path would have used,
    which is why fold artifacts stay byte-equal to an untriaged run
    of the same selection."""

    weights_path: Optional[str] = None     # None -> unconfigured
    budget: Optional[int] = None           # absolute fold budget
    budget_frac: Optional[float] = None    # else fraction of heuristic
    #: fraction of the budget boundary (each side) that gets measured
    #: fold features before the final cut; 0 disables the fold pass
    borderline_frac: float = 0.25
    #: resolved parent dir of .dat trials (the DAG node sets this);
    #: None -> cheap features only
    datdir: Optional[str] = None
    #: the device the score and the borderline folds run on
    device: object = "cuda"

    def resolve_budget(self, n: int) -> int:
        if self.budget is not None:
            return max(min(int(self.budget), n), 0)
        if self.budget_frac is not None:
            return max(min(int(np.ceil(n * float(self.budget_frac))),
                           n), 1 if n else 0)
        return n

    def __call__(self, heuristic: Sequence, cl=None,
                 accounting: Optional[dict] = None) -> List:
        selected, acct = self.select(heuristic)
        if accounting is not None:
            accounting.setdefault("triage", acct)
        return selected

    def select(self, heuristic: Sequence, obs=None) \
            -> Tuple[List, dict]:
        """(selected, accounting).  With no weights path, or on any
        weights problem, the input list comes back UNCHANGED (same
        objects, same order) — the byte-stable heuristic default."""
        heuristic = list(heuristic)
        acct = {"mode": "heuristic", "scored": 0,
                "selected": len(heuristic), "folds_avoided": 0,
                "budget": None, "load_error": None}
        model = None
        if self.weights_path:
            model, load_error = load_model(self.weights_path)
            acct["load_error"] = load_error
        if model is None or not heuristic:
            return heuristic, acct
        scores = model.score_candidates(heuristic, device=self.device)
        budget = self.resolve_budget(len(heuristic))
        order = _rank(heuristic, scores)
        if model.fold_w and self.datdir and 0 < budget < len(order):
            scores = self._borderline_rescore(
                heuristic, scores, order, budget, model, obs=obs)
            order = _rank(heuristic, scores)
        keep = set(order[:budget])
        # keep the heuristic's (sigma-rank) order among survivors so
        # fold numbering — and therefore artifact bytes — match an
        # untriaged run of the same selection
        selected = [c for i, c in enumerate(heuristic) if i in keep]
        acct.update(mode="triage", scored=len(heuristic),
                    selected=len(selected), budget=budget,
                    folds_avoided=len(heuristic) - len(selected),
                    scores=[round(float(s), 6) for s in scores])
        return selected, acct

    def _borderline_rescore(self, heuristic, scores, order, budget,
                            model, obs=None) -> np.ndarray:
        """Measured fold features for the candidates straddling the
        budget cut (one stacked fold on the policy's device), folded
        into their scores."""
        half = max(int(np.ceil(budget * self.borderline_frac)), 1)
        lo = max(budget - half, 0)
        hi = min(budget + half, len(order))
        border = order[lo:hi]
        items = []
        for i in border:
            c = heuristic[i]
            base = os.path.join(self.datdir, c.filename)
            datbase = base.split("_ACCEL_")[0]
            items.append((datbase + ".dat", float(c.f), 0.0))
        feats = fold_profile_features(items, obs=obs, device=self.device)
        out = np.array(scores, np.float64)
        out[border] = model.fold_adjust(out[border], feats)
        return out


def _rank(cands: Sequence, scores: np.ndarray) -> List[int]:
    """Indices by (score desc, sigma desc, filename, candnum) — the
    trailing keys make exact ties deterministic across filesystems."""
    return sorted(
        range(len(cands)),
        key=lambda i: (-float(scores[i]), -float(cands[i].sigma),
                       str(cands[i].filename),
                       int(cands[i].candnum)))
