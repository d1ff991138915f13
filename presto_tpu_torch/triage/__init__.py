"""Learned candidate triage: score sift survivors, fold only the
ones that matter.

PyTorch counterpart of ``presto_tpu/triage/``: cheap measured
features per candidate (triage/features.py), a small logistic ranker
persisted in the JAX package's schema-versioned weights file
(triage/model.py; a corrupted load degrades to the heuristic), and
calibration against injected ground truth (triage/calibrate.py,
``presto-triage``).

Triage is POLICY, never data path: it chooses *which* folds run, so
every fold artifact stays byte-equal to an untriaged run of the same
selection, and the heuristic sigma rank remains the byte-stable
default whenever triage is off, unconfigured, or its weights file is
unloadable.
"""

from presto_tpu_torch.triage.features import (FEATURE_NAMES, featurize,
                                              fold_profile_features)
from presto_tpu_torch.triage.model import (SCHEMA_VERSION,
                                           WEIGHTS_BASENAME, TriageModel,
                                           TriagePolicy, load_model,
                                           train_model)

__all__ = [
    "FEATURE_NAMES", "featurize", "fold_profile_features",
    "TriageModel", "TriagePolicy", "SCHEMA_VERSION",
    "WEIGHTS_BASENAME", "load_model", "train_model",
]
