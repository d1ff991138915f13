"""Survey recipes: complete, named end-to-end search policies.

Host copy of ``presto_tpu/pipeline/recipes.py`` for the PyTorch port,
which imports nothing from the JAX package: the same recipes, expanding
to the port's SurveyConfig.

The reference ships three battle-tested survey orchestrations
(bin/PALFA_presto_search.py, GBNCC_search.py, GBT350_drift_search.py)
whose value is the POLICY they encode — interval lengths, the lo/hi
acceleration-pass pair, sifting thresholds, fold selection, the
single-pulse settings, zaplist handling.  A recipe captures that
policy as data and expands to a ready SurveyConfig, so

    presto-pipeline --recipe palfa obs.fits

reproduces the PALFA flow end to end (and the policies are testable
on synthetic data).

Recipe values are taken from the reference drivers:
PALFA_presto_search.py:28-52, GBNCC_search.py:16-35,
GBT350_drift_search.py:16-35.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from presto_tpu_torch.pipeline.sifting import SiftPolicy
from presto_tpu_torch.pipeline.survey import SurveyConfig
from presto_tpu_torch.utils.catalog import default_birds_path


@dataclass(frozen=True)
class SurveyRecipe:
    name: str
    rfi_time: float                       # rfifind interval (s)
    # ((zmax, numharm, sigma, flo), ...): first is the primary pass;
    # flo is the per-pass low-frequency search limit in Hz
    # (lo_accel_flo=2.0 / hi_accel_flo=1.0, PALFA_presto_search.py:39-43)
    accel_passes: Tuple[Tuple[int, int, float, float], ...]
    sift: SiftPolicy
    fold_sigma: float                     # to_prepfold_sigma
    max_folds: int                        # max_cands_to_fold (combined)
    sp_threshold: float
    sp_maxwidth: float
    use_default_zaplist: bool = True
    nsub: int = 32
    # per-pass fold caps aligned with accel_passes, e.g. GBNCC's
    # 20-lo + 10-hi split (GBNCC_search.py:21-22); None -> one
    # combined max_folds cap (PALFA_presto_search.py:33)
    fold_caps_per_pass: Optional[Tuple[int, ...]] = None

    def to_config(self, lodm: float, hidm: float,
                  nsub: Optional[int] = None,
                  zaplist: Optional[str] = None) -> SurveyConfig:
        """Expand to a SurveyConfig for one DM range."""
        if zaplist is None and self.use_default_zaplist:
            zaplist = default_birds_path()
        (zmax0, nh0, sg0, flo0), *rest = self.accel_passes
        return SurveyConfig(
            lodm=lodm, hidm=hidm, nsub=nsub or self.nsub,
            rfi_time=self.rfi_time,
            zmax=zmax0, numharm=nh0, sigma=sg0, flo=flo0,
            accel_passes=tuple(rest) or None,
            zaplist=zaplist,
            sift_policy=self.sift,
            fold_sigma=self.fold_sigma, max_folds=self.max_folds,
            max_folds_per_pass=self.fold_caps_per_pass,
            sp_threshold=self.sp_threshold,
            sp_maxwidth=self.sp_maxwidth)


# -- the shipped recipes ------------------------------------------------

# PALFA (Arecibo L-band Feed Array; PALFA_presto_search.py:28-52):
# ~2.1 s RFI intervals, a zmax=0/numharm=16 low pass + a zmax=50/
# numharm=8 high pass, sift at to_prepfold_sigma-1, fold everything
# above 6 sigma capped at 150, single-pulse to 0.1 s widths.
PALFA = SurveyRecipe(
    name="palfa",
    rfi_time=2 ** 15 * 0.000064,          # 2.097 s
    accel_passes=((0, 16, 2.0, 2.0), (50, 8, 3.0, 1.0)),
    sift=SiftPolicy(sigma_threshold=5.0, c_pow_threshold=100.0,
                    short_period=0.0005, long_period=15.0,
                    harm_pow_cutoff=8.0, r_err=1.1),
    fold_sigma=6.0, max_folds=150,
    sp_threshold=5.0, sp_maxwidth=0.1,
    nsub=32)

# GBNCC (GBT 350 MHz Northern Celestial Cap; GBNCC_search.py:16-35):
# same lo/hi accel pair and thresholds at GBT 350 MHz sampling, with
# the per-pass fold budget (20 lo-accel + 10 hi-accel,
# GBNCC_search.py:21-22,479-486).
GBNCC = SurveyRecipe(
    name="gbncc",
    rfi_time=25600 * 0.00008192,          # 2.097 s
    accel_passes=((0, 16, 2.0, 2.0), (50, 8, 3.0, 1.0)),
    sift=SiftPolicy(sigma_threshold=5.0, c_pow_threshold=100.0,
                    short_period=0.0005, long_period=15.0,
                    harm_pow_cutoff=8.0, r_err=1.1),
    fold_sigma=6.0, max_folds=30, fold_caps_per_pass=(20, 10),
    sp_threshold=5.0, sp_maxwidth=0.1,
    nsub=32)

# GBT350 drift survey (GBT350_drift_search.py:16-35): GBNCC's policy
# (same lo/hi passes, same 20+10 per-pass fold caps,
# GBT350_drift_search.py:21-22) applied per drift-scan pointing.
# Split a raw drift scan into overlapping pointings first with
# `python -m presto_tpu_torch.apps.drift_prep` (the GBT350_drift_prep.py
# analog) or pass --driftprep to the pipeline app.
GBT350_DRIFT = replace(GBNCC, name="gbt350drift")

RECIPES = {r.name: r for r in (PALFA, GBNCC, GBT350_DRIFT)}


def get_recipe(name: str) -> SurveyRecipe:
    try:
        return RECIPES[name.lower()]
    except KeyError:
        raise ValueError("unknown survey recipe %r (have: %s)"
                         % (name, ", ".join(sorted(RECIPES))))
