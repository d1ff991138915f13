"""Monte-Carlo binary-pulsar detection-efficiency campaign.

PyTorch counterpart of ``presto_tpu/pipeline/monte.py``.  The reference
validates its three binary-search methods with offline Monte-Carlo
studies (python/binresponses/monte_short.py, monte_ffdot.py,
monte_sideb.py): simulate orbits, run each method, record the detection
fraction as a function of orbital period over observation length.

The regimes
  Pb >> Tobs  -> acceleration (F-Fdot) search wins
  Pb << Tobs  -> phase-modulation (minifft / sideband) search wins
are measured per trial with randomized orbital phase.  The trials are
drawn on the host from ``np.random.default_rng(seed)`` in the JAX
package's order, so they are its trials float for float; each trial's
FFT, the acceleration search (search/accel.AccelSearch, both CUDA
kernels on the card) and the phase-modulation searches
(search/phasemod) run on ``device``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch.io.atomic import atomic_open
from presto_tpu_torch.models.synth import pulse_shape
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.ops.orbit import OrbitParams, orbit_delays
from presto_tpu_torch.search.accel import resolve_device


@dataclass
class MonteConfig:
    N: int = 1 << 19             # samples per trial
    dt: float = 1e-2             # seconds (T ~ 5240 s: orbits must
                                 # clear the search's MINORBP = 300 s)
    f_psr: float = 20.0          # pulsar spin frequency (Hz)
    amp: float = 0.2             # pulse amplitude (noise sigma = 1)
    width: float = 0.1           # gaussian pulse fractional width
    asini_lts: float = 0.2       # projected semi-major axis (lt-s);
                                 # modulation index 2*pi*f*x ~ 25 rad
    ecc: float = 0.0
    pb_over_t: tuple = (0.1, 0.3, 3.0, 10.0)   # orbital regimes
    ntrials: int = 8
    sigma_cut: float = 5.0       # detection threshold
    seed: int = 42

    @property
    def tobs(self) -> float:
        return self.N * self.dt


def _make_trial(cfg: MonteConfig, pb: float, rng) -> np.ndarray:
    """One binary-pulsar time series with random orbital phase."""
    t = (np.arange(cfg.N) + 0.5) * cfg.dt
    orb = OrbitParams(p=pb, x=cfg.asini_lts, e=cfg.ecc,
                      w=float(rng.uniform(0, 360)),
                      t=float(rng.uniform(0, pb)))
    tb = t - np.asarray(orbit_delays(t, orb))
    ph = cfg.f_psr * tb
    x = cfg.amp * pulse_shape(ph, "gauss", cfg.width)
    return (x + rng.normal(0.0, 1.0, cfg.N)).astype(np.float32)


def _make_accel(cfg: MonteConfig, numbins: int, device):
    """One AccelSearch per campaign — its kernel bank is reused across
    every trial (same shapes)."""
    from presto_tpu_torch.search.accel import AccelConfig, AccelSearch
    acfg = AccelConfig(zmax=50, numharm=4, sigma=cfg.sigma_cut,
                       uselen=1820)
    return AccelSearch(acfg, T=cfg.tobs, numbins=numbins, device=device)


def _detect_ffdot(cfg: MonteConfig, searcher, pairs: torch.Tensor
                  ) -> bool:
    """Acceleration-search detection: any candidate within 2 Hz of
    the spin frequency (or a harmonic) above the sigma cut."""
    for c in searcher.search(pairs):
        f = c.r / cfg.tobs
        for k in range(1, 5):
            if abs(f / k - cfg.f_psr) < 2.0:
                return True
    return False


def _detect_phasemod(cfg: MonteConfig, pairs: np.ndarray,
                     maxfft: int, device) -> bool:
    """Phase-modulation (minifft) detection: a rawbin candidate whose
    modulation frequency sits at the pulsar spin frequency."""
    from presto_tpu_torch.search.phasemod import (PhaseModConfig,
                                                  search_phasemod)
    pcfg = PhaseModConfig(minfft=max(maxfft // 8, 64), maxfft=maxfft)
    amps = pairs[..., 0] + 1j * pairs[..., 1]
    cands = search_phasemod(amps.astype(np.complex64), N=float(cfg.N),
                            dt=cfg.dt, cfg=pcfg, device=device)
    for c in cands:
        # same threshold as the ffdot column: the campaign compares
        # the two methods at one nominal cut
        if c.mini_sigma < cfg.sigma_cut or c.psr_p <= 0:
            continue
        if abs(1.0 / c.psr_p - cfg.f_psr) < 4.0:
            return True
    return False


def run_campaign(cfg: MonteConfig,
                 methods: Optional[List[str]] = None,
                 progress: bool = False, device="cuda") -> Dict:
    """Returns {pb_over_t: {method: detection_fraction}} (+ metadata),
    the searches on ``device``."""
    dev = resolve_device(device)
    methods = methods or ["ffdot", "short", "long"]
    rng = np.random.default_rng(cfg.seed)
    out: Dict = {"config": {k: getattr(cfg, k) for k in
                            ("N", "dt", "f_psr", "amp", "asini_lts",
                             "ecc", "ntrials", "sigma_cut")},
                 "results": {}}
    searcher = _make_accel(cfg, cfg.N // 2, dev) if "ffdot" in methods \
        else None
    for ratio in cfg.pb_over_t:
        pb = ratio * cfg.tobs
        hits = {m: 0 for m in methods}
        for trial in range(cfg.ntrials):
            x = _make_trial(cfg, pb, rng)
            pairs_d = fftpack.realfft_packed_pairs(
                torch.from_numpy(x - x.mean()).to(dev))
            if searcher is not None and _detect_ffdot(cfg, searcher,
                                                      pairs_d):
                hits["ffdot"] += 1
            pairs = pairs_d.cpu().numpy() if (
                "short" in methods or "long" in methods) else None
            if "short" in methods and _detect_phasemod(
                    cfg, pairs, maxfft=1024, device=dev):
                hits["short"] += 1
            if "long" in methods and _detect_phasemod(
                    cfg, pairs, maxfft=8192, device=dev):
                hits["long"] += 1
            if progress:
                print("  pb/T=%.2g trial %d/%d: %s" %
                      (ratio, trial + 1, cfg.ntrials,
                       {m: hits[m] for m in methods}))
        out["results"][str(ratio)] = {
            m: hits[m] / cfg.ntrials for m in methods}
    return out


def format_table(res: Dict) -> str:
    methods = sorted(next(iter(res["results"].values())).keys())
    lines = ["Pb/Tobs   " + "".join("%10s" % m for m in methods)]
    for ratio, fr in res["results"].items():
        lines.append("%-8s  " % ratio +
                     "".join("%10.2f" % fr[m] for m in methods))
    return "\n".join(lines)


def save_json(res: Dict, path: str) -> None:
    # a campaign is hours of trials; a kill mid-dump must leave the
    # previous complete results, not a truncated JSON a rerun trusts
    with atomic_open(path, "w") as f:
        json.dump(res, f, indent=1)
