"""The survey's device path: DDplan -> prepsubband -> rFFT -> search.

PyTorch counterpart of the head and the fused FFT + search stage of
``presto_tpu/pipeline/survey.py`` (``_survey_head`` and
``_seam_fft_search``).  ``survey_head`` plans the DM fan-out, streams
the filterbank through prepsubband into an in-memory seam (writing the
durable tier's ``.dat``/``.inf``), and ``seam_fft_search`` runs the
batched packed rFFT and ``AccelSearch.search_many`` over each seam
block, returning per-trial candidate lists after eliminate_harmonics
and remove_duplicates — the point where the JAX package's
refine_and_write starts polishing.

Not in this slice (a config that asks for them raises
NotImplementedError): rfifind, zapbirds, extra accel passes, single
pulse, polish and ACCEL files, sifting, folding, barycentring, elastic
runs and the serving hooks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from presto_tpu_torch.apps import prepsubband
from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.io import datfft
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.pipeline.ddplan import Observation, plan_dedispersion
from presto_tpu_torch.search.accel import (AccelCand, AccelConfig,
                                           AccelSearch,
                                           eliminate_harmonics,
                                           remove_duplicates,
                                           resolve_device)


@dataclass
class SurveyConfig:
    """Same field names as the JAX package's SurveyConfig."""
    lodm: float = 0.0
    hidm: float = 100.0
    nsub: int = 32
    rfi_time: float = 2.0
    zmax: int = 0
    numharm: int = 8
    sigma: float = 4.0
    flo: float = 1.0
    zaplist: Optional[str] = None
    accel_passes: Optional[tuple] = None
    min_dm_hits: int = 2
    low_dm_cutoff: float = 2.0
    fold_top: int = 3
    sift_policy: Optional[object] = None
    fold_sigma: Optional[float] = None
    max_folds: int = 150
    max_folds_per_pass: Optional[tuple] = None
    sp_threshold: float = 5.0
    sp_maxwidth: float = 0.0
    singlepulse: bool = True
    skip_rfifind: bool = False
    bary: bool = False
    plan_provider: Optional[object] = None
    fault_injector: Optional[object] = None
    verify_resume: bool = True
    elastic: Optional[object] = None
    obs: Optional[object] = None
    tune: Optional[bool] = None
    durable_stages: Optional[bool] = None
    inflight_depth: Optional[int] = None
    triage: Optional[object] = None


def _refuse_unported(cfg: SurveyConfig) -> None:
    asks = {
        "rfifind (set skip_rfifind=True)": not cfg.skip_rfifind,
        "zapbirds": cfg.zaplist,
        "extra accel passes": cfg.accel_passes,
        "single pulse (set singlepulse=False)": cfg.singlepulse,
        "folding (set fold_top=0)": cfg.fold_top or cfg.fold_sigma,
        "sifting policies": cfg.sift_policy or cfg.triage,
        "barycentring": cfg.bary,
        "elastic runs": cfg.elastic,
        "serving and telemetry hooks": (cfg.plan_provider or cfg.obs
                                        or cfg.fault_injector or cfg.tune),
    }
    for what, on in asks.items():
        if on:
            raise NotImplementedError(
                "survey: %s comes in a later slice of the port" % what)


def survey_head(rawfile: str, cfg: SurveyConfig, workdir: str = ".",
                device="cuda") -> fusion.StageSeam:
    """DDplan -> prepsubband per method, the fan-out deposited at an
    in-memory seam.  ``durable_stages`` (None -> True) also writes each
    trial's .dat; the .inf sidecars are always written."""
    _refuse_unported(cfg)
    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    rawfile = os.path.abspath(rawfile)
    base = os.path.join(workdir,
                        os.path.splitext(os.path.basename(rawfile))[0])
    fb = open_raw(rawfile)
    hdr = fb.header
    fb.close()
    observation = Observation(dt=hdr.tsamp, f_ctr=hdr.lofreq
                              + 0.5 * (hdr.nchans - 1) * abs(hdr.foff),
                              bw=hdr.nchans * abs(hdr.foff),
                              numchan=hdr.nchans)
    plan = plan_dedispersion(observation, cfg.lodm, cfg.hidm,
                             numsub=cfg.nsub)
    seam = fusion.StageSeam(workdir, durable=cfg.durable_stages
                            is not False)
    for m in plan.methods:
        argv = ["-lodm", str(m.lodm), "-dmstep", str(m.ddm),
                "-numdms", str(m.numdms), "-nsub", str(cfg.nsub),
                "-downsamp", str(m.downsamp), "-o", base, "-nobary",
                rawfile]
        prepsubband.run(prepsubband.build_parser().parse_args(argv),
                        device=device, seam=seam)
    return seam


def searcher_for(cfg: SurveyConfig, T: float, nbins: int,
                 device="cuda") -> AccelSearch:
    return AccelSearch(AccelConfig(zmax=cfg.zmax, numharm=cfg.numharm,
                                   sigma=cfg.sigma, flo=cfg.flo),
                       T=T, numbins=nbins, device=device)


def seam_fft_search(seam: fusion.StageSeam, cfg: SurveyConfig,
                    device="cuda") -> Dict[str, List[AccelCand]]:
    """Batched rFFT straight off each seam block, search_many on the
    device spectra, then eliminate_harmonics + remove_duplicates per
    trial.  Returns {trial base path: candidates}.  The durable tier
    also writes each trial's .fft."""
    _refuse_unported(cfg)
    resolve_device(device)
    out: Dict[str, List[AccelCand]] = {}
    for numout, blocks in sorted(seam.groups().items()):
        n = numout & ~1
        for block in blocks:
            pairs = fusion.fused_rfft_batch(block.series_dev[:, :n])
            T = block.numout * fusion.inf_float(block.dt)
            searcher = searcher_for(cfg, T, n // 2, device=device)
            results = searcher.search_many(pairs)
            for name, raw in zip(block.names, results):
                out[name] = remove_duplicates(eliminate_harmonics(raw))
            if seam.durable:
                host = pairs.cpu().numpy()
                for name, pr in zip(block.names, host):
                    datfft.write_fft(name + ".fft",
                                     fftpack.np_pairs_to_complex64(pr))
    return out
