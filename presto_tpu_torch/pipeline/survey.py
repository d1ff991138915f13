"""One-command search pipeline: filterbank -> folded candidates.

PyTorch counterpart of ``presto_tpu/pipeline/survey.py``: ``run_survey``
runs rfifind (unless ``skip_rfifind``) -> DDplan -> prepsubband with
the rfifind mask (the DM fan-out deposited at an in-memory stage seam)
-> single-pulse search of the seam-resident series (stage 9a) ->
batched packed rFFT -> accelsearch on the device spectra -> polish
-> ACCEL/.cand files -> ACCEL_sift -> prepfold of the top candidates ->
single_pulse_search of any trial still without a verified .singlepulse
(stage 9), with the JAX package's artifacts (_rfifind.mask/.stats/.inf
and _rfifind_quality.json, .dat/.inf/.singlepulse/.fft/_ACCEL_<zmax>/
.cand/cands_sifted.txt/fold_candN.pfd and .pfd.bestprof) and its
journal: artifacts are recorded with size and CRC-32 in the workdir's
manifest.json, and a stage is skipped on a rerun only when its outputs
verify.  rfifind, the folds and single_pulse_search run without their
plots (-noplot, -p): the JAX package's _rfifind.png, fold_candN.pfd.png
and _singlepulse.png are not written.

With more than one device visible (parallel/mesh.visible_devices: every
card, or logical shards) prepsubband deposits a DM-sharded seam block,
and the FFT, the search and stage 9a run on each shard's device in place
(seam_fft_search, seam_singlepulse).  ``cfg.elastic`` runs each
prepsubband method as leased shards (prepsubband -elastic, the trials
then flow through the disk consumers); ``cfg.fault_injector``
(testing/chaos.FaultInjector) is called at the JAX package's kill points.
The FFT of a sharded seam chunk is queued on the mesh before the
previous one's search collects (StageSeam.depth).

The serving and telemetry hooks: ``cfg.plan_provider``
(serve/plancache.SearcherProvider) builds the searchers, so a resident
service shares one plan per trial geometry across jobs; ``cfg.obs``
(an ObsConfig or Observability) records the survey's spans, its
dispatches and their analytic costs (obs/devtel, obs/costmodel) and
writes them beside the artifacts; ``cfg.tune`` scopes the tuning-DB
lookups (presto_tpu_torch/tune) and writes ``tuned.json``.
``run_survey_stacked`` runs N same-geometry surveys with their device
middle stacked (serve/batchexec's executor).

Not in this slice (a config that asks for them raises
NotImplementedError): zapbirds, barycentring and triage.
"""

from __future__ import annotations

import contextlib
import glob
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import tune as _tune
from presto_tpu_torch.apps import (prepfold, prepsubband, rfifind,
                                   single_pulse_search)
from presto_tpu_torch.apps.accelsearch import refine, write_results
from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.atomic import cleanup_stale_tmp
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.io.quality import DataQualityReport
from presto_tpu_torch.obs import costmodel, devtel, resolve_obs
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.pipeline import fusion
from presto_tpu_torch.pipeline.ddplan import Observation, plan_dedispersion
from presto_tpu_torch.pipeline.manifest import SurveyManifest
from presto_tpu_torch.pipeline.sifting import (select_fold_candidates,
                                               sift_candidates)
from presto_tpu_torch.search.accel import (AccelCand, AccelConfig,
                                           AccelSearch, resolve_device)
from presto_tpu_torch.search.singlepulse import (SinglePulseSearch,
                                                 read_singlepulse,
                                                 write_singlepulse)
from presto_tpu_torch.utils.timing import StageTimer

FFT_CHUNK_BYTES = 1 << 30    # series bytes per batched rFFT + search


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
    # extra accelsearch passes beyond (zmax, numharm, sigma[, flo]):
    # (zmax, numharm, sigma) or (zmax, numharm, sigma, flo) each
    accel_passes: Optional[tuple] = None
    min_dm_hits: int = 2
    low_dm_cutoff: float = 2.0
    fold_top: int = 3
    sift_policy: Optional[object] = None   # sifting.SiftPolicy
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

    @property
    def all_passes(self):
        """Normalized 4-tuples (zmax, numharm, sigma, flo)."""
        raw = ((self.zmax, self.numharm, self.sigma, self.flo),) + \
            tuple(self.accel_passes or ())
        return tuple(p if len(p) == 4 else tuple(p) + (self.flo,)
                     for p in raw)


@dataclass
class SurveyResult:
    workdir: str
    maskfile: Optional[str] = None
    datfiles: List[str] = field(default_factory=list)
    candfile: str = ""
    folded: List[str] = field(default_factory=list)
    sp_events: int = 0
    sifted: Optional[object] = None      # sifting.Candlist
    quality: Optional[DataQualityReport] = None   # rfifind's ingest report


def _refuse_unported(cfg: SurveyConfig) -> None:
    asks = {
        "zapbirds": cfg.zaplist,
        "triage": cfg.triage,
        "barycentring": cfg.bary,
    }
    for what, on in asks.items():
        if on:
            raise NotImplementedError(
                "survey: %s comes in a later slice of the port" % what)


def _chaos(cfg: SurveyConfig, point: str) -> None:
    """Fire the configured fault injector at a named kill point."""
    if cfg.fault_injector is not None:
        cfg.fault_injector.point(point)


def _elastic_argv(elastic_cfg) -> List[str]:
    """A SurveyConfig.elastic value (True or an ElasticConfig) as
    prepsubband -elastic flags."""
    argv = ["-elastic"]
    if elastic_cfg is True:
        return argv
    for flag, attr in (("-shard-rows", "shard_rows"),
                       ("-lease-ttl", "lease_ttl"),
                       ("-barrier-timeout", "barrier_timeout"),
                       ("-heartbeat-interval", "heartbeat_interval")):
        val = getattr(elastic_cfg, attr, None)
        if val:
            argv += [flag, str(val)]
    return argv


def _stage(done_glob: str, workdir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(workdir, done_glob)))


def _valid(manifest, path: str) -> bool:
    """Trustworthy for resume: with a manifest, exists and matches its
    journaled size + checksum; without (verify_resume=False), exists."""
    if manifest is None:
        return os.path.exists(path)
    return manifest.valid(path)


def _record(manifest, paths, stage: str) -> None:
    if manifest is not None:
        manifest.record_many([p for p in paths if os.path.exists(p)],
                             stage)


def _drop_stale(manifest, paths) -> List[str]:
    """Delete + forget artifacts that fail verification; returns the
    surviving (valid) subset."""
    if manifest is None:
        return [p for p in paths if os.path.exists(p)]
    stale = set(manifest.invalidate_stale(paths))
    return [p for p in paths if p not in stale]


def _base(rawfiles, workdir: str) -> str:
    return os.path.join(workdir, os.path.splitext(
        os.path.basename(rawfiles[0]))[0])


def rfifind_stage(rawfiles, cfg: SurveyConfig, base: str, device="cuda",
                  manifest=None):
    """Stage 1: rfifind -time cfg.rfi_time -noplot into base_rfifind.*
    and base_rfifind_quality.json, journaled; skipped when the mask
    verifies (a stale set is dropped first).  Returns (mask path, the
    ingest quality report or None)."""
    mask = base + "_rfifind.mask"
    qpath = base + "_rfifind_quality.json"
    if not _valid(manifest, mask):
        _drop_stale(manifest, glob.glob(base + "_rfifind.*") + [qpath])
        rfifind.main(["-time", str(cfg.rfi_time), "-noplot", "-o", base]
                     + list(rawfiles), device=device)
        _record(manifest, glob.glob(base + "_rfifind.*") + [qpath],
                "rfifind")
    quality = None
    if os.path.exists(qpath):
        try:
            quality = DataQualityReport.read(qpath)
        except (OSError, ValueError):
            pass
    return mask, quality


def survey_head(rawfiles, cfg: SurveyConfig, workdir: str = ".",
                device="cuda", manifest=None, res: SurveyResult = None,
                timer=None, obs=None) -> fusion.StageSeam:
    """rfifind (unless cfg.skip_rfifind) -> DDplan -> prepsubband per
    method with the rfifind mask, the fan-out deposited at an in-memory
    seam (sharded over the mesh when prepsubband takes it).
    ``durable_stages`` (None -> True) also writes each trial's .dat; the
    .inf sidecars are always written.  With ``cfg.elastic`` each method
    runs as prepsubband -elastic and writes its files (the seam stays
    empty).  A method whose .dat files all verify (a resumed run) is
    skipped: its trials are left on disk, outside the seam.  ``res``
    receives the mask path and the quality report; ``timer`` the rfifind
    and prepsubband stages; ``obs`` the dedispersion steps' dispatches."""
    _refuse_unported(cfg)
    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    if isinstance(rawfiles, str):
        rawfiles = [rawfiles]
    rawfiles = [os.path.abspath(f) for f in rawfiles]
    base = _base(rawfiles, workdir)
    maskfile = None
    _chaos(cfg, "pre-rfifind")
    if not cfg.skip_rfifind:
        if timer is not None:
            timer.mark("rfifind")
        maskfile, quality = rfifind_stage(rawfiles, cfg, base, device,
                                          manifest)
        if res is not None:
            res.maskfile, res.quality = maskfile, quality
    _chaos(cfg, "post-rfifind")
    if timer is not None:
        timer.mark("prepsubband")
    fb = open_raw(rawfiles)
    hdr = fb.header
    fb.close()
    observation = Observation(dt=hdr.tsamp, f_ctr=hdr.lofreq
                              + 0.5 * (hdr.nchans - 1) * abs(hdr.foff),
                              bw=hdr.nchans * abs(hdr.foff),
                              numchan=hdr.nchans)
    plan = plan_dedispersion(observation, cfg.lodm, cfg.hidm,
                             numsub=cfg.nsub)
    print("survey: DDplan -> %d methods, %d total DMs"
          % (len(plan.methods), plan.total_numdms))
    _chaos(cfg, "pre-prepsubband")
    seam = fusion.StageSeam(workdir, durable=cfg.durable_stages
                            is not False, manifest=manifest,
                            inflight_depth=cfg.inflight_depth, obs=obs)
    dat_glob = os.path.basename(base) + "_DM*.dat"
    # verify a previous run's survivors once, before the loop: this
    # run's own outputs are journaled as each method lands
    _drop_stale(manifest, _stage(dat_glob, workdir))
    for m in plan.methods:
        have = _stage(dat_glob, workdir)
        if all(any("_DM%.2f.dat" % dm in f for f in have) for dm in m.dms):
            continue
        argv = ["-lodm", str(m.lodm), "-dmstep", str(m.ddm),
                "-numdms", str(m.numdms), "-nsub", str(cfg.nsub),
                "-downsamp", str(m.downsamp), "-o", base, "-nobary"]
        if maskfile and os.path.exists(maskfile):
            argv += ["-mask", maskfile]
        if cfg.elastic:
            # the leased-shard fan-out; the injector reaches the elastic
            # loop through its process seam (argv carries no objects)
            from presto_tpu_torch.parallel import elastic
            elastic.set_process_injector(cfg.fault_injector)
            try:
                prepsubband.run(prepsubband.build_parser().parse_args(
                    argv + _elastic_argv(cfg.elastic) + rawfiles),
                    device=device)
            finally:
                elastic.set_process_injector(None)
            _chaos(cfg, "elastic-method")
        else:
            prepsubband.run(prepsubband.build_parser().parse_args(
                argv + rawfiles), device=device, seam=seam)
        done = _stage(dat_glob, workdir)
        _record(manifest, done + [f[:-4] + ".inf" for f in done],
                "prepsubband")
        _chaos(cfg, "prepsubband-method")
    n_sharded = sum(len(b.names) for b in seam.blocks
                    if fusion.is_sharded(b))
    _chaos(cfg, "seam-handoff")
    if n_sharded:
        _chaos(cfg, "shard-seam-handoff")
    _chaos(cfg, "post-prepsubband")
    return seam


def searcher_for(cfg: SurveyConfig, T: float, nbins: int,
                 device="cuda") -> AccelSearch:
    """One accel searcher for a (pass config, duration, length): through
    ``cfg.plan_provider`` when a resident service shares one
    (serve/plancache), so same-shaped trial groups reuse one plan."""
    acfg = AccelConfig(zmax=cfg.zmax, numharm=cfg.numharm,
                       sigma=cfg.sigma, flo=cfg.flo)
    if cfg.plan_provider is not None:
        return cfg.plan_provider.searcher(acfg, T, nbins, device=device)
    return AccelSearch(acfg, T=T, numbins=nbins, device=device)


def _column_slab(searcher, obs=None) -> int:
    """The search's column slab: the tuning DB's ``accel_column_slab``
    for this geometry when tuning is active, else search_many's default
    (every slab gives the same candidate lists)."""
    slab = 1 << 20
    if _tune.enabled():
        from presto_tpu_torch.tune.space import key_column_slab
        best = _tune.best("accel_column_slab", key_column_slab(
            searcher.cfg.numz, searcher.cfg.numharm, searcher.numbins),
            obs=obs)
        if best and int(best.get("slab", 0)) > 0:
            slab = int(best["slab"])
    return slab


def _pass_configs(cfg: SurveyConfig) -> List[SurveyConfig]:
    """One single-pass config per accel pass."""
    return [replace(cfg, zmax=z, numharm=nh, sigma=sg, flo=flo,
                    accel_passes=None)
            for (z, nh, sg, flo) in cfg.all_passes]


def _accel_names(name: str, cfg: SurveyConfig) -> List[str]:
    """A trial's ACCEL table and .cand companion for every pass."""
    out = []
    for (zmax, _nh, _sg, _flo) in cfg.all_passes:
        acc = name + "_ACCEL_%d" % zmax
        out += [acc, acc + ".cand"]
    return out


def _search_and_write(pairs, names, T, cfg, device, manifest, timer,
                      out, stage, mesh=None, obs=None) -> None:
    """Every accel pass over one batch of device spectra: search_many,
    then refine + write_results per trial (the polish on the spectrum's
    device, ACCEL and .cand files), journaled under ``stage``.  With a
    ``mesh`` ``pairs`` is the list of per-shard spectra, searched where
    they are.  ``obs`` books each pass as one accel_search dispatch and
    a plane_build and a stage_reduce launch a trial, with their costs."""
    trials = ([p[j] for p in pairs for j in range(p.shape[0])]
              if mesh is not None else list(pairs))
    n = trials[0].shape[0]
    for pcfg in _pass_configs(cfg):
        searcher = searcher_for(pcfg, T, n, device=device)
        slab = _column_slab(searcher, obs)
        costmodel.probe_search(obs, searcher, len(trials), slab=slab)
        devtel.note_dispatch(obs, "accel_search")
        devtel.note_dispatch(obs, "plane_build", len(trials))
        devtel.note_dispatch(obs, "stage_reduce", len(trials))
        results = searcher.search_many(pairs, mesh=mesh, slab=slab)
        arts = []
        for name, pr, raw in zip(names, trials, results):
            trace = refine(raw, pr, T, searcher, timer=timer,
                           device=pr.device)
            acc = write_results(trace, T, name, pcfg.zmax, quiet=True,
                                timer=timer)
            out[acc] = trace.final
            arts += [acc, acc + ".cand"]
        _record(manifest, arts, stage)


def _write_ffts(pairs, names, manifest, stage, obs=None) -> None:
    """The .fft of each trial of a batch of device spectra (a tensor, or
    the per-shard list: one copy down a shard)."""
    host = (np.concatenate([p.cpu().numpy() for p in pairs])
            if isinstance(pairs, list) else pairs.cpu().numpy())
    devtel.note_get(obs, host.nbytes)
    for name, pr in zip(names, host):
        datfft.write_fft(name + ".fft", fftpack.np_pairs_to_complex64(pr))
    _record(manifest, [name + ".fft" for name in names], stage)


def seam_fft_search(seam: fusion.StageSeam, cfg: SurveyConfig,
                    device="cuda", manifest=None, timer=None, obs=None
                    ) -> Dict[str, List[AccelCand]]:
    """Every accel pass over the seam-resident series: batched rFFT
    straight off each seam block, search_many on the device spectra,
    then per trial refine + write_results (eliminate_harmonics,
    remove_duplicates, the polish, ACCEL + .cand).  The durable tier
    also writes each trial's .fft.  Trials whose ACCEL files (and, on
    the durable tier, .fft) all verify are skipped.  A whole sharded
    block is one chunk: each shard's rows are transformed, searched and
    polished on its own device, the chunk's FFT queued on the mesh
    before the previous sharded chunk's search collects (at most
    seam.depth in flight; a one-device chunk is searched at once).  A
    partially resumed sharded block moves its rows to ``device`` and
    takes the one-device path.  ``obs`` books the rFFT and search
    dispatches and the copies.  Returns {ACCEL path: final candidates}
    for the trials searched."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    out: Dict[str, List[AccelCand]] = {}
    pending = []

    def collect(ent) -> None:
        block, chunk, pairs, mesh = ent
        T = block.numout * fusion.inf_float(block.dt)
        names = [block.names[r] for r in chunk]
        _search_and_write(pairs, names, T, cfg, device, manifest, timer,
                          out, "fft+accel", mesh=mesh, obs=obs)
        if seam.durable:
            _write_ffts(pairs, names, manifest, "fft+accel", obs=obs)
        devtel.sample_live_buffers(obs, dev)
        _chaos(cfg, "fused-chunk")
        if mesh is not None:
            _chaos(cfg, "sharded-fused-chunk")

    for numout, blocks in sorted(seam.groups().items()):
        n = numout & ~1
        for block in blocks:
            arts = [a for name in block.names
                    for a in _accel_names(name, cfg)]
            _drop_stale(manifest, arts)
            rows = [row for row, name in enumerate(block.names)
                    if not all(_valid(manifest, a)
                               for a in _accel_names(name, cfg))
                    or (seam.durable
                        and not _valid(manifest, name + ".fft"))]
            if not rows:
                seam.release(block)
                continue
            sharded = fusion.is_sharded(block)
            # the memory budget is a device's: a whole sharded block
            # holds numdms / ndev rows on each
            per = max(1, FFT_CHUNK_BYTES // (n * 4)) * (
                block.mesh.size if sharded else 1)
            whole = rows == list(range(len(block.names)))
            mesh = (block.mesh if sharded and whole and len(rows) <= per
                    else None)
            for g0 in range(0, len(rows), per):
                chunk = rows[g0:g0 + per]
                if mesh is not None:
                    series = [p[:, :n] for p in block.series_dev]
                elif sharded:
                    series = torch.stack([block.row_on(r, dev)[:n]
                                          for r in chunk])
                elif whole and len(chunk) == len(rows):
                    series = block.series_dev[:, :n]
                else:
                    series = block.series_dev[chunk, :n]
                parts = series if mesh is not None else [series]
                costmodel.probe(obs, "rfft_batch", rows=parts[0].shape[0],
                                n=n)
                devtel.note_dispatch(obs, "rfft_batch", len(parts))
                pairs = fusion.fused_rfft_batch(series, mesh=mesh)
                del series, parts
                if g0 + per >= len(rows):
                    # the block's last FFT chunk has consumed its series:
                    # its memory goes back before the chunk's search
                    devtel.note_donation(obs, len(block.names)
                                         * block.numout * 4)
                    seam.release(block)
                pending.append((block, chunk, pairs, mesh))
                window = seam.depth if mesh is not None else 1
                while len(pending) >= window:
                    collect(pending.pop(0))
    while pending:
        collect(pending.pop(0))
    return out


def _length_groups(files, item_bytes):
    """Group files by payload length (dict length -> file list)."""
    by_len: Dict[int, List[str]] = {}
    for f in files:
        by_len.setdefault(item_bytes(os.path.getsize(f)), []).append(f)
    return by_len


def _trial_T(first_file: str) -> float:
    info = read_inf(first_file[:-4] + ".inf")
    return info.N * info.dt


def _fused_fft_search(datfiles, cfg, device, manifest, timer,
                      obs=None) -> None:
    """Disk trials (outside the seam) with no verified .fft: batched
    rFFT on the device, search, .fft + ACCEL files for the first pass.
    Trials with a verified .fft are left to _batched_accelsearch."""
    _drop_stale(manifest, [f[:-4] + ".fft" for f in datfiles])
    todo = [f for f in datfiles if not _valid(manifest, f[:-4] + ".fft")]
    if not todo:
        return
    dev = resolve_device(device)
    first = _pass_configs(cfg)[0]
    for n, files in _length_groups(todo, lambda sz: (sz // 4) & ~1).items():
        T = _trial_T(files[0])
        per = max(1, FFT_CHUNK_BYTES // max(n * 4, 1))
        for g0 in range(0, len(files), per):
            chunk = files[g0:g0 + per]
            arr = np.stack([datfft.read_dat(f)[:n] for f in chunk])
            devtel.note_put(obs, arr.nbytes)
            costmodel.probe(obs, "rfft_batch", rows=len(chunk), n=n)
            devtel.note_dispatch(obs, "rfft_batch")
            pairs = fftpack.realfft_packed_pairs(
                torch.as_tensor(arr, device=dev))
            names = [f[:-4] for f in chunk]
            _write_ffts(pairs, names, manifest, "fft+accel", obs=obs)
            _search_and_write(pairs, names, T, first, device, manifest,
                              timer, {}, "fft+accel", obs=obs)
            _chaos(cfg, "fused-chunk")
    print("survey: fused realfft+accelsearch over %d disk trials"
          % len(todo))


def _batched_accelsearch(fftfiles, cfg, device, manifest, timer,
                         obs=None) -> None:
    """One accel pass (``cfg`` from _pass_configs) over .fft files
    already on disk whose ACCEL table or .cand companion (one logical
    artifact) does not verify."""
    accs = [f[:-4] + "_ACCEL_%d" % cfg.zmax for f in fftfiles]
    _drop_stale(manifest, accs + [a + ".cand" for a in accs])
    todo = [f for f, a in zip(fftfiles, accs)
            if not (_valid(manifest, a) and _valid(manifest, a + ".cand"))]
    if not todo:
        return
    dev = resolve_device(device)
    for nbins, files in _length_groups(todo, lambda sz: sz // 8).items():
        T = _trial_T(files[0])
        per = max(1, FFT_CHUNK_BYTES // max(nbins * 8, 1))
        for g0 in range(0, len(files), per):
            chunk = files[g0:g0 + per]
            batch = np.stack([fftpack.np_complex64_to_pairs(
                datfft.read_fft(f)) for f in chunk])
            devtel.note_put(obs, batch.nbytes)
            _search_and_write(torch.as_tensor(batch, device=dev),
                              [f[:-4] for f in chunk], T, cfg, device,
                              manifest, timer, {}, "accel", obs=obs)
            _chaos(cfg, "accel-chunk")
    print("survey: accelsearch over %d trials (batched)" % len(todo))


def run_survey(rawfiles: Sequence[str], cfg: SurveyConfig,
               workdir: str = ".", timer=None,
               device="cuda") -> SurveyResult:
    """The survey from filterbank to the folds of its top candidates
    (see the module docstring).  ``timer`` (utils/timing.StageTimer,
    made here when None) receives the stages; it is reported on exit.
    With ``cfg.obs`` enabled the run is one ``survey`` span, a death
    leaves a flight-recorder dump in the workdir, and the spans and the
    kernel-cost book are written there on exit."""
    _refuse_unported(cfg)
    resolve_device(device)
    obs = resolve_obs(cfg.obs)
    os.makedirs(workdir, exist_ok=True)
    rawfiles = [os.path.abspath(f) for f in rawfiles]
    res = SurveyResult(workdir=workdir)
    # crash-safe resume: sweep a killed run's in-flight temp files, then
    # load the artifact journal this run verifies against and appends to
    cleanup_stale_tmp(workdir)
    manifest = SurveyManifest.load(workdir) if cfg.verify_resume else None
    if timer is None:
        timer = StageTimer(obs=obs)
    root = obs.span("survey", workdir=workdir,
                    raw=os.path.basename(rawfiles[0]))
    try:
        with _tune.scoped(cfg.tune):
            seam, disk_only = _head_stage(rawfiles, cfg, workdir, res,
                                          timer, manifest, device, obs)
            _device_search_stages(seam, disk_only, cfg, timer, manifest,
                                  device, obs)
            _finish_survey_stages(rawfiles, cfg, workdir, res, timer,
                                  manifest, device, seam)
        root.finish()
        return res
    except BaseException as e:
        root.finish("error: %s" % type(e).__name__)
        obs.dump_flight(workdir, reason=type(e).__name__)
        raise
    finally:
        timer.mark(None)
        timer.report()
        with _tune.scoped(cfg.tune):
            _tune.write_provenance(workdir)
        obs.flush(default_dir=workdir)


def _head_stage(rawfiles, cfg, workdir, res, timer, manifest, device,
                obs):
    """survey_head, then res.datfiles; returns (seam, the trials the
    seam does not hold: a previous run's verified survivors)."""
    base = _base(rawfiles, workdir)
    seam = survey_head(rawfiles, cfg, workdir, device=device,
                       manifest=manifest, res=res, timer=timer, obs=obs)
    seam_set = set(seam.dat_paths())
    res.datfiles = sorted(set(_stage(os.path.basename(base) + "_DM*.dat",
                                     workdir))
                          | {os.path.join(workdir, os.path.basename(p))
                             for p in seam_set})
    disk_only = [f for f in res.datfiles
                 if os.path.abspath(f) not in seam_set]
    print("survey: %d dedispersed time series (%d seam-resident, %d "
          "sharded)" % (len(res.datfiles), len(seam),
                        sum(len(b.names) for b in seam.blocks
                            if fusion.is_sharded(b))))
    return seam, disk_only


def _device_search_stages(seam, disk_only, cfg, timer, manifest, device,
                          obs) -> None:
    """The device middle: stage 9a on the seam, then the FFT and every
    accel pass over the seam and the disk trials."""
    if cfg.singlepulse and len(seam):
        # before the FFT stage releases the blocks' device series
        timer.mark("single_pulse")
        seam_singlepulse(seam, cfg, device=device, manifest=manifest,
                         obs=obs)
    timer.mark("realfft+accelsearch (fused)")
    if len(seam):
        seam_fft_search(seam, cfg, device=device, manifest=manifest,
                        timer=timer, obs=obs)
    _fused_fft_search(disk_only, cfg, device, manifest, timer, obs=obs)
    for pcfg in _pass_configs(cfg):
        # the resume case for the first pass; the extra passes of
        # trials whose .fft was already on disk
        _batched_accelsearch([f[:-4] + ".fft" for f in disk_only], pcfg,
                             device, manifest, timer, obs=obs)


def _finish_survey_stages(rawfiles, cfg, workdir, res, timer, manifest,
                          device, seam) -> SurveyResult:
    """The per-job tail: sift, folds, stage 9."""
    base = _base(rawfiles, workdir)
    timer.mark("sift")
    _chaos(cfg, "pre-sift")
    accfiles = []
    for (zmax, _nh, _sg, _flo) in cfg.all_passes:
        accfiles += _stage(os.path.basename(base) + "_DM*_ACCEL_%d" % zmax,
                           workdir)
    res.candfile = os.path.join(workdir, "cands_sifted.txt")
    cl = sift_candidates(sorted(set(accfiles)), numdms_min=cfg.min_dm_hits,
                         low_DM_cutoff=cfg.low_dm_cutoff,
                         policy=cfg.sift_policy)
    cl.to_file(res.candfile)
    _record(manifest, [res.candfile], "sift")
    res.sifted = cl
    print("survey: %d sifted candidates -> %s" % (len(cl), res.candfile))
    _chaos(cfg, "post-sift")

    timer.mark("prepfold")
    fold_candidates(cl, cfg, workdir, seam, res, manifest, device)

    timer.mark("single_pulse")
    _chaos(cfg, "pre-singlepulse")
    if cfg.singlepulse and res.datfiles:
        res.sp_events = disk_singlepulse(res.datfiles, cfg, seam,
                                         device=device, manifest=manifest)
    _chaos(cfg, "post-survey")
    return res


def seam_singlepulse(seam: fusion.StageSeam, cfg: SurveyConfig,
                     device="cuda", manifest=None, obs=None) -> int:
    """Stage 9a: the single-pulse search over the seam-resident series,
    before the FFT stage takes them: the app's pipeline
    (apps/single_pulse_search) fed from the device instead of a .dat
    read and an upload.  Inputs are bit-equal to the disk path's (the
    same padded series, the same .inf round-tripped dt and DM, the same
    onoff-derived off regions), so the .singlepulse files are the same.
    A whole sharded block is searched shard by shard, each shard's rows
    in place on its device (one SinglePulseSearch a distinct device; a
    file's events do not depend on its batch).  The other trials without
    a verified .singlepulse go in groups of one (searched length, dt),
    at most the CLI's GROUP_BYTES of series a call (a partially resumed
    sharded block's rows moved to ``device``), each journaled under
    "singlepulse".  ``obs`` books each batch as one sp_search dispatch
    with its cost.  Returns the number of events written."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    searchers: Dict[torch.device, SinglePulseSearch] = {}

    def sp_on(d) -> SinglePulseSearch:
        if d not in searchers:
            searchers[d] = SinglePulseSearch(threshold=cfg.sp_threshold,
                                             maxwidth=cfg.sp_maxwidth,
                                             device=d)
        return searchers[d]

    _drop_stale(manifest, [name + ".singlepulse" for b in seam.blocks
                           for name in b.names])
    groups: Dict[tuple, list] = {}
    sharded = []
    for block in seam.blocks:
        todo = [row for row, name in enumerate(block.names)
                if not _valid(manifest, name + ".singlepulse")]
        if not todo:
            continue
        if fusion.is_sharded(block) and len(todo) == len(block.names):
            bplan = single_pulse_search.sp_block_plan(block.infos,
                                                      block.numout)
            if bplan is not None:
                sharded.append((block,) + tuple(bplan))
                continue
        for row in todo:
            nuse, offregions = single_pulse_search.sp_input_plan(
                block.infos[row], block.numout)
            groups.setdefault((nuse, fusion.inf_float(block.dt)),
                              []).append((block, row, offregions))

    def search(sp, batch, dt, items) -> int:
        """Search one batch of the (block, row, offregions) items and
        write their .singlepulse files; returns the events."""
        devtel.note_dispatch(obs, "sp_search")
        results = sp.search_many_resident(
            batch, dt,
            dms=[fusion.inf_float(b.infos[row].dm, 12)
                 for (b, row, _o) in items],
            offregions_list=[o for (_b, _r, o) in items], obs=obs)
        written, nev = [], 0
        for (b, row, _o), (cands, _stds, _bad) in zip(items, results):
            f = b.names[row] + ".singlepulse"
            write_singlepulse(f, cands)
            written.append(f)
            nev += len(cands)
        _record(manifest, written, "singlepulse")
        _chaos(cfg, "sp-seam-chunk")
        return nev

    nev = nser = nsh = 0
    for block, nuse, offregions in sharded:
        for part, (lo, hi) in zip(block.series_dev, block.row_ranges):
            nev += search(sp_on(part.device), part[:, :nuse],
                          fusion.inf_float(block.dt),
                          [(block, r, offregions) for r in range(lo, hi)])
            nsh += hi - lo
    for (nuse, dt), items in sorted(groups.items(), key=lambda kv: kv[0]):
        per = max(1, single_pulse_search.GROUP_BYTES // max(nuse * 4, 1))
        for g0 in range(0, len(items), per):
            chunk = items[g0:g0 + per]
            batch = torch.stack([b.row_on(row, dev)[:nuse]
                                 for (b, row, _o) in chunk])
            nev += search(sp_on(dev), batch, dt, chunk)
            del batch
            nser += len(chunk)
    print("survey: single-pulse search over %d seam-resident series "
          "(%d events, %d sharded)" % (nser + nsh, nev, nsh))
    return nev


def disk_singlepulse(datfiles: Sequence[str], cfg: SurveyConfig,
                     seam: Optional[fusion.StageSeam] = None,
                     device="cuda", manifest=None) -> int:
    """Stage 9: every trial in ``datfiles`` whose .singlepulse does not
    verify (a stale one is dropped first) goes through
    single_pulse_search (-t, -m, and -p: the port has no summary plot),
    its .dat spilled from ``seam`` first where the seam holds it and it
    never reached disk; journaled under "singlepulse".  Returns the
    number of events in the trials' .singlepulse files."""
    sps = [f[:-4] + ".singlepulse" for f in datfiles]
    _drop_stale(manifest, sps)
    todo = [f for f, p in zip(datfiles, sps) if not _valid(manifest, p)]
    if seam is not None:
        for f in todo:
            seam.ensure_dat(f)
        todo = [f for f in todo if os.path.exists(f)]
    if todo:
        argv = ["-t", str(cfg.sp_threshold), "-p"]
        if cfg.sp_maxwidth:
            argv += ["-m", str(cfg.sp_maxwidth)]
        single_pulse_search.main(argv + list(todo), device=device)
        _record(manifest, [f[:-4] + ".singlepulse" for f in todo],
                "singlepulse")
    nev = sum(len(read_singlepulse(p)) for p in sps if os.path.exists(p))
    print("survey: %d single-pulse events" % nev)
    return nev


def fold_argv(c, num: int, workdir: str):
    """(prepfold argv, .dat path, output base) of the survey's fold
    number ``num`` of sifted candidate ``c``."""
    accpath = (os.path.join(c.path, c.filename) if c.path
               else os.path.join(workdir, c.filename))
    datfile = accpath.split("_ACCEL_")[0] + ".dat"
    outbase = os.path.join(workdir, "fold_cand%d" % num)
    return (["-accelfile", accpath + ".cand", "-accelcand", str(c.candnum),
             "-dm", "%.2f" % c.DM, "-nosearch", "-noplot", "-o", outbase,
             datfile], datfile, outbase)


def fold_candidates(cl, cfg: SurveyConfig, workdir: str, seam, res,
                    manifest, device) -> None:
    """Stage 8: prepfold (-nosearch, on ``device``) of the candidates
    select_fold_candidates picks, each from its trial's .dat (spilled
    from the seam on demand) and its ACCEL .cand, into
    fold_candN.pfd/.bestprof; a journaled .pfd is not folded again.  A
    fold that exits (SystemExit) is reported and skipped, as in the JAX
    package."""
    top = select_fold_candidates(
        cl, fold_top=cfg.fold_top, fold_sigma=cfg.fold_sigma,
        max_folds=cfg.max_folds, max_folds_per_pass=cfg.max_folds_per_pass,
        pass_zmaxes=[z for (z, _nh, _sg, _flo) in cfg.all_passes])
    for i, c in enumerate(top):
        argv, datfile, outbase = fold_argv(c, i + 1, workdir)
        seam.ensure_dat(datfile)
        if _valid(manifest, outbase + ".pfd"):
            res.folded.append(outbase + ".pfd")
            continue
        try:
            prepfold.main(argv, device=device)
            res.folded.append(outbase + ".pfd")
            _record(manifest, [outbase + ".pfd"], "prepfold")
        except SystemExit as e:
            print("survey: fold of cand %d failed: %s" % (i + 1, e))
        _chaos(cfg, "fold-cand")
    print("survey: folded %d candidates" % len(res.folded))


# ----------------------------------------------------------------------
# Stacked cross-job execution (the serve layer's batch executor)
# ----------------------------------------------------------------------

class StackedSeamError(RuntimeError):
    """This job set cannot share one stacked device chain (the seams hold
    mesh-sharded blocks, whose concatenation would cross device
    placements).  The serve scheduler treats it like any batch failure:
    it degrades to the per-job path."""


class _FanTimer:
    """StageTimer fan-out: the merged device stage advances every stacked
    job's stage clock together (a shared device call is each job's stage
    work)."""

    def __init__(self, timers):
        self.timers = [t for t in timers if t is not None]

    def mark(self, name):
        for t in self.timers:
            t.mark(name)

    @contextlib.contextmanager
    def stage(self, name):
        with contextlib.ExitStack() as stack:
            for t in self.timers:
                stack.enter_context(t.stage(name))
            yield


class _FanInjector:
    """Chaos fan-out for the merged chain: a fault injected into any
    stacked job aborts the shared device call (the scheduler then
    degrades the batch to per-job execution)."""

    def __init__(self, injectors):
        self.injectors = list(injectors)

    def point(self, name):
        for fi in self.injectors:
            fi.point(name)


class _StackManifest:
    """Artifact-journal fan-out for a merged seam: every record / verify
    routes to the manifest of the job whose workdir holds the path, so N
    stacked jobs' journals end up what N per-job runs would write."""

    def __init__(self, routes):
        #: [(abs workdir, manifest-or-None)], deepest path first so a
        #: nested workdir routes to its own journal
        self.routes = sorted(((os.path.abspath(w), m) for w, m in routes),
                             key=lambda e: -len(e[0]))

    def _for(self, path):
        p = os.path.abspath(path)
        for wd, m in self.routes:
            if p == wd or p.startswith(wd + os.sep):
                return m
        return None

    def _grouped(self, paths):
        groups = {}
        for p in paths:
            m = self._for(p)
            groups.setdefault(id(m), (m, []))[1].append(p)
        return list(groups.values())

    def valid(self, path):
        m = self._for(path)
        return os.path.exists(path) if m is None else m.valid(path)

    def stage_of(self, path):
        m = self._for(path)
        return "" if m is None else m.stage_of(path)

    def record_many(self, paths, stage="", save=True):
        for m, ps in self._grouped(paths):
            if m is not None:
                m.record_many(ps, stage, save=save)

    def invalidate_stale(self, paths, remove=True):
        stale = []
        for m, ps in self._grouped(paths):
            if m is not None:
                stale += list(m.invalidate_stale(ps, remove=remove))
            else:
                stale += [p for p in ps if not os.path.exists(p)]
        return stale


def _place_over_mesh(block: fusion.SeamBlock, mesh) -> fusion.SeamBlock:
    """A merged block's rows over ``mesh`` (parallel/mesh.batch_sharding;
    a mesh entry that would get no row is left out): a ShardedSeamBlock
    whose k-th shard holds its rows on its device, where the FFT, the
    search and the single-pulse stage then run them."""
    from presto_tpu_torch.parallel import mesh as pmesh
    shards = [(d, (lo, hi)) for d, (lo, hi) in
              pmesh.batch_sharding(mesh, len(block.names)) if hi > lo]
    return fusion.ShardedSeamBlock(
        names=block.names, infos=block.infos, dms=block.dms,
        series_dev=[block.series_dev[lo:hi].to(d)
                    for d, (lo, hi) in shards],
        series_host=block.series_host, valid=block.valid,
        numout=block.numout, dt=block.dt,
        row_ranges=[r for _d, r in shards],
        mesh=pmesh.Mesh(tuple(d for d, _r in shards)))


def _merged_seam(ctxs, obs, manifest, mesh=None) -> fusion.StageSeam:
    """One StageSeam over every stacked job's deposited blocks: blocks of
    one geometry (padded length, valid span, sample time) concatenated on
    the batch axis into one [sum(numdms), numout] device tensor, so the
    FFT, search and single-pulse stages make one batched call where N
    per-job runs made N.  Per-trial math does not depend on the batch, so
    every artifact matches the per-job run.  With a ``mesh`` each merged
    block's rows are placed over it (_place_over_mesh); a one-job stack
    keeps the blocks prepsubband sharded over every card as they are,
    and a stack of several refuses them (StackedSeamError).  Source blocks
    hand their device tensor to the merged copy (each job's seam keeps
    its host copy for spills and folds)."""
    cfg0 = ctxs[0]["cfg"]
    seam = fusion.StageSeam(ctxs[0]["workdir"],
                            durable=cfg0.durable_stages is not False,
                            manifest=manifest,
                            inflight_depth=cfg0.inflight_depth, obs=obs)
    groups: Dict[tuple, list] = {}
    for c in ctxs:
        for b in c["seam"].blocks:
            if fusion.is_sharded(b):
                if len(ctxs) > 1:
                    raise StackedSeamError("mesh-sharded seam blocks "
                                           "cannot be stacked across jobs")
                # one job's block prepsubband sharded over every card:
                # its rows stay where they were dedispersed
                groups[("sharded", len(groups))] = [b]
                continue
            groups.setdefault((int(b.numout), int(b.valid), float(b.dt)),
                              []).append(b)
    for key, blocks in groups.items():
        if len(blocks) == 1:
            mb = blocks[0]
        else:
            mb = fusion.SeamBlock(
                names=[n for b in blocks for n in b.names],
                infos=[i for b in blocks for i in b.infos],
                dms=[d for b in blocks for d in b.dms],
                series_dev=torch.cat([b.series_dev for b in blocks]),
                series_host=np.concatenate([b.series_host
                                            for b in blocks]),
                valid=key[1], numout=key[0], dt=key[2])
        if mesh is not None and not fusion.is_sharded(mb):
            mb = _place_over_mesh(mb, mesh)
        if mb is not blocks[0]:
            for b in blocks:
                b.series_dev = None
        seam.blocks.append(mb)
        for row, name in enumerate(mb.names):
            seam._by_dat[os.path.abspath(name + ".dat")] = (mb, row)
    return seam


def _stacked_device_stages(ctxs, device, mesh=None) -> None:
    """The merged middle for one sub-stack: every job's seam blocks
    concatenated (and placed over ``mesh``), one _device_search_stages
    pass over the union."""
    cfg0 = ctxs[0]["cfg"]
    obs0 = ctxs[0]["obs"]
    manifest = _StackManifest([(c["workdir"], c["manifest"]) for c in ctxs])
    injectors = [c["cfg"].fault_injector for c in ctxs
                 if c["cfg"].fault_injector is not None]
    cfg_m = cfg0
    if injectors and (len(injectors) > 1
                      or injectors[0] is not cfg0.fault_injector):
        cfg_m = replace(cfg0, fault_injector=_FanInjector(injectors))
    seam = _merged_seam(ctxs, obs0, manifest, mesh=mesh)
    disk_only = [f for c in ctxs for f in c["disk_only"]]
    _device_search_stages(seam, disk_only, cfg_m,
                          _FanTimer([c["timer"] for c in ctxs]), manifest,
                          device, obs0)


def run_survey_stacked(jobs, stack_planner=None, device="cuda", mesh=None):
    """Run N same-geometry surveys with the device middle stacked:
    per-job heads (rfifind -> DDplan -> prepsubband) deposit N seams, the
    merged DM fan-outs cross stage 9a and the rFFT -> accelsearch chain
    in shared batched calls (plane_build and stage_reduce launched over
    the merged fan-out), and per-job tails (sift, folds, stage 9) finish
    each survey.

    jobs: (rawfiles, cfg, workdir, timer) tuples whose configs are
    stack-compatible (serve/batchexec checks the signature).
    stack_planner: callable(per-job chain bytes) -> sub-stack sizes
    summing to N (serve/batchexec's tuned plan with the memory clamp);
    None = one stack of every job.
    mesh: a parallel/mesh.Mesh the merged DM fan-out's rows are placed
    over (batch_sharding): each device runs the FFT, plane_build and
    stage_reduce and the single-pulse search of its rows.  None = the
    rows stay on ``device``.  One job is a stack of one.

    Every artifact is byte-identical to N independent run_survey calls;
    any failure propagates (the scheduler redoes the batch per job, and
    the resume journal makes the partial head work safe to redo)."""
    resolve_device(device)
    ctxs = []
    for (rawfiles, cfg, workdir, timer) in jobs:
        _refuse_unported(cfg)
        obs = resolve_obs(cfg.obs)
        os.makedirs(workdir, exist_ok=True)
        cleanup_stale_tmp(workdir)
        ctxs.append({
            "rawfiles": [os.path.abspath(f) for f in rawfiles],
            "cfg": cfg, "workdir": workdir,
            "res": SurveyResult(workdir=workdir),
            "timer": timer if timer is not None else StageTimer(obs=obs),
            "manifest": (SurveyManifest.load(workdir)
                         if cfg.verify_resume else None),
            "obs": obs, "span": None})
    try:
        with _tune.scoped(ctxs[0]["cfg"].tune):
            for c in ctxs:
                c["span"] = c["obs"].span(
                    "survey", workdir=c["workdir"],
                    raw=os.path.basename(c["rawfiles"][0]),
                    stacked=len(ctxs))
                c["seam"], c["disk_only"] = _head_stage(
                    c["rawfiles"], c["cfg"], c["workdir"], c["res"],
                    c["timer"], c["manifest"], device, c["obs"])
            sizes = [len(ctxs)]
            if stack_planner is not None:
                per_job = [sum(len(b.names) * b.numout * 4 * 3
                               for b in c["seam"].blocks) for c in ctxs]
                sizes = list(stack_planner(per_job)) or sizes
            if sum(sizes) != len(ctxs):
                raise StackedSeamError("stack plan %r does not cover %d jobs"
                                       % (sizes, len(ctxs)))
            i = 0
            for size in sizes:
                _stacked_device_stages(ctxs[i:i + size], device, mesh)
                i += size
            for c in ctxs:
                _finish_survey_stages(c["rawfiles"], c["cfg"], c["workdir"],
                                      c["res"], c["timer"], c["manifest"],
                                      device, c["seam"])
                c["span"].finish()
                c["span"] = None
    except BaseException as e:
        for c in ctxs:
            if c["span"] is not None:
                c["span"].finish("error: %s" % type(e).__name__)
                c["span"] = None
            c["obs"].dump_flight(c["workdir"], reason=type(e).__name__)
        raise
    finally:
        for c in ctxs:
            c["timer"].mark(None)
            c["timer"].report()
            with _tune.scoped(c["cfg"].tune):
                _tune.write_provenance(c["workdir"])
            c["obs"].flush(default_dir=c["workdir"])
    return [c["res"] for c in ctxs]
