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

Not in this slice (a config that asks for them raises
NotImplementedError): zapbirds, barycentring, triage, elastic runs and
the serving and telemetry hooks.
The JAX package's cross-stage in-flight window (the FFT of one chunk
queued while the previous one is collected) only overlaps dispatch and
is not ported yet.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.apps import (prepfold, prepsubband, rfifind,
                                   single_pulse_search)
from presto_tpu_torch.apps.accelsearch import refine, write_results
from presto_tpu_torch.apps.common import open_raw
from presto_tpu_torch.io import datfft
from presto_tpu_torch.io.atomic import cleanup_stale_tmp
from presto_tpu_torch.io.infodata import read_inf
from presto_tpu_torch.io.quality import DataQualityReport
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
        "elastic runs": cfg.elastic,
        "serving and telemetry hooks": (cfg.plan_provider or cfg.obs
                                        or cfg.fault_injector or cfg.tune),
    }
    for what, on in asks.items():
        if on:
            raise NotImplementedError(
                "survey: %s comes in a later slice of the port" % what)


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
                timer=None) -> fusion.StageSeam:
    """rfifind (unless cfg.skip_rfifind) -> DDplan -> prepsubband per
    method with the rfifind mask, the fan-out deposited at an in-memory
    seam.  ``durable_stages`` (None -> True) also writes each trial's
    .dat; the .inf sidecars are always written.  A method whose .dat
    files all verify (a resumed run) is skipped: its trials are left on
    disk, outside the seam.  ``res`` receives the mask path and the
    quality report; ``timer`` the rfifind and prepsubband stages."""
    _refuse_unported(cfg)
    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    if isinstance(rawfiles, str):
        rawfiles = [rawfiles]
    rawfiles = [os.path.abspath(f) for f in rawfiles]
    base = _base(rawfiles, workdir)
    maskfile = None
    if not cfg.skip_rfifind:
        if timer is not None:
            timer.mark("rfifind")
        maskfile, quality = rfifind_stage(rawfiles, cfg, base, device,
                                          manifest)
        if res is not None:
            res.maskfile, res.quality = maskfile, quality
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
    seam = fusion.StageSeam(workdir, durable=cfg.durable_stages
                            is not False, manifest=manifest)
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
        prepsubband.run(prepsubband.build_parser().parse_args(
            argv + rawfiles), device=device, seam=seam)
        done = _stage(dat_glob, workdir)
        _record(manifest, done + [f[:-4] + ".inf" for f in done],
                "prepsubband")
    return seam


def searcher_for(cfg: SurveyConfig, T: float, nbins: int,
                 device="cuda") -> AccelSearch:
    return AccelSearch(AccelConfig(zmax=cfg.zmax, numharm=cfg.numharm,
                                   sigma=cfg.sigma, flo=cfg.flo),
                       T=T, numbins=nbins, device=device)


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
                      out, stage) -> None:
    """Every accel pass over one batch of device spectra: search_many,
    then refine + write_results per trial (the polish on the device,
    ACCEL and .cand files), journaled under ``stage``."""
    n = pairs.shape[1]
    for pcfg in _pass_configs(cfg):
        searcher = searcher_for(pcfg, T, n, device=device)
        results = searcher.search_many(pairs)
        arts = []
        for name, pr, raw in zip(names, pairs, results):
            trace = refine(raw, pr, T, searcher, timer=timer)
            acc = write_results(trace, T, name, pcfg.zmax, quiet=True,
                                timer=timer)
            out[acc] = trace.final
            arts += [acc, acc + ".cand"]
        _record(manifest, arts, stage)


def _write_ffts(pairs, names, manifest, stage) -> None:
    host = pairs.cpu().numpy()
    for name, pr in zip(names, host):
        datfft.write_fft(name + ".fft", fftpack.np_pairs_to_complex64(pr))
    _record(manifest, [name + ".fft" for name in names], stage)


def seam_fft_search(seam: fusion.StageSeam, cfg: SurveyConfig,
                    device="cuda", manifest=None, timer=None
                    ) -> Dict[str, List[AccelCand]]:
    """Every accel pass over the seam-resident series: batched rFFT
    straight off each seam block, search_many on the device spectra,
    then per trial refine + write_results (eliminate_harmonics,
    remove_duplicates, the polish, ACCEL + .cand).  The durable tier
    also writes each trial's .fft.  Trials whose ACCEL files (and, on
    the durable tier, .fft) all verify are skipped.  Returns
    {ACCEL path: final candidates} for the trials searched."""
    _refuse_unported(cfg)
    resolve_device(device)
    out: Dict[str, List[AccelCand]] = {}
    for numout, blocks in sorted(seam.groups().items()):
        n = numout & ~1
        per = max(1, FFT_CHUNK_BYTES // (n * 4))
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
            T = block.numout * fusion.inf_float(block.dt)
            for g0 in range(0, len(rows), per):
                chunk = rows[g0:g0 + per]
                series = (block.series_dev[:, :n]
                          if chunk == list(range(len(block.names)))
                          else block.series_dev[chunk, :n])
                pairs = fusion.fused_rfft_batch(series)
                del series
                if g0 + per >= len(rows):
                    # the block's last FFT chunk has consumed its series:
                    # its memory goes back before the chunk's search
                    seam.release(block)
                names = [block.names[r] for r in chunk]
                _search_and_write(pairs, names, T, cfg, device, manifest,
                                  timer, out, "fft+accel")
                if seam.durable:
                    _write_ffts(pairs, names, manifest, "fft+accel")
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


def _fused_fft_search(datfiles, cfg, device, manifest, timer) -> None:
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
            pairs = fftpack.realfft_packed_pairs(
                torch.as_tensor(arr, device=dev))
            names = [f[:-4] for f in chunk]
            _write_ffts(pairs, names, manifest, "fft+accel")
            _search_and_write(pairs, names, T, first, device, manifest,
                              timer, {}, "fft+accel")
    print("survey: fused realfft+accelsearch over %d disk trials"
          % len(todo))


def _batched_accelsearch(fftfiles, cfg, device, manifest, timer) -> None:
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
            _search_and_write(torch.as_tensor(batch, device=dev),
                              [f[:-4] for f in chunk], T, cfg, device,
                              manifest, timer, {}, "accel")
    print("survey: accelsearch over %d trials (batched)" % len(todo))


def run_survey(rawfiles: Sequence[str], cfg: SurveyConfig,
               workdir: str = ".", timer=None,
               device="cuda") -> SurveyResult:
    """The survey from filterbank to the folds of its top candidates
    (see the module docstring).  ``timer`` (utils/timing.StageTimer,
    made here when None) receives the stages; it is reported on exit."""
    _refuse_unported(cfg)
    resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    rawfiles = [os.path.abspath(f) for f in rawfiles]
    res = SurveyResult(workdir=workdir)
    # crash-safe resume: sweep a killed run's in-flight temp files, then
    # load the artifact journal this run verifies against and appends to
    cleanup_stale_tmp(workdir)
    manifest = SurveyManifest.load(workdir) if cfg.verify_resume else None
    if timer is None:
        timer = StageTimer()
    try:
        return _run_survey_stages(rawfiles, cfg, workdir, res, timer,
                                  manifest, device)
    finally:
        timer.mark(None)
        timer.report()


def _run_survey_stages(rawfiles, cfg, workdir, res, timer, manifest,
                       device):
    base = _base(rawfiles, workdir)
    seam = survey_head(rawfiles, cfg, workdir, device=device,
                       manifest=manifest, res=res, timer=timer)
    seam_set = set(seam.dat_paths())
    res.datfiles = sorted(set(_stage(os.path.basename(base) + "_DM*.dat",
                                     workdir))
                          | {os.path.join(workdir, os.path.basename(p))
                             for p in seam_set})
    # trials the seam does not hold (a previous run's verified
    # survivors) flow through the disk consumers
    disk_only = [f for f in res.datfiles
                 if os.path.abspath(f) not in seam_set]
    print("survey: %d dedispersed time series (%d seam-resident)"
          % (len(res.datfiles), len(seam)))

    if cfg.singlepulse and len(seam):
        # before the FFT stage releases the blocks' device series
        timer.mark("single_pulse")
        seam_singlepulse(seam, cfg, device=device, manifest=manifest)

    timer.mark("realfft+accelsearch (fused)")
    if len(seam):
        seam_fft_search(seam, cfg, device=device, manifest=manifest,
                        timer=timer)
    _fused_fft_search(disk_only, cfg, device, manifest, timer)
    for pcfg in _pass_configs(cfg):
        # the resume case for the first pass; the extra passes of
        # trials whose .fft was already on disk
        _batched_accelsearch([f[:-4] + ".fft" for f in disk_only], pcfg,
                             device, manifest, timer)

    timer.mark("sift")
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

    timer.mark("prepfold")
    fold_candidates(cl, cfg, workdir, seam, res, manifest, device)

    timer.mark("single_pulse")
    if cfg.singlepulse and res.datfiles:
        res.sp_events = disk_singlepulse(res.datfiles, cfg, seam,
                                         device=device, manifest=manifest)
    return res


def seam_singlepulse(seam: fusion.StageSeam, cfg: SurveyConfig,
                     device="cuda", manifest=None) -> int:
    """Stage 9a: the single-pulse search over the seam-resident series,
    before the FFT stage takes them: the app's pipeline
    (apps/single_pulse_search) fed from the device instead of a .dat
    read and an upload.  Inputs are bit-equal to the disk path's (the
    same padded series, the same .inf round-tripped dt and DM, the same
    onoff-derived off regions), so the .singlepulse files are the same.
    Trials with a verified .singlepulse are skipped; the others go in
    groups of one (searched length, dt), at most the CLI's GROUP_BYTES
    of series a call, each journaled under "singlepulse".  Returns the
    number of events written."""
    _refuse_unported(cfg)
    sp = SinglePulseSearch(threshold=cfg.sp_threshold,
                           maxwidth=cfg.sp_maxwidth, device=device)
    _drop_stale(manifest, [name + ".singlepulse" for b in seam.blocks
                           for name in b.names])
    groups: Dict[tuple, list] = {}
    for block in seam.blocks:
        for row, name in enumerate(block.names):
            if _valid(manifest, name + ".singlepulse"):
                continue
            nuse, offregions = single_pulse_search.sp_input_plan(
                block.infos[row], block.numout)
            groups.setdefault((nuse, fusion.inf_float(block.dt)),
                              []).append((block, row, offregions))
    nev = nser = 0
    for (nuse, dt), items in sorted(groups.items(), key=lambda kv: kv[0]):
        per = max(1, single_pulse_search.GROUP_BYTES // max(nuse * 4, 1))
        for g0 in range(0, len(items), per):
            chunk = items[g0:g0 + per]
            batch = torch.stack([b.series_dev[row, :nuse]
                                 for (b, row, _o) in chunk])
            results = sp.search_many_resident(
                batch, dt,
                dms=[fusion.inf_float(b.infos[row].dm, 12)
                     for (b, row, _o) in chunk],
                offregions_list=[o for (_b, _r, o) in chunk])
            del batch
            written = []
            for (b, row, _o), (cands, _stds, _bad) in zip(chunk, results):
                f = b.names[row] + ".singlepulse"
                write_singlepulse(f, cands)
                written.append(f)
                nev += len(cands)
            _record(manifest, written, "singlepulse")
            nser += len(chunk)
    print("survey: single-pulse search over %d seam-resident series "
          "(%d events)" % (nser, nev))
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
    print("survey: folded %d candidates" % len(res.folded))
