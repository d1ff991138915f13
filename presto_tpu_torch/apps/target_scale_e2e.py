"""One card's share of the target-scale plan, end to end.

Counterpart of ``tools/target_scale_e2e.py``.  Device 0's 512 DM trials
of the 4096-DM x 2^23 plan (apps/target_scale) through the whole search
as one pipelined program on the card:

  subband pass   every raw block synthesized on the card (a seeded
                 torch.Generator) once through the subband pass into a
                 card-resident subband stream [nsub, nsamp + numpts]
                 (64 x (2^23 + 2^17) float32, 2.2 GB);
  per group      of ``group`` trials, in order: the DM fan-out from the
                 resident stream (each row the subband-ascending chain
                 of float32 adds, as ops/dedispersion's fan-out), mean
                 subtraction, the packed rFFT (ops/fftpack), then each
                 trial's search steps (parallel/sharded.TrialSteps:
                 plane_build, stage_reduce, collect_from_reduced,
                 compact_scan_packed at COMPACT_M slots) and one copy of
                 the group's compacted slots to pinned host memory; the
                 pulsar-DM trial's spectrum is the host-built probe
                 spectrum (target_scale.probe_series), in place of the
                 card's noise at that row;
  host           each trial's candidates by collect_compacted (the dense
                 fallback for a trial whose budget overflows), one ACCEL
                 table, .cand and .inf a trial (apps/accelsearch.
                 write_accel_file; WRITE_THREADS threads, the atomic
                 writes wait on fsync), then sift_candidates over the
                 share's files, overlapped with the next group on the
                 card;
  polish         the 64 strongest sifted candidates at the probe DM,
                 polished on the card against the probe spectrum;
  single pulse   the same 512 series, card-resident, through
                 SinglePulseSearch.search_many_resident a group at a
                 time (files whose hits overflow G go one by one through
                 search_many: counted);
  device floor   every group dispatched, one final synchronize, no
                 collection;
  replay         N host processes (--replay-worker, started with the run
                 so that their start-up overlaps the card's work) each
                 replaying the recorded compacted outputs through
                 collect, write and sift, N = 1 and 8: the host cost of
                 8 shares on one host;
  referee        the card's search of the probe spectrum beside the
                 float64 referee (search/accel_ref.search_ref) at the
                 searcher's geometry: the depth of identical eliminated
                 lists, the sigma at the first divergence, feature
                 containment both ways above SIGMA_FLOOR (must be 1.0),
                 cluster containment, and each feature mismatch traced to
                 its cell power (accel_ref.ref_cell_powers).

``--referee-only`` runs the referee alone on the cached probe series
(optionally on its first 2 x ``--referee-bins`` samples).  The JSON
(``--json FILE``) carries the card's name and power limit, the DM slice,
each stage's seconds, the candidate counts, the pulsar's recovery, the
peak memory and each kernel's launches counted around the run.

Usage: python -m presto_tpu_torch.apps.target_scale_e2e [--json FILE]
       [-device cuda] [--referee-only [--referee-bins N]]
       [--replay-workers 1,8] [--numdms N ...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.apps import target_scale as ts
from presto_tpu_torch.io.atomic import atomic_open, atomic_write_text
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.search import accel, accel_cuda, build_cuda

COMPACT_M = 2048            # top-m candidate slots a trial
MAX_CANDS_PER_STAGE = 512   # top-k a (slab, stage)
SIGMA_FLOOR = 30.0          # the referee's containment floor
POLISH_TOP = 64             # sifted probe-DM candidates polished
SP_THRESHOLD = 5.0
REPLAY_WORKERS = (1, 8)
REPLAY_WAIT_S = 900         # a replay worker's longest wait for the run
WRITE_THREADS = 4           # threads writing the share's ACCEL files


def searcher(share: ts.Share, device, numbins: Optional[int] = None):
    """The share's searcher (tools/target_scale_e2e.py:238-240)."""
    numbins = numbins or share.numbins
    cfg = accel.AccelConfig(zmax=share.zmax, numharm=share.numharm,
                            sigma=share.sigma,
                            max_cands_per_stage=MAX_CANDS_PER_STAGE)
    return accel.AccelSearch(cfg, T=2 * numbins * share.dt,
                             numbins=numbins, device=device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------------------------
# The card's half
# ----------------------------------------------------------------------

def subband_stream(share: ts.Share, blocks, chan_d, device) -> torch.Tensor:
    """The subband pass of a stream of raw blocks ([numchan, numpts] each,
    tensors or arrays) into one resident [nsub, (nblocks - 1) * numpts]
    stream: block pair (k, k + 1)'s subbands in columns k * numpts."""
    dev = accel.resolve_device(device)
    chan = torch.as_tensor(np.asarray(chan_d, np.int64), device=dev)
    n = share.numpts
    out = torch.empty((share.nsub, (share.nblocks - 1) * n),
                      dtype=torch.float32, device=dev)
    prev = None
    for k, blk in enumerate(blocks):
        cur = torch.as_tensor(blk, device=dev)
        if prev is not None:
            out[:, (k - 1) * n:k * n] = dd.dedisp_subbands_block(
                prev, cur, chan, share.nsub)
        prev = cur
    return out


def card_blocks(share: ts.Share, device, seed: int):
    """share.nblocks raw noise blocks made on the card from ``seed``."""
    dev = accel.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for _ in range(share.nblocks):
        yield torch.randn((share.numchan, share.numpts), generator=gen,
                          device=dev)


def fan_out(stream: torch.Tensor, delays: np.ndarray,
            nsamp: int) -> torch.Tensor:
    """[G, nsamp] dedispersed series from the resident subband stream at
    [G, nsub] delays: row g is stream[0, d0:] + stream[1, d1:] + ... in
    subband order (the float32 add chain of float_dedisp_many_block).
    Each subband's G windows are stacked (one copy) and added at once, so
    a group takes two launches a subband."""
    G, nsub = delays.shape

    def windows(s):
        return torch.stack([stream[s, int(d):int(d) + nsamp]
                            for d in delays[:, s]])
    out = windows(0)
    for s in range(1, nsub):
        out += windows(s)
    return out


class Pipeline:
    """The share's per-group program on one device: fan-out, mean
    subtraction, packed rFFT, the probe spectrum at its row, and each
    trial's search steps (TrialSteps.run), queued with no host sync."""

    def __init__(self, share: ts.Share, srch, stream: torch.Tensor,
                 dm_d: np.ndarray, probe_pairs: torch.Tensor,
                 psr_local: int):
        from presto_tpu_torch.parallel.sharded import TrialSteps
        self.share = share
        self.s = srch
        self.stream = stream
        self.dm_d = dm_d
        self.probe = probe_pairs
        self.psr_local = psr_local
        geom = srch.plane_geom()
        plan = srch.slab_plan(geom[2])
        srch._check_memory(geom[1] * srch.cfg.uselen, plan[0], len(plan[2]),
                           device=stream.device)
        self.steps = TrialSteps(srch, stream.device, plan, COMPACT_M)
        self.ngroups = -(-dm_d.shape[0] // share.group)

    def rows(self, gi: int) -> range:
        g = self.share.group
        return range(gi * g, min((gi + 1) * g, self.dm_d.shape[0]))

    def series(self, gi: int) -> torch.Tensor:
        r = self.rows(gi)
        return fan_out(self.stream, self.dm_d[r.start:r.stop],
                       self.share.nsamp)

    def spectra(self, gi: int) -> torch.Tensor:
        ser = self.series(gi)
        pairs = fftpack.realfft_packed_pairs(
            ser - ser.mean(dim=1, keepdim=True))
        del ser
        r = self.rows(gi)
        if self.psr_local in r:
            pairs[self.psr_local - r.start] = self.probe
        return pairs

    def dispatch(self, gi: int):
        """(packs, (host, done)) of group gi: each trial's dense packed
        output (kept for the dense fallback) and the group's compacted
        slots on their way to the host."""
        pairs = self.spectra(gi)
        packs, comps = [], []
        for j in range(pairs.shape[0]):
            packed, comp = self.steps.run(pairs[j])
            packs.append(packed)
            comps.append(comp)
        del pairs
        return packs, self.steps.fetch(comps)


def write_trial(workdir: str, dm: float, cands, share: ts.Share) -> str:
    """One trial's ACCEL table, .cand and .inf (the sift's inputs)."""
    from presto_tpu_torch.apps.accelsearch import (write_accel_file,
                                                   write_cand_file)
    from presto_tpu_torch.io.infodata import InfoData, write_inf
    base = os.path.join(workdir, "share_DM%.2f" % dm)
    name = "%s_ACCEL_%d" % (base, share.zmax)
    write_accel_file(name, cands, share.T)
    write_cand_file(name + ".cand", cands)
    write_inf(InfoData(name=base, object="TARGETSCALE", dm=float(dm),
                       dt=share.dt, N=share.nsamp, mjd_i=55000, mjd_f=0.0,
                       bary=0, numonoff=0), base + ".inf")
    return name


def overflowed(comp: np.ndarray) -> bool:
    """All of a trial's compacted slots positive: its candidates come
    from the dense output."""
    v = comp[0].view(np.float32)
    return bool(v.size and v[-1] > 0.0)


def device_floor(pipe: Pipeline) -> float:
    """Seconds of every group dispatched, one final synchronize, nothing
    collected."""
    dev = pipe.stream.device
    _sync(dev)
    t0 = time.perf_counter()
    last = None
    for gi in range(pipe.ngroups):
        _packs, last = pipe.dispatch(gi)
    if last[1] is not None:
        last[1].synchronize()
    _sync(dev)
    return time.perf_counter() - t0


def _write_timed(workdir, dm, cands, share):
    t0 = time.perf_counter()
    return write_trial(workdir, dm, cands, share), time.perf_counter() - t0


def e2e_share(pipe: Pipeline, dms: Sequence[float], workdir: str) -> dict:
    """The timed share: group i + 1 queued on the card before group i's
    host collection; each trial's candidates decoded here and its files
    written by WRITE_THREADS threads (the atomic writes wait on fsync),
    then the sift over the share's files."""
    from presto_tpu_torch.pipeline.sifting import sift_candidates
    t0 = time.perf_counter()
    host_s = decode_s = 0.0
    ncands = 0
    writes = []
    comp_groups = []
    overflow = []
    pool = ThreadPoolExecutor(WRITE_THREADS)
    try:
        pend = [(0, pipe.dispatch(0))]
        for gi in range(pipe.ngroups):
            if gi + 1 < pipe.ngroups:
                pend.append((gi + 1, pipe.dispatch(gi + 1)))
            g, (packs, (host, done)) = pend.pop(0)
            if done is not None:
                done.synchronize()
            th = time.perf_counter()
            comp = host.numpy().copy()
            comp_groups.append(comp)
            for j, packed in enumerate(packs):
                t = pipe.rows(g)[j]
                if overflowed(comp[j]):
                    overflow.append(int(t))
                td = time.perf_counter()
                cands = pipe.steps.decode(host[j], packed)
                decode_s += time.perf_counter() - td
                ncands += len(cands)
                writes.append(pool.submit(_write_timed, workdir, dms[t],
                                          cands, pipe.share))
            host_s += time.perf_counter() - th
        tw = time.perf_counter()
        done_writes = [f.result() for f in writes]
        wait_s = time.perf_counter() - tw
    finally:
        pool.shutdown(wait=True)
    files = [name for name, _s in done_writes]
    ts_ = time.perf_counter()
    cl = sift_candidates(files, numdms_min=2)
    sift_s = time.perf_counter() - ts_
    return {"e2e_share_sec": time.perf_counter() - t0,
            "host_collect_sec_inside": host_s, "host_decode_sec": decode_s,
            "host_write_sec": sum(w for _n, w in done_writes),
            "write_threads": WRITE_THREADS, "write_wait_sec": wait_s,
            "final_sift_sec": sift_s, "ncands_raw": ncands,
            "ncands_sifted": len(cl), "compact_overflow_trials": overflow,
            "_cl": cl, "_comp": comp_groups}


def singlepulse_share(pipe: Pipeline, dms: Sequence[float]) -> dict:
    """The single-pulse search over the same series, re-dedispersed a
    group at a time from the resident stream and searched resident."""
    from presto_tpu_torch.search.singlepulse import SinglePulseSearch
    dev = pipe.stream.device
    sp = SinglePulseSearch(threshold=SP_THRESHOLD, device=str(dev))
    dt = pipe.share.dt

    def group(gi, ovf):
        r = pipe.rows(gi)
        return sp.search_many_resident(pipe.series(gi), dt=dt,
                                       dms=[float(dms[t]) for t in r],
                                       overflowed=ovf)
    t0 = time.perf_counter()
    group(0, [])
    _sync(dev)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    nev = 0
    ovf: List[int] = []
    for gi in range(pipe.ngroups):
        got = []
        res = group(gi, got)
        nev += sum(len(c) for (c, _st, _b) in res)
        ovf += [pipe.rows(gi)[j] for j in got]
    return {"sp_share_sec": time.perf_counter() - t0, "sp_warmup_sec": warm,
            "sp_nevents": int(nev), "sp_overflow_files": len(ovf),
            "threshold": SP_THRESHOLD}


def polish_probe(cl, psr_dm: float, probe_pairs: torch.Tensor, srch,
                 share: ts.Share) -> dict:
    """The POLISH_TOP strongest sifted candidates at the probe DM polished
    against the probe spectrum on its device."""
    from presto_tpu_torch.search.polish import optimize_accelcands
    t0 = time.perf_counter()
    ranked = sorted((c for c in cl.cands if abs(c.DM - psr_dm) < 1e-6),
                    key=lambda c: -c.sigma)[:POLISH_TOP]
    seeds = [accel.AccelCand(power=0.0, sigma=c.sigma, numharm=c.numharm,
                             r=c.r, z=c.z) for c in ranked]
    ocs = optimize_accelcands(probe_pairs, seeds, share.T, srch.numindep,
                              with_props=False) if seeds else []
    _sync(probe_pairs.device)
    return {"polish_top_sec": time.perf_counter() - t0,
            "polish_top_n": len(ocs)}


def probe_top(cl, psr_dm: float, share: ts.Share):
    for c in sorted(cl.cands, key=lambda c: -c.sigma):
        if abs(c.DM - psr_dm) < 1e-6:
            return {"f": c.f, "sigma": c.sigma, "numharm": c.numharm,
                    "harm_of_f0": c.f / share.psr_f0}
    return None


# ----------------------------------------------------------------------
# The referee
# ----------------------------------------------------------------------

def referee_check(probe_pairs: np.ndarray, srch) -> dict:
    """srch.search of the probe spectrum on srch's device beside the
    float64 referee at srch's geometry (tools/target_scale_e2e.py's
    _referee_check)."""
    from presto_tpu_torch.search.accel import (ACCEL_CLOSEST_R, ACCEL_DR,
                                               ACCEL_DZ, eliminate_harmonics,
                                               remove_duplicates)
    from presto_tpu_torch.search.accel_ref import (agreement, ref_cell_powers,
                                                   search_ref)
    cfg = srch.cfg
    t0 = time.perf_counter()
    chip = remove_duplicates(srch.search(torch.as_tensor(
        probe_pairs, device=srch.device)))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = remove_duplicates(search_ref(probe_pairs, srch, dtype=np.float64))
    ref_s = time.perf_counter() - t0

    def key(cl):
        return {(c.numharm, c.r, c.z) for c in cl}
    inter = key(chip) & key(ref)
    ec = [(c.numharm, c.r, c.z, round(c.sigma, 2))
          for c in eliminate_harmonics(chip)]
    er = [(c.numharm, c.r, c.z, round(c.sigma, 2))
          for c in eliminate_harmonics(ref)]
    n_id = 0
    while n_id < min(len(ec), len(er)) and ec[n_id] == er[n_id]:
        n_id += 1
    div_sigma = ec[n_id][3] if n_id < len(ec) else None

    def unmatched(a, b):
        rb = np.asarray([c.r for c in b])
        return [c for c in a if not len(rb) or np.abs(rb - c.r).min() > 8.0]

    un_chip, un_ref = unmatched(chip, ref), unmatched(ref, chip)
    # remove_duplicates collapses everything within ACCEL_CLOSEST_R to a
    # cluster peak: two orderings of one sidelobe forest elect
    # representatives up to one radius apart on each side (+1 bin)
    cluster_r = 2.0 * ACCEL_CLOSEST_R + 1.0

    def nearest_r(c, other):
        ro = np.asarray([o.r for o in other])
        return float(np.abs(ro - c.r).min()) if len(other) else np.inf

    expl = []
    if un_chip:
        cells = [(int(np.log2(c.numharm)),
                  int(round((c.z * c.numharm + cfg.zmax) / ACCEL_DZ)),
                  int(round(c.r * c.numharm / ACCEL_DR))) for c in un_chip]
        rp = ref_cell_powers(srch, probe_pairs, cells, dtype=np.float64)
        for c, p_ref in zip(un_chip, rp):
            cut = srch.powcut[int(np.log2(c.numharm))]
            near = nearest_r(c, ref)
            if np.isfinite(p_ref) and p_ref > cut and near <= cluster_r:
                kind = "dedup_representative"
            elif (np.isfinite(p_ref) and p_ref <= cut < c.power
                  and abs(p_ref - c.power) / max(c.power, 1e-9) < 1e-2):
                kind = "threshold_straddle"
            else:
                kind = "unexplained"
            expl.append({"side": "card_only", "sigma": c.sigma,
                         "numharm": c.numharm, "r": c.r, "z": c.z,
                         "card_power": c.power, "ref_power_at_cell": p_ref,
                         "powcut": cut, "nearest_ref_r_bins": near,
                         "kind": kind})
    for c in un_ref:
        cut = srch.powcut[int(np.log2(c.numharm))]
        margin = (c.power - cut) / max(cut, 1e-9)
        near = nearest_r(c, chip)
        if near <= cluster_r:
            kind = "dedup_representative"
        elif margin < 1e-2:
            kind = "threshold_straddle"
        else:
            kind = "unexplained"
        expl.append({"side": "ref_only", "sigma": c.sigma,
                     "numharm": c.numharm, "r": c.r, "z": c.z,
                     "ref_power": c.power, "powcut": cut,
                     "rel_margin_above_cut": float(margin),
                     "nearest_card_r_bins": near, "kind": kind})

    def feat_frac(a, b, floor=None, radius=8.0):
        if floor is not None:
            a = [c for c in a if c.sigma >= floor]
        if not a:
            return 1.0
        if not b:
            return 0.0
        rb = np.asarray([c.r for c in b])
        return float(np.mean([np.abs(rb - c.r).min() <= radius for c in a]))

    res = {"numbins": int(probe_pairs.shape[0]), "card_n": len(chip),
           "ref_n": len(ref), "ref_dtype": "float64",
           "card_search_sec": card_s, "referee_sec": ref_s,
           "raw_cell_jaccard": len(inter) / max(len(key(chip) | key(ref)),
                                                1),
           "top_identical_n": n_id, "first_divergence_sigma": div_sigma,
           "feature_match_card_in_ref": feat_frac(chip, ref),
           "feature_match_ref_in_card": feat_frac(ref, chip),
           "mismatch_explanations": expl, "sigma_floor": SIGMA_FLOOR,
           "feature_match_above_floor": [feat_frac(chip, ref, SIGMA_FLOOR),
                                         feat_frac(ref, chip, SIGMA_FLOOR)],
           "cluster_radius_bins": cluster_r,
           "cluster_match_above_floor": [
               feat_frac(chip, ref, SIGMA_FLOOR, cluster_r),
               feat_frac(ref, chip, SIGMA_FLOOR, cluster_r)],
           "cluster_match_all": [feat_frac(chip, ref, None, cluster_r),
                                 feat_frac(ref, chip, None, cluster_r)],
           "top_eliminated": ec[:5],
           "n_above_floor": [sum(c.sigma >= SIGMA_FLOOR for c in chip),
                             sum(c.sigma >= SIGMA_FLOOR for c in ref)],
           "agreement": {k: v for k, v in agreement(
               chip, ref, cfg.sigma).items() if k != "failures"}}
    # required: containment above the floor both ways, and every feature
    # mismatch traced to a cause; the depth of identical lists and the
    # cluster containment are reported (float32 against float64, the
    # sidelobe forests below the floor part early)
    viol = []
    if res["feature_match_above_floor"] != [1.0, 1.0]:
        viol.append("feature containment above sigma %.0f != 1/1: %r"
                    % (SIGMA_FLOOR, res["feature_match_above_floor"]))
    for e in expl:
        if e["kind"] == "unexplained":
            viol.append("unexplained feature mismatch: %r" % (e,))
    res["violations"] = viol
    return res


def referee_only(share: ts.Share = ts.SHARE, device="cuda",
                 numbins: Optional[int] = None,
                 series: Optional[np.ndarray] = None) -> dict:
    """The referee alone on the pulsar-DM series (cached, else made),
    over its first 2 * ``numbins`` samples (default all)."""
    dev = accel.resolve_device(device)
    if series is None:
        series, _s = ts.probe_series(share)
    nb = min(numbins or share.numbins, share.numbins)
    pairs = ts.probe_pairs(series, 2 * nb)
    srch = searcher(share, dev, nb)
    t0 = time.perf_counter()
    res = referee_check(pairs, srch)
    res["referee_total_sec"] = time.perf_counter() - t0
    res["device"] = ts.card_line(dev)
    res["ok"] = not res["violations"]
    return res


# ----------------------------------------------------------------------
# The host replay
# ----------------------------------------------------------------------

def save_replay(workdir: str, s, start_cols, comp_groups, dms) -> None:
    """The replay's inputs: the groups' compacted outputs, then (its
    workers wait for this file) the decode geometry, the card's slab
    plan kept verbatim."""
    with atomic_open(os.path.join(workdir, "comp.npz"), "wb") as f:
        np.savez(f, **{"g%d" % gi: g for gi, g in enumerate(comp_groups)})
    meta = {"ngroups": len(comp_groups), "compact_m": COMPACT_M,
            "start_cols": [int(c) for c in start_cols],
            "r0min": int(s._r0min), "rtop": int(s._rtop),
            "dms": [float(d) for d in dms]}
    atomic_write_text(os.path.join(workdir, "meta.json"), json.dumps(meta))


def _wait_for(path: str, ppid: int) -> None:
    deadline = time.time() + REPLAY_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline or os.getppid() != ppid:
            raise SystemExit("replay worker: no %s within %d s, or the run "
                             "is gone" % (os.path.basename(path),
                                          REPLAY_WAIT_S))
        time.sleep(0.01)


def replay_worker(workdir: str, rnd: int, share: ts.Share) -> dict:
    """--replay-worker DIR --replay-round K: one share's host collection
    replayed from the recorded compacted outputs on the CPU: decode,
    write each trial's files, sift.  Started with the run, it builds its
    CPU searcher, waits for meta.json, loads the outputs and writes
    ready_K_<pid>; the timed span starts at go_K, so set-up stays out of
    it.  Prints {t0, t1, ncands, nsifted}."""
    from presto_tpu_torch.pipeline.sifting import sift_candidates
    ppid = os.getppid()
    srch = searcher(share, "cpu")
    _wait_for(os.path.join(workdir, "meta.json"), ppid)
    meta = json.load(open(os.path.join(workdir, "meta.json")))
    comp = np.load(os.path.join(workdir, "comp.npz"))
    groups = [comp["g%d" % gi] for gi in range(meta["ngroups"])]
    srch._r0min, srch._rtop = meta["r0min"], meta["rtop"]
    outdir = os.path.join(workdir, "out_%d_%d" % (rnd, os.getpid()))
    os.makedirs(outdir, exist_ok=True)
    open(os.path.join(workdir, "ready_%d_%d" % (rnd, os.getpid())),
         "w").close()
    _wait_for(os.path.join(workdir, "go_%d" % rnd), ppid)
    t0 = time.time()
    ncands = 0
    files = []
    t = 0
    for g in groups:
        for row in g:
            # a budget-overflowed trial decodes truncated: the replay
            # measures host throughput (the run itself used the dense
            # output)
            cands = srch.collect_compacted(row, meta["start_cols"],
                                           requested_m=meta["compact_m"],
                                           allow_truncated=True)
            ncands += len(cands)
            files.append(write_trial(outdir, meta["dms"][t], cands, share))
            t += 1
    cl = sift_candidates(files, numdms_min=2)
    out = {"t0": t0, "t1": time.time(), "ncands": ncands,
           "nsifted": len(cl)}
    print(json.dumps(out))
    return out


class Replay:
    """The replay's worker processes, one round a count of ``counts``,
    all started before the share runs, so that their start-up
    (interpreter, imports, CPU searcher) overlaps the card's work."""

    def __init__(self, workdir: str, share: ts.Share, counts: Sequence[int]):
        self.workdir = workdir
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        argv = ([sys.executable, "-m",
                 "presto_tpu_torch.apps.target_scale_e2e", "--replay-worker",
                 workdir] + ts.share_argv(share))
        self.rounds = [[subprocess.Popen(
            argv + ["--replay-round", str(k)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env) for _ in range(n)]
            for k, n in enumerate(counts)]

    def run(self, k: int) -> dict:
        """Round k's workers, their timed spans started together: {n,
        wall_sec, per_worker_sec, ncands, nsifted}."""
        procs = self.rounds[k]
        n = len(procs)
        ready = os.path.join(self.workdir, "ready_%d_*" % k)
        deadline = time.time() + REPLAY_WAIT_S
        while len(glob.glob(ready)) < n:
            if time.time() > deadline or any(
                    p.poll() is not None for p in procs):
                raise RuntimeError("replay workers never became ready: %s"
                                   % [p.poll() for p in procs])
            time.sleep(0.05)
        open(os.path.join(self.workdir, "go_%d" % k), "w").close()
        results = []
        for p in procs:
            outb, errb = p.communicate(timeout=REPLAY_WAIT_S)
            lines = outb.decode().strip().splitlines()
            if p.returncode != 0 or not lines:
                raise RuntimeError("replay worker failed (rc=%s):\n%s"
                                   % (p.returncode, errb.decode()[-2000:]))
            results.append(json.loads(lines[-1]))
        for d in glob.glob(os.path.join(self.workdir, "out_%d_*" % k)):
            shutil.rmtree(d, ignore_errors=True)
        return {"n": n, "wall_sec": max(r["t1"] for r in results)
                - min(r["t0"] for r in results),
                "per_worker_sec": [r["t1"] - r["t0"] for r in results],
                "ncands": results[0]["ncands"],
                "nsifted": results[0]["nsifted"]}

    def close(self) -> None:
        for procs in self.rounds:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()


# ----------------------------------------------------------------------
# The share
# ----------------------------------------------------------------------

def run(share: ts.Share = ts.SHARE, device="cuda",
        workdir: Optional[str] = None,
        series: Optional[np.ndarray] = None,
        referee_bins: Optional[int] = None,
        replay_workers: Sequence[int] = REPLAY_WORKERS) -> dict:
    """The share end to end (see the module docstring).  ``series``: the
    pulsar-DM series (else target_scale.probe_series); ``referee_bins``:
    the referee's spectrum length (default the share's);
    ``replay_workers``: the replay's process counts; ``workdir``: where
    the ACCEL files go (default a temporary directory, removed after the
    run)."""
    dev = accel.resolve_device(device)
    t_wall = time.perf_counter()
    chan_d, dm_full, dms_all = ts.delays(share)
    lo, hi = ts.dm_slice(share, dms_all)
    dm_d = np.ascontiguousarray(dm_full[lo:hi])
    dms = [float(d) for d in dms_all[lo:hi]]
    psr = ts.psr_index(share, dms_all)
    out = {"device": ts.card_line(dev), "torch_device": str(dev),
           "dms_per_device": share.dms_per_dev, "group": share.group,
           "nsamp": share.nsamp, "numchan": share.numchan,
           "nsub": share.nsub, "zmax": share.zmax,
           "numharm": share.numharm, "sigma": share.sigma,
           "compact_m": COMPACT_M, "dm_slice": [lo, hi]}
    if series is None:
        series, out["probe_prep_host_sec"] = ts.probe_series(share)
    probe_np = ts.probe_pairs(series)
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="target_e2e_")
    os.makedirs(workdir, exist_ok=True)
    before = (build_cuda.launches, accel_cuda.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    replay = Replay(workdir, share, replay_workers)
    try:
        # the subband pass, once, into the resident stream
        _sync(dev)
        t0 = time.perf_counter()
        stream = subband_stream(share, card_blocks(share, dev,
                                                   share.seed + 3),
                                chan_d, dev)
        _sync(dev)
        out["subband_pass_sec"] = time.perf_counter() - t0
        srch = searcher(share, dev)
        probe_dev = torch.as_tensor(probe_np, device=dev)
        pipe = Pipeline(share, srch, stream, dm_d, probe_dev, psr - lo)
        out["plane"] = [srch.numz_pad, srch.plane_geom()[2]]
        out["slabs"] = len(pipe.steps.start_cols)
        t0 = time.perf_counter()
        _packs, (host, done) = pipe.dispatch(0)
        if done is not None:
            done.synchronize()
        out["search_warmup_sec"] = time.perf_counter() - t0
        out["device_floor_sec"] = device_floor(pipe)
        e2e = e2e_share(pipe, dms, workdir)
        cl, comp_groups = e2e.pop("_cl"), e2e.pop("_comp")
        out.update(e2e)
        out["singlepulse"] = singlepulse_share(pipe, dms)
        out["per_card_pipeline_sec"] = (out["subband_pass_sec"]
                                        + out["e2e_share_sec"]
                                        + out["singlepulse"]["sp_share_sec"])
        out["ms_per_trial"] = {
            "device_floor": 1e3 * out["device_floor_sec"] / len(dms),
            "e2e": 1e3 * out["e2e_share_sec"] / len(dms),
            "host_collect": 1e3 * out["host_collect_sec_inside"] / len(dms),
            "singlepulse": 1e3 * out["singlepulse"]["sp_share_sec"]
            / len(dms)}
        out["pulsar_recovered"] = probe_top(cl, dms_all[psr], share)
        out.update(polish_probe(cl, dms_all[psr], probe_dev, srch, share))
        out["launches"] = {"plane_build": build_cuda.launches - before[0],
                           "stage_reduce": accel_cuda.launches - before[1]}
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)
        save_replay(workdir, srch, pipe.steps.start_cols, comp_groups, dms)
        del pipe, stream
        conc = [replay.run(k) for k in range(len(replay_workers))]
        out["host_concurrency"] = {"workers_%d" % c["n"]: c for c in conc}
        last = max(conc, key=lambda c: c["n"]) if conc else None
        nmax = last["n"] if last else 0
        host8 = last["wall_sec"] if last else None
        out["projection_8_cards"] = {
            "card": out["device"], "dms": share.numdms, "cards": share.ndev,
            "wall_sec_est": out["per_card_pipeline_sec"],
            "host_shares_wall_sec": host8, "host_shares": nmax,
            "host_overlaps_device": (host8 is not None and host8
                                     <= max(out["device_floor_sec"], 1.0)),
            "note": "DM-sharded: each card runs this share at once "
                    "(mpiprepsubband's partition); %s host processes "
                    "replaying one share each measured the host's cost "
                    "of %s cards" % (nmax, nmax)}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if referee_bins and referee_bins < share.numbins:
            out["referee"] = referee_only(share, dev, referee_bins, series)
        else:
            out["referee"] = referee_check(probe_np, srch)
        out["referee_sec"] = time.perf_counter() - t0
    finally:
        replay.close()
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    out["wall_total_sec"] = time.perf_counter() - t_wall
    top = out["pulsar_recovered"]
    out["ok"] = bool(top and top["sigma"] > 50
                     and ts.harmonic_of(top["f"], share.psr_f0)
                     and not out["referee"]["violations"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="target_scale_e2e")
    ts.add_common_args(ap)
    ap.add_argument("--referee-only", action="store_true",
                    help="run the referee alone on the cached probe")
    ap.add_argument("--referee-bins", type=int, default=None,
                    help="the referee's spectrum length (default the "
                         "share's nsamp / 2)")
    ap.add_argument("--replay-workers", default="1,8",
                    help="host replay process counts (default 1,8; empty "
                         "for none)")
    ap.add_argument("--replay-worker", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--replay-round", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    share = ts.share_from_args(args)
    if args.replay_worker:
        replay_worker(args.replay_worker, args.replay_round, share)
        return 0
    if args.referee_only:
        art = referee_only(share, args.device, args.referee_bins)
    else:
        art = run(share, device=args.device, referee_bins=args.referee_bins,
                  replay_workers=[int(x) for x in
                                  args.replay_workers.split(",") if x])
    ts.write_json(args.json, art)
    print(json.dumps(art, indent=1, default=float))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
