"""Per-stage device timing of the headline accelsearch on the card.

Counterpart of ``tools/profile_accel.py``.  It splits the search of the
JAX package's bench spectrum (``bench.py``'s ``make_accel_input`` and
``ACCEL_T``, copied here: 2^21 bins, seed 42, three tones) into the
stages ``AccelSearch.search`` runs for one spectrum (parallel/sharded.
TrialSteps, the per-trial steps of sharded_accel_search_many, called
here one at a time) and times each on the card:

  build         AccelSearch.build_plane: forward_spectra (the block
                windows' median normalization and forward FFT, torch ops)
                and the plane_build kernel, each also apart
  scan          the stage_reduce kernel over slab_plan's slabs
  collect       on the card: collect_from_reduced (threshold, segment
                max, top-k) and compact_scan_packed
  d2h           the compacted candidates to pinned host memory
  host collect  collect_compacted (host clock)
  e2e           AccelSearch.search with the spectrum on the card

Device times are CUDA-event ms, best of ``--reps`` after a warm-up; the
host collect is the host clock's best.  Each device stage stands beside
its bound: max(bytes / 3.35 TB/s, float32 ops / 67 TFLOP/s) over the
plane's real rows (obs/costmodel's counts), and with ``--peaks`` also
at the card's measured peaks (obs/roofline.measure_peaks).  The JAX
tool's "fused" line (build and scan in one dispatch) has no
counterpart: the port launches the two kernels in turn.

The candidate list the stages give is held to ``search``'s on the same
input.  Runs on a CUDA device only (the default; no card raises).

Usage: python -m presto_tpu_torch.apps.profile_accel [--reps 5]
       [--peaks] [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from presto_tpu_torch.obs import costmodel
from presto_tpu_torch.obs.roofline import best_ms
from presto_tpu_torch.parallel import sharded
from presto_tpu_torch.search import accel

#: bench.py's accel workload (WORKLOAD["accel_*"], ACCEL_T)
ACCEL_NUMBINS, ACCEL_ZMAX, ACCEL_NUMHARM = 1 << 21, 200, 8
ACCEL_T = 1000.0
#: the bench spectrum: noise from this seed and tones at these bins
ACCEL_SEED = 42
ACCEL_TONES = (12345, 123456, 765432)
ACCEL_TONE_AMP = 300.0
#: the profile's search threshold (tools/profile_accel.py's)
ACCEL_SIGMA = 6.0

#: published H100 SXM peaks (NVIDIA data sheet): device memory rate and
#: float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def make_accel_input(numbins: int = ACCEL_NUMBINS) -> np.ndarray:
    """bench.py's accel spectrum [numbins, 2] float32: seeded noise and
    the tones that lie below ``numbins`` (all three at the default)."""
    rng = np.random.default_rng(ACCEL_SEED)
    re = rng.normal(size=numbins).astype(np.float32)
    im = rng.normal(size=numbins).astype(np.float32)
    pairs = np.stack([re, im], -1)
    for r0 in ACCEL_TONES:
        if r0 < numbins:
            pairs[r0] = (ACCEL_TONE_AMP, 0.0)
    return pairs


def searcher(numbins: int = ACCEL_NUMBINS, zmax: int = ACCEL_ZMAX,
             numharm: int = ACCEL_NUMHARM, device="cuda"):
    return accel.AccelSearch(accel.AccelConfig(zmax=zmax, numharm=numharm,
                                               sigma=ACCEL_SIGMA),
                             T=ACCEL_T, numbins=numbins, device=device)


class Stages(sharded.TrialSteps):
    """The search of one spectrum split into its stages on the
    spectrum's device: the steps sharded_accel_search_many runs for each
    trial (parallel/sharded.TrialSteps) at search()'s slab and
    compaction budget, with forward_spectra apart."""

    def __init__(self, s, pairs: torch.Tensor):
        self.pairs = pairs
        self.nblocks, self.nb_pad, self.numr = s.plane_geom()
        super().__init__(s, pairs.device,
                         s.slab_plan(self.numr, accel.SEARCH_SLAB),
                         accel.COMPACT_CANDS)

    def spectra(self):
        return self.s.forward_spectra(self.pairs)

    def d2h(self, comp):
        """The compacted candidates to the host as the search copies a
        shard's (pinned, on a CUDA spectrum), synchronized."""
        host, done = self.fetch([comp])
        if done is not None:
            done.synchronize()
        return host

    def host_collect(self, host, packed):
        return self.decode(host[0], packed)

    def candidates(self):
        """Every stage once: the spectrum's candidate list."""
        packed, comp = self.run(self.pairs)
        return self.host_collect(self.d2h(comp), packed)


def _bound(nbytes: float, flops: float, peaks=None) -> dict:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    out = {"bytes": float(nbytes), "flops": float(flops),
           "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf
           else "operations"}
    if peaks:
        out["bound_ms_measured_peaks"] = 1e3 * max(
            nbytes / peaks["bytes_per_s"], flops / peaks["flops_per_s"])
    return out


def stage_bounds(st: Stages, peaks=None) -> dict:
    """Each device stage's work on these inputs (bytes each input read
    once and each output written once; float32 ops), the plane's real
    rows only."""
    s = st.s
    cfg = s.cfg
    n = s.kern.fftlen
    half = n // 2
    nslabs = len(st.start_cols)
    kk = min(st.k, -(-st.slab // accel.SEARCH_SEG))
    red = nslabs * st.nst * st.slab * 8
    packed = 3 * nslabs * st.nst * kk * 4
    comp = 3 * min(st.m, nslabs * st.nst * kk) * 4
    spectra = (s.numbins * 8 + st.nblocks * half * 8,
               st.nblocks * 5 * half * math.log2(half))
    build = costmodel.plane_build_work(st.nblocks, cfg.numz, n, cfg.uselen,
                                       cfg.numz, st.numr)
    scan = costmodel.stage_reduce_work(cfg.numz, st.numr, nslabs, st.slab,
                                       st.nst, st.zinds.shape[0] * cfg.numz)
    collect = (red + st.nst * 4 + packed, nslabs * st.nst * st.slab)
    compact = (packed + comp, 0.0)
    out = {"forward_spectra": _bound(*spectra, peaks=peaks),
           "plane_build": _bound(*build, peaks=peaks),
           "stage_reduce": _bound(*scan, peaks=peaks),
           "collect_from_reduced": _bound(*collect, peaks=peaks),
           "compact_scan_packed": _bound(*compact, peaks=peaks)}
    out["build"] = _bound(spectra[0] + build[0], spectra[1] + build[1],
                          peaks=peaks)
    tot = [sum(out[k][x] for k in ("forward_spectra", "plane_build",
                                   "stage_reduce", "collect_from_reduced",
                                   "compact_scan_packed"))
           for x in ("bytes", "flops")]
    out["e2e"] = _bound(*tot, peaks=peaks)
    return out


def _host_ms(fn, reps: int) -> float:
    fn()
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _cand_rows(cands):
    return [[c.numharm, c.r, c.z, c.power, c.sigma] for c in cands]


def profile(numbins: int = ACCEL_NUMBINS, zmax: int = ACCEL_ZMAX,
            numharm: int = ACCEL_NUMHARM, reps: int = 5, peaks=False,
            device="cuda") -> dict:
    """The stage split of the search of make_accel_input(numbins) on a
    CUDA ``device``: times, bounds, the candidates of the stages and of
    ``search``, and the tones found."""
    dev = accel.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_accel: the stage times are CUDA-event "
                         "device ms; run it on a CUDA device, not %s" % dev)
    s = searcher(numbins, zmax, numharm, device=dev)
    pairs = torch.as_tensor(make_accel_input(numbins), device=dev)
    st = Stages(s, pairs)
    pk = None
    if peaks:
        from presto_tpu_torch.obs import roofline
        pk = roofline.measure_peaks(device=dev)
    cands = st.candidates()
    found = s.search(pairs)
    spectra = st.spectra()
    plane = st.build(pairs, spectra)
    colmax, colz = st.scan(plane)
    packed = st.collect(colmax, colz)
    comp = st.compact(packed)
    host = st.d2h(comp)
    ms = {"forward_spectra": best_ms(st.spectra, reps),
          "build": best_ms(lambda: st.build(pairs), reps),
          "plane_build": best_ms(lambda: st.build(pairs, spectra), reps),
          "stage_reduce": best_ms(lambda: st.scan(plane), reps),
          "collect_from_reduced": best_ms(
              lambda: st.collect(colmax, colz), reps),
          "compact_scan_packed": best_ms(lambda: st.compact(packed), reps),
          "d2h": best_ms(lambda: st.d2h(comp), reps)}
    torch.cuda.synchronize(dev)
    host_ms = _host_ms(lambda: st.host_collect(host, packed), reps)
    del plane, colmax, colz
    torch.cuda.empty_cache()
    ms["e2e"] = best_ms(lambda: s.search(pairs), reps)
    numr = int(s.rhi - s.rlo) * 2
    cells = s.cfg.numz * numr
    tones = {str(r0): any(abs(c.r - r0) <= 1.0 for c in found)
             for r0 in ACCEL_TONES if r0 < numbins}
    return {
        "card": card_line(), "device": str(dev),
        "workload": {"numbins": numbins, "zmax": zmax, "numharm": numharm,
                     "T": ACCEL_T, "sigma": ACCEL_SIGMA,
                     "plane": [s.numz_pad, st.numr],
                     "plane_real_rows": s.cfg.numz, "fftlen": s.kern.fftlen,
                     "uselen": s.cfg.uselen, "blocks": st.nblocks,
                     "slabs": len(st.start_cols), "slab": st.slab,
                     "stages": st.nst, "compact_m": st.m},
        "reps": reps, "ms": ms, "host_collect_ms": host_ms,
        "bounds": stage_bounds(st, pk), "peaks": pk,
        "cells": cells, "cells_per_s": cells / (ms["e2e"] * 1e-3),
        "fused": None,
        "candidates": _cand_rows(cands), "search_candidates":
            _cand_rows(found), "same_as_search":
            _cand_rows(cands) == _cand_rows(found),
        "tones_found": tones,
    }


def render(res: dict, file=None) -> None:
    out = file or sys.stdout

    def w(s):
        print(s, file=out, flush=True)
    wl, ms, b = res["workload"], res["ms"], res["bounds"]

    def bd(key):
        x = b[key]
        txt = "bound %.3f ms (%s)" % (x["bound_ms"], x["bound_by"])
        if "bound_ms_measured_peaks" in x:
            txt += ", %.3f at the measured peaks" % (
                x["bound_ms_measured_peaks"])
        return txt
    w("card: %s" % res["card"])
    w("workload: numbins=2^%d zmax=%d numharm=%d T=%g s  plane %dx%d (%d "
      "real rows, %.2f GB)  fftlen=%d uselen=%d blocks=%d  %d slab(s) of "
      "%d, %d stages"
      % (round(math.log2(wl["numbins"])), wl["zmax"], wl["numharm"],
         wl["T"], wl["plane"][0], wl["plane"][1], wl["plane_real_rows"],
         wl["plane"][0] * wl["plane"][1] * 4 / 1e9, wl["fftlen"],
         wl["uselen"], wl["blocks"], wl["slabs"], wl["slab"],
         wl["stages"]))
    w("build  : %8.3f ms  %s" % (ms["build"], bd("build")))
    w("  forward_spectra %8.3f ms  %s" % (ms["forward_spectra"],
                                          bd("forward_spectra")))
    w("  plane_build     %8.3f ms  %s" % (ms["plane_build"],
                                          bd("plane_build")))
    w("scan   : %8.3f ms  stage_reduce, %s" % (ms["stage_reduce"],
                                               bd("stage_reduce")))
    w("collect: %8.3f ms  on the card: collect_from_reduced %.3f ms (%s); "
      "compact_scan_packed %.3f ms (%s)"
      % (ms["collect_from_reduced"] + ms["compact_scan_packed"],
         ms["collect_from_reduced"], bd("collect_from_reduced"),
         ms["compact_scan_packed"], bd("compact_scan_packed")))
    w("d2h    : %8.3f ms  compacted candidates to pinned host memory"
      % ms["d2h"])
    w("host   : %8.3f ms  collect_compacted (host clock)"
      % res["host_collect_ms"])
    w("e2e    : %8.3f ms  search(), spectrum on the card, %s -> %.4g "
      "cells/s" % (ms["e2e"], bd("e2e"), res["cells_per_s"]))
    w("fused  : no counterpart (the port launches build and reduce in turn)")
    w("candidates: %d, the same as search(): %s; tones found: %s"
      % (len(res["candidates"]), res["same_as_search"],
         res["tones_found"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_accel")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--numbins", type=int, default=ACCEL_NUMBINS)
    ap.add_argument("--zmax", type=int, default=ACCEL_ZMAX)
    ap.add_argument("--numharm", type=int, default=ACCEL_NUMHARM)
    ap.add_argument("--peaks", action="store_true",
                    help="also state each bound at the card's measured "
                         "peaks (obs/roofline.measure_peaks)")
    ap.add_argument("--device", default="cuda",
                    help="CUDA device (default cuda; no card raises)")
    ap.add_argument("--json", metavar="FILE",
                    help="write the result as JSON to FILE")
    args = ap.parse_args(argv)
    res = profile(args.numbins, args.zmax, args.numharm, args.reps,
                  peaks=args.peaks, device=args.device)
    render(res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
    return 0 if res["same_as_search"] and all(
        res["tones_found"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
