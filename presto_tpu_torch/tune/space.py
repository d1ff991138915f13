"""Declarative search spaces per tunable family (tune layer).

PyTorch counterpart of ``presto_tpu/tune/space.py``, for the families
whose knob exists in the port.  Each :class:`Family` names its knob
set, enumerates candidates for a workload *shape*, names the shape key
its result is stored under, and builds a zero-arg bench for one
candidate on a device (or scores it, for a modeled family):

  accel_column_slab   the search's column slab (search_many's ``slab``;
                      search/accel.reference_tile picks the start
                      columns inside it): the counterpart of the JAX
                      package's ``accel_pallas_tile``, every slab
                      giving the same candidate lists
  pipeline_inflight_depth
                      host ingest depth of prepsubband's feeder and the
                      fused chain's window (pipeline/fusion.py)
  sharded_inflight_depth
                      the DM-sharded seam's window of FFT chunks queued
                      ahead of their search (pipeline/fusion.py
                      resolve_depth)
  serve_batch_geometry
                      stacked cross-job batch geometry (serve/batchexec):
                      max stack x sub-stack scheme
  beam_stack_size     beams a stacked rolling-dedispersion step in the
                      beam multiplexer (stream/beams.py)
  plancache_bucket    the serve plan cache's bucket edges (modeled:
                      builds + padding waste, no clock)
  oocfft_block        block-buffer bytes of the out-of-core two-pass
                      FFT (ops/oocfft; host, the same bytes at any
                      block size)

Not here (ROADMAP.md says why): ``harmonic_sum_layout`` (the port has
one device engine for the harmonic sums) and ``dedisp_dm_batch`` (the
port's dedispersion has no DM-batch bound).  Every family has a tiny
``smoke`` shape that runs on the CPU.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import tune
from presto_tpu_torch.io.atomic import atomic_open


@dataclass
class Family:
    """One tunable family."""
    name: str
    doc: str
    shape_key: Callable[[dict], str]
    candidates: Callable[[dict], List[dict]]
    shapes: Callable[[bool], List[dict]]      # smoke -> shape dicts
    #: (shape, config, device) -> zero-arg bench callable (timed)
    bench: Optional[Callable[[dict, dict, object], Callable[[], object]]] \
        = None
    #: (shape, config) -> figure of merit, lower = better (modeled)
    score: Optional[Callable[[dict, dict], float]] = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# accel_column_slab
# ----------------------------------------------------------------------

def key_column_slab(numz: int, numharm: int, numbins: int) -> str:
    """Shape key of the column slab: plane rows (8-padded), harmonic
    count and the pow2-bucketed spectrum length."""
    return tune.shape_key(numz=-(-int(numz) // 8) * 8,
                          numharm=int(numharm),
                          numbins=tune.pow2_bucket(numbins))


def _slab_candidates(shape) -> List[dict]:
    slabs = shape.get("slabs") or (1 << 16, 1 << 18, 1 << 20)
    return [{"slab": int(s)} for s in slabs]


def _slab_bench(shape, config, device):
    from presto_tpu_torch.search.accel import AccelConfig, AccelSearch
    numbins = int(shape["numbins"])
    rng = np.random.default_rng(13)
    pairs = torch.as_tensor(rng.normal(size=(int(shape.get("trials", 2)),
                                             numbins, 2))
                            .astype(np.float32), device=device)
    s = AccelSearch(AccelConfig(zmax=int(shape["zmax"]),
                                numharm=int(shape["numharm"])),
                    T=float(shape.get("T", numbins * 1e-3)),
                    numbins=numbins, device=device)
    slab = int(config["slab"])

    def fn():
        return s.search_many(pairs, slab=slab)
    return fn


# ----------------------------------------------------------------------
# pipeline_inflight_depth / sharded_inflight_depth
# ----------------------------------------------------------------------

def _inflight_candidates(shape) -> List[dict]:
    windows = shape.get("windows") or (1, 2, 3, 4)
    depths = shape.get("ingest_depths") or (2, 4)
    return [{"window": int(w), "ingest_depth": int(b)}
            for w in windows for b in depths]


def _drain(pending, window: int, done) -> None:
    """Collect the oldest queued chunks until fewer than ``window``
    remain (one device-to-host copy each)."""
    while len(pending) >= window:
        done(pending.pop(0))


def _inflight_bench(shape, config, device):
    """The fused head in miniature: host blocks produced on a worker
    thread ``ingest_depth`` ahead (DoubleBufferedIngest), each uploaded
    and FFT'd on the device, at most ``window`` FFT'd blocks queued
    before the oldest is copied back.  Depths change overlap only."""
    from presto_tpu_torch.ops import fftpack
    from presto_tpu_torch.pipeline.fusion import DoubleBufferedIngest
    nblocks = int(shape.get("nblocks", 8))
    n = int(shape.get("n", 1 << 16))
    rng = np.random.default_rng(21)
    blocks = [rng.random(n).astype(np.float32) for _ in range(nblocks)]
    window = int(config["window"])
    depth = int(config["ingest_depth"])

    def fn():
        def produce():
            for b in blocks:
                yield np.ascontiguousarray(b)
        pending, last = [], None
        ingest = DoubleBufferedIngest(produce(), depth=depth)
        try:
            for b in ingest:
                last = fftpack.realfft_packed_pairs(
                    torch.as_tensor(b, device=device))
                pending.append(last)
                _drain(pending, window, lambda p: p.cpu())
        finally:
            ingest.close()
        _drain(pending, 1, lambda p: p.cpu())
        return last
    return fn


def _sharded_inflight_candidates(shape) -> List[dict]:
    windows = shape.get("windows") or (1, 2, 3, 4)
    return [{"window": int(w)} for w in windows]


def _sharded_inflight_bench(shape, config, device):
    """The sharded seam in miniature: a DM fan-out split over the
    visible mesh (every card, or logical shards), each chunk FFT'd shard
    by shard, at most ``window`` chunks queued before the oldest one's
    per-shard copies back (the search's collection)."""
    from presto_tpu_torch.parallel.mesh import make_mesh, shard_row_ranges
    from presto_tpu_torch.pipeline.fusion import fused_rfft_batch
    mesh = make_mesh(device=device)
    nd = int(shape.get("numdms", 2 * mesh.size))
    nd = max(nd - nd % mesh.size, mesh.size)
    n = int(shape.get("n", 1 << 14))
    nchunks = int(shape.get("nchunks", 6))
    rng = np.random.default_rng(29)
    host = rng.random((nd, n)).astype(np.float32)
    parts = [torch.as_tensor(host[lo:hi], device=d) for d, (lo, hi) in
             zip(mesh.devices, shard_row_ranges(mesh, nd))]
    window = int(config["window"])

    def fn():
        pending = []
        for _ in range(nchunks):
            pending.append(fused_rfft_batch(parts, mesh=mesh))
            _drain(pending, window, lambda ps: [p.cpu() for p in ps])
        _drain(pending, 1, lambda ps: [p.cpu() for p in ps])
        return None
    return fn


# ----------------------------------------------------------------------
# serve_batch_geometry
# ----------------------------------------------------------------------

def _stack_candidates(shape) -> List[dict]:
    stacks = shape.get("stacks") or (2, 4, 8)
    return [{"max_stack": int(s), "scheme": sch}
            for s in stacks for sch in ("exact", "pow2")]


def _stack_bench(shape, config, device):
    """The stacked serve chain in miniature: N jobs' device-resident
    fan-outs stacked on the batch axis per the candidate's sub-stack
    plan, each sub-stack one batched rFFT and one per-trial top-k
    collection.  Stacking never changes per-trial floats."""
    from presto_tpu_torch.pipeline.fusion import fused_rfft_batch
    from presto_tpu_torch.serve.batchexec import plan_stack_sizes
    nd = int(shape.get("numdms", 4))
    n = int(shape.get("n", 1 << 12))
    njobs = int(shape.get("jobs", 8))
    rng = np.random.default_rng(31)
    dev = [torch.as_tensor(rng.random((nd, n)).astype(np.float32),
                           device=device) for _ in range(njobs)]
    sizes = plan_stack_sizes(njobs, int(config["max_stack"]),
                             str(config["scheme"]))

    def fn():
        out, i = None, 0
        for s in sizes:
            chunk = dev[i:i + s]
            i += s
            stacked = torch.cat(chunk) if len(chunk) > 1 else chunk[0]
            pairs = fused_rfft_batch(stacked)
            p = pairs[..., 0] ** 2 + pairs[..., 1] ** 2
            out = torch.topk(p.reshape(p.shape[0], -1),
                             min(8, p.shape[-1]))
        _sync(device)
        return out
    return fn


# ----------------------------------------------------------------------
# beam_stack_size
# ----------------------------------------------------------------------

def _beam_stack_candidates(shape) -> List[dict]:
    nbeams = int(shape.get("beams", 64))
    stacks = shape.get("stacks") or (4, 8, 16, 32, 64)
    return [{"stack": int(s)} for s in stacks if int(s) <= nbeams]


def _beam_stack_bench(shape, config, device):
    """The multiplexer's stacked rolling dedispersion in miniature:
    ``beams`` feeds in groups of the candidate stack, each group one
    StackedRollingDedisp whose fed block is one stacked step.  Each
    beam's floats do not depend on its group."""
    from presto_tpu_torch.stream.beams import StackedRollingDedisp
    nbeams = int(shape.get("beams", 64))
    nsub = int(shape.get("nsub", 8))
    nchan = int(shape.get("nchan", 16))
    numdms = int(shape.get("numdms", 4))
    blocklen = int(shape.get("blocklen", 512))
    nblocks = int(shape.get("nblocks", 4))
    rng = np.random.default_rng(37)
    chan_bins = np.sort(rng.integers(0, blocklen // 4, size=nchan)
                        ).astype(np.int32)
    chan_bins[0] = 0
    dm_bins = np.sort(rng.integers(0, blocklen // 4, size=(numdms, nsub)),
                      axis=1).astype(np.int32)
    dm_bins[:, 0] = 0
    blocks = [rng.random((nbeams, blocklen, nchan)).astype(np.float32)
              for _ in range(nblocks)]
    stack = int(config["stack"])
    groups = [list(range(lo, min(lo + stack, nbeams)))
              for lo in range(0, nbeams, stack)]
    rollers = [StackedRollingDedisp(chan_bins, dm_bins, nsub,
                                    device=device) for _ in groups]

    def fn():
        out = None
        for roller in rollers:
            roller._prev_raw = roller._prev_sub = None
        for blk in blocks:
            for roller, idxs in zip(rollers, groups):
                series, _ = roller.feed(blk[idxs])
                if series is not None:
                    out = series
        return out
    return fn


# ----------------------------------------------------------------------
# plancache_bucket (modeled)
# ----------------------------------------------------------------------

def _bucket_score(shape, config) -> float:
    """Deterministic cost of a bucket-edge scheme over synthetic
    traffic: each distinct bucket is one plan build, each job pays its
    padding.  Lower is better (modeled seconds)."""
    from presto_tpu_torch.serve.plancache import bucket_quantize
    scheme = config["scheme"]
    compile_s = float(shape.get("compile_s", 20.0))
    job_s = float(shape.get("job_s", 30.0))
    rng = np.random.default_rng(int(shape.get("seed", 23)))
    lengths = np.exp(rng.uniform(np.log(1 << 16), np.log(1 << 24),
                                 size=int(shape.get("jobs", 512))))
    buckets = set()
    pad_cost = 0.0
    for n in lengths:
        q = bucket_quantize(int(n), scheme)
        buckets.add(q)
        pad_cost += job_s * (q / float(n) - 1.0)
    return compile_s * len(buckets) + pad_cost


# ----------------------------------------------------------------------
# oocfft_block
# ----------------------------------------------------------------------

_scratch: Optional[str] = None


def _scratch_dir() -> str:
    global _scratch
    if _scratch is None:
        _scratch = tempfile.mkdtemp(prefix="presto-tune-")
        atexit.register(shutil.rmtree, _scratch, True)
    return _scratch


def _oocfft_bench(shape, config, device):
    """The out-of-core forward FFT of a seeded n-float series at one
    block-buffer size (host: ``device`` is not used)."""
    from presto_tpu_torch.ops.oocfft import realfft_ooc
    n = int(shape.get("n", 1 << 20))
    max_mem = int(config["max_mem"])
    d = _scratch_dir()
    src = os.path.join(d, "tune_%d.dat" % n)
    if not os.path.exists(src) or os.path.getsize(src) != 4 * n:
        rng = np.random.default_rng(9)
        with atomic_open(src, "wb") as f:
            rng.normal(size=n).astype(np.float32).tofile(f)
    dst = os.path.join(d, "tune_%d_%d.fft" % (n, max_mem))

    def fn():
        realfft_ooc(src, dst, forward=True, max_mem=max_mem, tmpdir=d)
    return fn


# ----------------------------------------------------------------------
# the catalog
# ----------------------------------------------------------------------

FAMILIES: Dict[str, Family] = {
    "accel_column_slab": Family(
        name="accel_column_slab",
        doc="Column slab of the accel search (search_many's slab); the "
            "same candidate lists at every slab",
        shape_key=lambda s: key_column_slab(int(s["zmax"]) + 1,
                                            int(s["numharm"]),
                                            int(s["numbins"])),
        candidates=_slab_candidates,
        bench=_slab_bench,
        shapes=lambda smoke: (
            [{"zmax": 4, "numharm": 2, "numbins": 1 << 12,
              "slabs": (1024, 4096)}] if smoke else
            [{"zmax": 200, "numharm": 8, "numbins": 1 << 21}]),
    ),
    "pipeline_inflight_depth": Family(
        name="pipeline_inflight_depth",
        doc="Fused-chain depths: window (1-4) x host ingest depth; "
            "overlap only, byte-identical outputs",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=_inflight_candidates,
        bench=_inflight_bench,
        shapes=lambda smoke: (
            [{"nblocks": 4, "n": 1 << 12, "windows": (1, 2),
              "ingest_depths": (2,)}] if smoke
            else [{"nblocks": 16, "n": 1 << 20}]),
    ),
    "sharded_inflight_depth": Family(
        name="sharded_inflight_depth",
        doc="Window of the DM-sharded seam's FFT chunks (each holds "
            "memory on every mesh device); overlap only",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=_sharded_inflight_candidates,
        bench=_sharded_inflight_bench,
        shapes=lambda smoke: (
            [{"numdms": 8, "n": 1 << 10, "nchunks": 3,
              "windows": (1, 2)}] if smoke
            else [{"numdms": 64, "n": 1 << 18, "nchunks": 8}]),
    ),
    "serve_batch_geometry": Family(
        name="serve_batch_geometry",
        doc="Stacked cross-job batch geometry: max stack x sub-stack "
            "scheme (serve/batchexec.py)",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=_stack_candidates,
        bench=_stack_bench,
        shapes=lambda smoke: (
            [{"jobs": 4, "numdms": 2, "n": 1 << 10,
              "stacks": (2, 4)}] if smoke else
            [{"jobs": 8, "numdms": 32, "n": 1 << 18}]),
    ),
    "beam_stack_size": Family(
        name="beam_stack_size",
        doc="Beams a stacked rolling-dedispersion step in the beam "
            "multiplexer (stream/beams.py); identical per-beam floats",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=_beam_stack_candidates,
        bench=_beam_stack_bench,
        shapes=lambda smoke: (
            [{"beams": 4, "nchan": 8, "nsub": 4, "numdms": 2,
              "blocklen": 128, "nblocks": 3, "stacks": (2, 4)}]
            if smoke else
            [{"beams": 64, "nchan": 64, "nsub": 16, "numdms": 16,
              "blocklen": 4096, "nblocks": 6}]),
    ),
    "plancache_bucket": Family(
        name="plancache_bucket",
        doc="Pad-to-bucket edge scheme of the serve plan cache (modeled "
            "builds-vs-padding cost)",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=lambda s: [{"scheme": "pow2"}, {"scheme": "pow2_half"},
                              {"scheme": "pow2_quarter"}],
        score=_bucket_score,
        shapes=lambda smoke: ([{"jobs": 64}] if smoke else [{"jobs": 512}]),
    ),
    "oocfft_block": Family(
        name="oocfft_block",
        doc="Block-buffer bytes of the out-of-core two-pass FFT",
        shape_key=lambda s: tune.GLOBAL_KEY,
        candidates=lambda s: [
            {"max_mem": int(m)} for m in
            (s.get("max_mems") or (1 << 24, 1 << 26, 1 << 28))],
        bench=_oocfft_bench,
        shapes=lambda smoke: (
            [{"n": 1 << 14, "max_mems": (1 << 16, 1 << 20)}]
            if smoke else [{"n": 1 << 22}]),
    ),
}


def resolve(names: Optional[List[str]] = None) -> List[Family]:
    """Families by name; None/empty = all.  Unknown names raise
    ValueError listing the catalog."""
    if not names:
        return list(FAMILIES.values())
    out = []
    for n in names:
        if n not in FAMILIES:
            raise ValueError("unknown tuning family %r (have: %s)"
                             % (n, ", ".join(sorted(FAMILIES))))
        out.append(FAMILIES[n])
    return out


def tune_family(fam: Family, runner, smoke: bool = True, db=None,
                fingerprint: Optional[str] = None) -> List[tuple]:
    """Sweep (or score) every shape of ``fam`` on ``runner``'s device and
    record each winner in ``db`` (a TuneDB) under ``fingerprint``
    (default: the card's).  Returns [(shape key, winner config,
    median_s or score)]."""
    fp = fingerprint or tune.fingerprint_key()
    out = []
    for shape in fam.shapes(smoke):
        key = fam.shape_key(shape)
        if fam.score is not None:
            scored = [(fam.score(shape, c), c) for c in fam.candidates(shape)]
            merit, cfg = min(scored, key=lambda e: e[0])
            reps = len(scored)
        else:
            best, results = runner.sweep(
                fam.name, key, [(c, fam.bench(shape, c, runner.device))
                                for c in fam.candidates(shape)])
            if best is None:
                raise RuntimeError("tune %s: no candidate ran at %s (%s)"
                                   % (fam.name, key, [(m.config, m.status,
                                                       m.error)
                                                      for m in results]))
            merit, cfg, reps = best.median_s, best.config, best.reps
        if db is not None:
            db.record(fp, fam.name, key, cfg, merit, reps=reps,
                      source="presto-tune")
        out.append((key, cfg, merit))
    return out
