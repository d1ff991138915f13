"""DM-sharded dedispersion and search over a device mesh, on PyTorch.

PyTorch counterpart of ``presto_tpu/parallel/sharded.py``.  The
mpiprepsubband invariant (SURVEY.md §4.8): sharded output equals
unsharded output for the same DMs.  The layout of mpiprepsubband.c's DM
partition:

  raw blocks      [C, T]            copied once to each distinct device
  chan delays     [C]               on every shard's device
  per-DM delays   [numdms, nsub]    a contiguous row range per shard
  output series   [numdms, T]       one [rows_k, T] tensor per shard

Each shard runs ``ops/dedispersion.make_block_step`` with its own DM rows
as its delays: the same program, row for row, as the unsharded loop, so
its rows are bit-equal.  A shard's work is queued on its device's current
stream, every shard before anything waits, so the devices compute at
once.  The JAX package's traced (shard_map) and static (per-device)
variants are one per-shard program here.

The search (:func:`sharded_accel_search_many`) builds, reduces, collects
and compacts every trial of a shard on the shard's device, with no host
sync between trials, then copies each shard's compacted candidates down
once and decodes them on the host.  Logical shards of one card (see
parallel/mesh.set_logical_devices) run the same code.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.parallel.mesh import Mesh, shard_row_ranges

#: by shard index, over the sharded_accel_search_many calls (every
#: non-jerk search_many; a one-device search is shard 0): the shard's
#: device, its trials and the launches of each kernel it made (none on
#: the CPU, where the wrappers run the plain versions; cleared by
#: callers that count)
shard_launches: Dict[int, dict] = {}


def _on_devices(mesh: Mesh, block) -> List[torch.Tensor]:
    """One copy of a host (or device) tensor on each distinct device of
    the mesh, listed per shard (shards of one device share the copy)."""
    t = torch.as_tensor(block)
    copies: Dict[torch.device, torch.Tensor] = {}
    for d in mesh.distinct_devices():
        copies[d] = t.to(d, non_blocking=True)
    return [copies[d] for d in mesh.devices]


class ShardedDedispPlan:
    """DM-sharded streaming dedispersion: one make_block_step per shard
    with that shard's DM rows of ``dm_delays`` as its delays.

        plan = ShardedDedispPlan(mesh, nsub, downsamp, chan, dm)
        cur = plan.put_block(blockT)           # per-shard list
        sub = plan.prime(prev_raw, cur)        # first window
        sub, series = plan.step(prev_raw, cur, sub)
        parts = plan.concat(outs)              # per-shard [rows_k, T]
    """

    def __init__(self, mesh: Mesh, numsubbands: int, downsamp: int,
                 chan_delays, dm_delays):
        self.mesh = mesh
        self.devices = list(mesh.devices)
        dm_np = np.asarray(dm_delays, dtype=np.int32)
        self.numdms = int(dm_np.shape[0])
        self.row_ranges = shard_row_ranges(mesh, self.numdms)
        self.numsubbands = int(numsubbands)
        self._chan_np = np.ascontiguousarray(chan_delays, dtype=np.int32)
        self.steps = [dd.make_block_step(self._chan_np, dm_np[lo:hi],
                                         numsubbands, downsamp)
                      for (lo, hi) in self.row_ranges]

    def put_block(self, blockT) -> List[torch.Tensor]:
        """One channel-major block on every shard's device: one copy a
        distinct device (the MPI_Bcast analog)."""
        return _on_devices(self.mesh, blockT)

    def prime(self, prev_raw, cur) -> List[torch.Tensor]:
        """The first window's subband carry, per shard."""
        return [dd.dedisp_subbands_block(pr, cu, self._chan_np,
                                         self.numsubbands)
                for pr, cu in zip(prev_raw, cur)]

    def step(self, prev_raw, cur, prev_sub):
        """One streaming step on every shard: (subs, series) per-shard
        lists; every shard is queued before anything waits."""
        subs, series = [], []
        for st, pr, cu, ps in zip(self.steps, prev_raw, cur, prev_sub):
            sub, ser = st(pr, cu, ps)
            subs.append(sub)
            series.append(ser)
        return subs, series

    def concat(self, outs) -> List[torch.Tensor]:
        """[per-block list of per-shard series] -> per-shard [rows_k, T]
        tensors, each on its shard's device (rows in row_ranges)."""
        return [torch.cat([blk[k] for blk in outs], dim=1)
                for k in range(len(self.devices))]


def make_sharded_dedisperse_step(mesh: Mesh, numsubbands: int,
                                 downsamp: int = 1):
    """(prev_raw, raw, prev_sub, chan_delays, dm_delays) -> (subs,
    series), per-shard lists: the streaming step with the delay tables as
    arguments (the JAX package's traced variant), the same per-shard
    program as ShardedDedispPlan's, whose plans the step keeps by
    table."""
    plans: Dict[tuple, ShardedDedispPlan] = {}

    def step(prev_raw, raw, prev_sub, chan_delays, dm_delays):
        chan = np.ascontiguousarray(chan_delays, dtype=np.int32)
        dm = np.ascontiguousarray(dm_delays, dtype=np.int32)
        key = (chan.tobytes(), dm.shape, dm.tobytes())
        plan = plans.get(key)
        if plan is None:
            plan = plans[key] = ShardedDedispPlan(mesh, numsubbands,
                                                  downsamp, chan, dm)
        return plan.step(prev_raw, raw, prev_sub)

    return step


def sharded_dedisperse_stream(blocks, chan_delays, dm_delays, mesh: Mesh,
                              numsubbands: int, downsamp: int = 1
                              ) -> torch.Tensor:
    """Dedisperse a [nblocks, C, T] stream at [numdms, nsub] delays with
    the DM axis sharded over ``mesh``: [numdms, (nblocks-2)*T/downsamp]
    on the host, each shard's rows copied down on their own.  The carry
    logic matches ops.dedispersion.dedisperse_scan."""
    step = make_sharded_dedisperse_step(mesh, numsubbands, downsamp)
    plan = ShardedDedispPlan(mesh, numsubbands, downsamp, chan_delays,
                             dm_delays)
    prev_raw = plan.put_block(blocks[0])
    raw = plan.put_block(blocks[1])
    prev_sub = plan.prime(prev_raw, raw)
    outs = []
    for i in range(2, len(blocks)):
        cur = plan.put_block(blocks[i])
        prev_sub, series = step(raw, cur, prev_sub, chan_delays, dm_delays)
        outs.append(series)
        raw = cur
    return torch.cat([p.cpu() for p in plan.concat(outs)], dim=0)


# ----------------------------------------------------------------------
# Sequence-sharded six-step FFT
# ----------------------------------------------------------------------

def sixstep_fft(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Complex DFT of x (length N = rows*cols) by the six-step
    decomposition (reference fastffts.c:38-195): x as [rows, cols] ->
    FFT of the columns -> twiddle W_N^(j2*k1) -> FFT of the rows ->
    transpose.  Returns X == torch.fft.fft(x)."""
    N = x.shape[-1]
    cols = N // rows
    A = x.reshape(rows, cols)
    B = torch.fft.fft(A, dim=0)
    C = B * _twiddle(rows, cols, 0, rows, 0, cols, B.device, B.dtype)
    D = torch.fft.fft(C, dim=1)
    return D.T.reshape(-1)


def _twiddle(rows, cols, k0, k1, j0, j1, device, dtype):
    """W_N^(k * j) for k in [k0, k1), j in [j0, j1), N = rows * cols,
    from float64."""
    k = torch.arange(k0, k1, dtype=torch.float64)[:, None]
    j = torch.arange(j0, j1, dtype=torch.float64)[None, :]
    ang = -2.0 * math.pi * ((k * j) % (rows * cols)) / (rows * cols)
    return torch.polar(torch.ones_like(ang), ang).to(dtype).to(device)


def make_sharded_sixstep_fft(mesh: Mesh, rows: int):
    """The six-step FFT with its sequence axis split over the mesh:
    fft_pairs(xp) takes [N, 2] float32 pairs (one tensor or array, split
    into contiguous ranges, or the per-shard pieces) and returns the
    per-shard pieces of the [N, 2] output, split the same way.  Each of
    the decomposition's transposes is an all-to-all done as per-device
    copies: shard k gets its block of every other shard's piece."""
    n = mesh.size

    def ranges(m):
        if m % n:
            raise ValueError("sixstep: %d does not divide over %d shards"
                             % (m, n))
        return [(k * m // n, (k + 1) * m // n) for k in range(n)]

    def fft_pairs(xp):
        if isinstance(xp, (list, tuple)):
            parts = [torch.view_as_complex(p.contiguous()) for p in xp]
        else:
            x = torch.view_as_complex(torch.as_tensor(xp).contiguous())
            N = x.shape[0]
            parts = [x[lo:hi].to(d) for d, (lo, hi) in
                     zip(mesh.devices, ranges(N))]
        N = sum(int(p.shape[0]) for p in parts)
        cols = N // rows
        rr, cranges = ranges(rows), ranges(cols)
        # shard j holds rows rr[j] of A [rows, cols]
        A = [p.reshape(-1, cols) for p in parts]
        # all-to-all 1: shard k gets every row of its column range
        Acol = [torch.cat([a[:, lo:hi].to(mesh.devices[k]) for a in A],
                          dim=0) for k, (lo, hi) in enumerate(cranges)]
        B = [torch.fft.fft(a, dim=0) for a in Acol]
        C = [b * _twiddle(rows, cols, 0, rows, lo, hi, b.device, b.dtype)
             for b, (lo, hi) in zip(B, cranges)]
        # all-to-all 2: shard k gets its k1 rows of every column
        Crow = [torch.cat([C[j][rr[k][0]:rr[k][1]].to(mesh.devices[k])
                           for j in range(n)], dim=1) for k in range(n)]
        D = [torch.fft.fft(c, dim=1) for c in Crow]   # [rows_k, cols]
        # X[k1 + rows * k2] = D[k1, k2]: shard k's output range is its
        # k2 range, every k1 (all-to-all 3)
        out = []
        for k in range(n):
            lo, hi = cranges[k]
            Dk = torch.cat([D[j][:, lo:hi].to(mesh.devices[k])
                            for j in range(n)], dim=0)   # [rows, cols_k]
            X = Dk.T.reshape(-1)
            out.append(torch.stack([X.real, X.imag], dim=-1).to(
                torch.float32))
        return out

    return fft_pairs


# ----------------------------------------------------------------------
# DM-sharded accelsearch
# ----------------------------------------------------------------------

def _shard_inputs(pairs_batch, mesh: Mesh):
    """(per-shard [rows_k, numbins, 2] float32 tensors on their devices,
    the real trial count).  A list of per-shard tensors is used in place;
    one tensor or array is padded to a mesh multiple (padded trials
    repeat the last spectrum; their results are dropped) and split."""
    if isinstance(pairs_batch, (list, tuple)):
        if len(pairs_batch) != mesh.size:
            raise ValueError("sharded search: %d pieces for a %d-shard "
                             "mesh" % (len(pairs_batch), mesh.size))
        parts = []
        for p, d in zip(pairs_batch, mesh.devices):
            if p.device != d:
                raise ValueError("sharded search: a shard on %s, its mesh "
                                 "device is %s" % (p.device, d))
            parts.append(p if p.dtype == torch.float32 else p.float())
        return parts, sum(int(p.shape[0]) for p in parts)
    batch = torch.as_tensor(pairs_batch, dtype=torch.float32)
    nd = int(batch.shape[0])
    pad = (-nd) % mesh.size
    if nd and pad:
        batch = torch.cat([batch] + [batch[-1:]] * pad)
    return [batch[lo:hi].to(d) for d, (lo, hi) in
            zip(mesh.devices, shard_row_ranges(mesh, nd + pad))], nd


def sharded_accel_search_many(searcher, pairs_batch, mesh: Mesh,
                              slab: int = 1 << 20, compact_m: int = None
                              ) -> List[list]:
    """Accelsearch over a DM fan-out with the trial axis split over
    ``mesh`` (the search-stage mpiprepsubband invariant): each shard
    builds (plane_build), reduces (stage_reduce), collects and compacts
    (compact_scan_packed) every one of its trials on its device, queued
    with no host sync between trials; then one device-to-host copy per
    shard, and collect_compacted on the host, with the lossless dense
    fallback for a trial whose compacted budget overflows.  This is
    searcher.search_many's search (a one-device run is a one-entry mesh),
    so the lists do not depend on the mesh.

    pairs_batch: [nd, numbins, 2] float32 (numpy or a tensor), or the
    per-shard tensors already on the mesh's devices.  A jerk search
    (cfg.wmax) goes to searcher.search_many on the searcher's device.
    """
    from presto_tpu_torch.search import accel, accel_cuda, build_cuda
    if compact_m is None:
        compact_m = accel.COMPACT_CANDS
    if searcher.cfg.wmax:
        return searcher.search_many(pairs_batch, slab=slab,
                                    compact_m=compact_m)
    parts, nd = _shard_inputs(pairs_batch, mesh)
    if nd == 0:
        return []
    geom = searcher.plane_geom()
    plan = searcher.slab_plan(geom[2], slab) if geom else None
    if plan is None:
        return [[] for _ in range(nd)]
    slab_, k, start_cols = plan
    nst = searcher.cfg.numharmstages
    for d in mesh.distinct_devices():
        searcher._check_memory(geom[1] * searcher.cfg.uselen, slab_,
                               len(start_cols), device=d)
    pend = []
    for shard, (d, x) in enumerate(zip(mesh.devices, parts)):
        kbank, zinds, powcut = searcher.state_on(d)
        scols = torch.tensor(start_cols, dtype=torch.int32, device=d)
        before = (build_cuda.launches, accel_cuda.launches)
        packs, comps = [], []
        for j in range(x.shape[0]):
            plane = searcher.build_plane(x[j], kbank)
            colmax, colz = accel_cuda.reduce_stages(plane, scols, zinds,
                                                    slab_, nst)
            del plane
            packed = accel.collect_from_reduced(colmax, colz, powcut, k)
            del colmax, colz
            packs.append(packed)
            comps.append(accel.compact_scan_packed(packed, compact_m))
        done = None
        comp = torch.stack(comps) if comps else None
        if comp is not None and d.type == "cuda":
            host = torch.empty(comp.shape, dtype=comp.dtype,
                               pin_memory=True)
            with torch.cuda.device(d):
                host.copy_(comp, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            comp = host
        rec = shard_launches.setdefault(shard, {
            "device": str(d), "trials": 0, "plane_build": 0,
            "stage_reduce": 0})
        rec["trials"] += x.shape[0]
        rec["plane_build"] += build_cuda.launches - before[0]
        rec["stage_reduce"] += accel_cuda.launches - before[1]
        pend.append((packs, comp, done))
    out: List[list] = []
    for packs, comp, done in pend:
        if done is not None:
            done.synchronize()
        for j, packed in enumerate(packs):
            out.append(searcher._decode(comp[j].numpy(), packed,
                                        start_cols, compact_m))
    return out[:nd]
