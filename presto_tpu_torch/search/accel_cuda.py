"""Staged harmonic-sum reducer: the CUDA kernel and its plain version.

Counterpart of ``presto_tpu/search/accel_pallas.py`` (the Pallas kernel
``make_stage_reducer`` -> ``reduce_stages``).  The kernel source is
``presto_tpu_torch/csrc/stage_reduce.cu``.

reduce_stages(P, start_cols, zinds, slab, nstages) -> (colmax, colz):
P float32 [nrows, plane_numr]; start_cols int32 [nslabs]; zinds int32
[nterms, nrows], the per-term z-row maps in stage order (stage 1's
harm 1/2, stage 2's 1/4 and 3/4, ...), pad rows mapped to themselves.
For column j = start_cols[s] + t, acc starts at P[:, j] and each term
adds P[zinds[term], round_half_up(j * harm / htot)]; after each stage
colmax[s, stage, t] is the max over rows and colz its lowest row.
The slab layout needs no alignment here: reads stay inside the plane,
since every subharmonic column is <= j.  The kernel needs each z map
nondecreasing (its chunks stage a row range per term); the wrapper checks
that, and the slab bounds, once per input tensor, not per launch.

reduce_stages_planes(planes, start_cols, zinds, slab, nstages) is the
same function over a list of 1 + nterms planes of one shape: the
fundamental from planes[0], term i from planes[i + 1] (the jerk search's
per-subharmonic w planes; the JAX package sums them in the XLA scan
_scan_planes_py, not in its Pallas reducer).  Its kernel is the
multi-plane instantiation of the same source (C entry
stage_reduce_planes).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from presto_tpu_torch import cuda_build

#: kernel launches made by reduce_stages (reset by callers that count)
launches = 0

#: kernel launches made by reduce_stages_planes
planes_launches = 0

#: the launches of both by the index of the CUDA device they ran on
launches_by_device: collections.Counter = collections.Counter()

#: per checked input tensor: (its version counter, what it was checked for)
_checked = WeakIdKeyDictionary()


def stage_terms(nstages: int):
    """(harm, htot) per term, in the order the sums are taken."""
    return [(harm, 1 << st) for st in range(1, nstages)
            for harm in range(1, 1 << st, 2)]


def reduce_stages_plain(P: torch.Tensor, start_cols: torch.Tensor,
                        zinds: torch.Tensor, slab: int, nstages: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the staged gather-add-max loop, one slab at a
    time, adding terms in the kernel's order."""
    return reduce_stages_planes_plain([P] * (1 << (nstages - 1)),
                                      start_cols, zinds, slab, nstages)


def reduce_stages_planes_plain(planes, start_cols: torch.Tensor,
                               zinds: torch.Tensor, slab: int, nstages: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of reduce_stages_planes (and, with one plane
    repeated, of reduce_stages): the fundamental, then the terms in stage
    order and ascending odd harm, term i read from planes[i + 1]."""
    P = planes[0]
    nslabs = start_cols.shape[0]
    terms = stage_terms(nstages)
    zl = zinds.long()
    colmax = torch.empty((nslabs, nstages, slab), dtype=torch.float32,
                         device=P.device)
    colz = torch.empty((nslabs, nstages, slab), dtype=torch.int32,
                       device=P.device)
    for s, s0 in enumerate(start_cols.tolist()):
        cols = s0 + torch.arange(slab, device=P.device, dtype=torch.int64)
        acc = P[:, cols].clone()
        m, z = acc.max(dim=0)
        colmax[s, 0], colz[s, 0] = m, z.int()
        ti = 0
        for stage in range(1, nstages):
            for _ in range(1 << (stage - 1)):
                harm, htot = terms[ti]
                rind = ((cols // htot) * harm
                        + ((cols % htot) * harm + (htot >> 1)) // htot)
                acc += planes[ti + 1][zl[ti][:, None], rind[None, :]]
                ti += 1
            m, z = acc.max(dim=0)
            colmax[s, stage], colz[s, stage] = m, z.int()
        del acc
    return colmax, colz


def _check_once(t: torch.Tensor, key, check) -> None:
    """check(t on the host) unless this tensor, unchanged since, passed
    it for the same key: one device-to-host copy per tensor, not per
    launch."""
    if _checked.get(t) == (t._version, key):
        return
    check(t.cpu())
    _checked[t] = (t._version, key)


def check_zmaps(zinds: torch.Tensor, nrows: int) -> None:
    """Each z map's rows lie in [0, nrows) and never decrease (the pad
    rows map to themselves, above every real row's target)."""
    def check(z):
        if z.numel() and (int(z.min()) < 0 or int(z.max()) >= nrows):
            raise ValueError("reduce_stages: z-row map out of range")
        if bool((z[:, 1:] < z[:, :-1]).any()):
            raise ValueError("reduce_stages: a z-row map decreases")
    _check_once(zinds, ("zinds", nrows), check)


def check_start_cols(start_cols: torch.Tensor, slab: int,
                     numr: int) -> None:
    """Every slab [start, start + slab) lies inside the plane's columns."""
    def check(sc):
        if sc.numel() and (int(sc.min()) < 0
                           or int(sc.max()) + slab > numr):
            raise ValueError("reduce_stages: a slab runs off the plane")
    _check_once(start_cols, ("start_cols", slab, numr), check)


def _check_launch(P: torch.Tensor, start_cols: torch.Tensor,
                  zinds: torch.Tensor, slab: int, nstages: int) -> None:
    """The checks both launches make on their inputs (P: the plane, or
    the first of the planes)."""
    if P.device.type != "cuda" or any(
            t.device != P.device for t in (start_cols, zinds)):
        raise ValueError("reduce_stages: tensors must share one CUDA "
                         "device")
    if (P.dtype != torch.float32 or start_cols.dtype != torch.int32
            or zinds.dtype != torch.int32):
        raise TypeError("reduce_stages: P float32, start_cols and zinds "
                        "int32")
    if not all(t.is_contiguous() for t in (P, start_cols, zinds)):
        raise ValueError("reduce_stages: inputs must be contiguous")
    nrows, numr = P.shape
    nterms = (1 << (nstages - 1)) - 1
    if not 1 <= nstages <= 5 or tuple(zinds.shape) != (nterms, nrows):
        raise ValueError("reduce_stages: nstages=%d with zinds %s for "
                         "%d rows" % (nstages, tuple(zinds.shape), nrows))
    nslabs = start_cols.shape[0]
    # the kernel's columns are int32 (a tile may run 255 past the slab),
    # its grid holds the slabs in y, and it copies 16-byte units
    if numr >= 2 ** 31 - 256 or nslabs >= 65536 or P.data_ptr() % 16:
        raise ValueError("reduce_stages: %d slabs over %d columns (plane "
                         "at %#x) out of the kernel's range"
                         % (nslabs, numr, P.data_ptr()))
    check_start_cols(start_cols, slab, numr)
    check_zmaps(zinds, nrows)


def _launch(entry: str, first, P: torch.Tensor, start_cols: torch.Tensor,
            zinds: torch.Tensor, slab: int, nstages: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch C entry ``entry`` of the stage_reduce library with P's
    device current, on its stream: ``first`` is its first argument (the
    plane, or the device table of plane pointers), P the plane (or the
    first plane) whose shape and device the launch takes.  Returns
    (colmax, colz)."""
    nrows, numr = P.shape
    nslabs = start_cols.shape[0]
    fn = getattr(cuda_build.load("stage_reduce"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    colmax = torch.empty((nslabs, nstages, slab), dtype=torch.float32,
                         device=P.device)
    colz = torch.empty((nslabs, nstages, slab), dtype=torch.int32,
                       device=P.device)
    launches_by_device[P.device.index] += 1
    cuda_build.launch(fn, P.device, first, numr, nrows, start_cols.data_ptr(),
                      zinds.data_ptr(), colmax.data_ptr(), colz.data_ptr(),
                      nslabs, slab, nstages)
    return colmax, colz


def reduce_stages(P: torch.Tensor, start_cols: torch.Tensor,
                  zinds: torch.Tensor, slab: int, nstages: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if P.device.type == "cpu":
        return reduce_stages_plain(P, start_cols, zinds, slab, nstages)
    _check_launch(P, start_cols, zinds, slab, nstages)
    global launches
    launches += 1
    return _launch("stage_reduce", P.data_ptr(), P, start_cols, zinds, slab,
                   nstages)


def reduce_stages_planes(planes, start_cols: torch.Tensor,
                         zinds: torch.Tensor, slab: int, nstages: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring: ``planes`` is a sequence of 2^(nstages-1)
    float32 [nrows, numr] tensors (one may repeat), nstages 2..5.  CPU
    tensors take the plain version; CUDA tensors launch the multi-plane
    kernel."""
    planes = list(planes)
    P = planes[0]
    if len(planes) != 1 << (nstages - 1) or not 2 <= nstages <= 5:
        raise ValueError("reduce_stages_planes: %d planes for %d stages"
                         % (len(planes), nstages))
    if any(p.shape != P.shape or p.dtype != P.dtype or p.device != P.device
           for p in planes):
        raise ValueError("reduce_stages_planes: the planes must share a "
                         "shape, a dtype and a device")
    if P.device.type == "cpu":
        return reduce_stages_planes_plain(planes, start_cols, zinds, slab,
                                          nstages)
    _check_launch(P, start_cols, zinds, slab, nstages)
    if not all(p.is_contiguous() for p in planes) or any(
            p.data_ptr() % 16 for p in planes):
        raise ValueError("reduce_stages_planes: planes must be contiguous "
                         "and 16-byte aligned")
    # the pointer table rides the plane device's stream from pinned
    # memory (no host sync)
    with torch.cuda.device(P.device):
        table = torch.tensor([p.data_ptr() for p in planes],
                             dtype=torch.int64).pin_memory().to(
                                 P.device, non_blocking=True)
    global planes_launches
    planes_launches += 1
    return _launch("stage_reduce_planes", table.data_ptr(), P, start_cols,
                   zinds, slab, nstages)
