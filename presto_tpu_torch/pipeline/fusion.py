"""In-memory stage seam between the survey's stages.

PyTorch counterpart of ``presto_tpu/pipeline/fusion.py``: prepsubband
deposits the dedispersed DM fan-out as a device tensor
(:class:`SeamBlock`) in a :class:`StageSeam`, and the FFT + search
stage reads it without a disk round trip, then releases the block's
device series.  On the DM-sharded mesh path the deposit is a
:class:`ShardedSeamBlock`: one tensor per shard, on the device that
dedispersed those DM rows, which the FFT, the search and the
single-pulse search consume in place (:func:`fused_rfft_batch` with a
mesh transforms each shard on its own device); the host copy is
assembled shard by shard (:func:`gather_shards`).  The durable tier also writes each trial's ``.dat`` from
the bit-identical host copy, so the artifacts equal a staged run's; a
non-durable seam writes one trial's ``.dat`` when the fold asks for it.
:func:`feed_blocks` decodes and preprocesses block k+1 on a worker
thread (:class:`DoubleBufferedIngest`) into a pinned staging buffer
(:class:`UploadRing`) while block k is on the device, and copies it to
every device of a mesh.  The feeder's depth and the sharded seam's
window read the tuning DB when tuning is active (resolve_ingest_depth,
resolve_depth); a seam carries the survey's Observability handle for its
producers' dispatch telemetry.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.io.datfft import write_dat
from presto_tpu_torch.io.infodata import write_inf
from presto_tpu_torch.ops import fftpack

DEFAULT_WINDOW_DEPTH = 2     # sharded FFT chunks queued ahead of their search
DEFAULT_INGEST_DEPTH = 2     # host blocks decoded ahead of the device


def resolve_depth(inflight_depth: Optional[int] = None, obs=None) -> int:
    """The sharded seam's window (the JAX package's ``shard_window``):
    the sharded FFT chunks queued on the mesh before the oldest one's
    search collects (each holds memory on every mesh device).  An
    explicit ``inflight_depth`` sets it; otherwise, with tuning active
    (presto_tpu_torch/tune), the DB's ``sharded_inflight_depth`` window,
    else its ``pipeline_inflight_depth`` window, else the default.
    Clamped to [1, 8]: a depth changes overlap, never bytes."""
    depth = DEFAULT_WINDOW_DEPTH
    from presto_tpu_torch import tune
    if tune.enabled():
        for family in ("pipeline_inflight_depth", "sharded_inflight_depth"):
            cfg = tune.best(family, tune.GLOBAL_KEY, obs=obs)
            if cfg and "window" in cfg:
                depth = int(cfg["window"])
    if inflight_depth is not None:
        depth = int(inflight_depth)
    return max(1, min(depth, 8))


def resolve_ingest_depth(obs=None) -> int:
    """Host blocks the feeder decodes ahead of the device: the tuning
    DB's ``pipeline_inflight_depth`` ingest depth when tuning is
    active, else the default; clamped to [1, 8]."""
    depth = DEFAULT_INGEST_DEPTH
    from presto_tpu_torch import tune
    if tune.enabled():
        cfg = tune.best("pipeline_inflight_depth", tune.GLOBAL_KEY, obs=obs)
        if cfg and "ingest_depth" in cfg:
            depth = int(cfg["ingest_depth"])
    return max(1, min(depth, 8))


def inf_float(x, digits: int = 15) -> float:
    """The value a staged consumer reads back from a ``.inf`` sidecar
    (the ``%.15g`` text round trip of io/infodata)."""
    return float(("%%.%dg" % int(digits)) % float(x))


class DoubleBufferedIngest:
    """Iterate ``source`` on a worker thread, ``depth`` items ahead.
    Items arrive in order; a producer exception is re-raised at the
    consumer's next pull; close() always joins the thread."""

    def __init__(self, source: Iterator,
                 depth: int = DEFAULT_INGEST_DEPTH):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._done = object()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(source,), daemon=True,
            name="presto-ingest")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, source) -> None:
        try:
            for item in source:
                if not self._put(item):
                    return
        except BaseException as e:           # relay to the consumer
            self._exc = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:                                 # unblock a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)


class UploadRing:
    """Host staging buffers of the device feed: ``nbuf`` time-major
    [blocklen, nchan] float32 buffers (pinned when ``device`` is a CUDA
    device, so the upload is an asynchronous DMA) that the ingest
    worker decodes and preprocesses into and the consumer uploads, to
    ``device`` or to each device of a list (a mesh's distinct devices).
    ``lead`` prepends axes to every buffer ([beams, blocklen, nchan]
    for the live beam multiplexer's stacked blocks).
    A buffer returns to the worker's free list with the CUDA events
    recorded after its uploads, and acquire() waits on them before
    handing the buffer out again: an upload in flight is never
    overwritten."""

    def __init__(self, nbuf: int, blocklen: int, nchan: int, device,
                 lead: tuple = ()):
        self._many = isinstance(device, (list, tuple))
        self.devices = ([torch.device(d) for d in device] if self._many
                        else [torch.device(device)])
        self.device = self.devices[0]
        pin = self.device.type == "cuda"
        self._bufs = [torch.empty(tuple(lead) + (blocklen, nchan),
                                  dtype=torch.float32, pin_memory=pin)
                      for _ in range(nbuf)]
        self._arrays = [b.numpy() for b in self._bufs]
        self._free: "queue.Queue" = queue.Queue()
        for i in range(nbuf):
            self._free.put((i, ()))
        self._closed = threading.Event()

    def acquire(self) -> int:
        """A free buffer's index, its last upload complete."""
        while not self._closed.is_set():
            try:
                i, done = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
            for ev in done:
                ev.synchronize()
            return i
        raise RuntimeError("upload ring closed")

    def array(self, i: int) -> np.ndarray:
        return self._arrays[i]

    def upload(self, i: int):
        """Buffer i on the device, channel-major [..., nchan, blocklen]:
        a non-blocking copy of the time-major buffer, transposed on the
        device (a copy, so bit-exact); with a list of devices, a list of
        such copies, one a device (the MPI_Bcast analog).  The buffer
        then goes back to the free list."""
        outs, done = [], []
        for d in self.devices:
            tm = self._bufs[i].to(d, non_blocking=True, copy=True)
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                done.append(ev)
            outs.append(tm.transpose(-1, -2).contiguous())
        self._free.put((i, done))
        return outs if self._many else outs[0]

    def close(self) -> None:
        self._closed.set()


def _host_blocks(fb, prep, ring: UploadRing, blocklen: int, nblocks: int,
                 skip: int) -> Iterator[tuple]:
    """The ingest worker: ``nblocks`` blocks of ``blocklen`` spectra from
    spectrum ``skip`` (zeros past the data), each decoded and
    preprocessed (``prep(block, start)``) into a ring buffer; yields
    (start spectrum, buffer index).  Reads sequentially through the
    reader's prefetching feeder when starting at spectrum 0."""
    N = fb.header.N
    slots = []

    def take():
        slots.append(ring.acquire())
        return ring.array(slots[-1])
    blocks = fb.stream_blocks(blocklen, out=take) if skip == 0 else None
    try:
        for k in range(nblocks):
            nread = skip + k * blocklen
            if nread < N:
                if blocks is not None:
                    block = next(blocks)
                    i = slots.pop()
                else:
                    i = ring.acquire()
                    block = fb.read_spectra(nread, blocklen)
                block = prep(block, nread)
                buf = ring.array(i)
                if block is not buf:
                    np.copyto(buf, block)
            else:
                i = ring.acquire()
                ring.array(i)[:] = 0.0
            yield nread, i
    finally:
        if blocks is not None:
            blocks.close()


def feed_blocks(fb, prep, blocklen: int, nblocks: int, device,
                skip: int = 0) -> Iterator[tuple]:
    """The device feed of a streamed pass over a filterbank: yields
    (start spectrum, channel-major [nchan, blocklen] float32 block on
    ``device``, or a list of such blocks, one on each device of a list)
    for ``nblocks`` blocks from spectrum ``skip`` (zeros past the data).
    The decode, preprocessing (``prep``) and upload staging of block
    k+1 run on a worker thread (DoubleBufferedIngest) while block k is
    on the device."""
    # a buffer for each block queued, the one being filled and the one
    # being uploaded
    depth = resolve_ingest_depth()
    ring = UploadRing(depth + 2, blocklen, fb.header.nchans, device)
    ingest = DoubleBufferedIngest(
        _host_blocks(fb, prep, ring, blocklen, nblocks, skip), depth)
    try:
        for nread, i in ingest:
            yield nread, ring.upload(i)
    finally:
        ring.close()
        ingest.close()


@dataclass
class SeamBlock:
    """One prepsubband method's DM fan-out held at the seam: the padded
    device series, its bit-identical host copy and per-trial metadata."""
    names: List[str]            # per-trial base paths (no extension)
    infos: List[object]         # per-trial InfoData
    dms: List[float]
    series_dev: Optional[torch.Tensor]   # [ntrials, numout] float32
    series_host: np.ndarray     # same values, host side
    valid: int                  # data samples before the pad
    numout: int                 # padded length
    dt: float                   # post-downsample sample time

    def row_on(self, row: int, device) -> torch.Tensor:
        """Trial ``row``'s device series [numout], on ``device``."""
        return self.series_dev[row].to(device)


@dataclass
class ShardedSeamBlock(SeamBlock):
    """A SeamBlock whose ``series_dev`` is a list of per-shard tensors
    [rows_k, numout], shard k holding DM rows ``row_ranges[k]`` on
    ``mesh.devices[k]``, the device that dedispersed them.  Consumers
    work on the shards in place; the host copy was assembled shard by
    shard (gather_shards), never through one device."""
    row_ranges: List[Tuple[int, int]] = field(default_factory=list)
    mesh: object = None

    def row_on(self, row: int, device) -> torch.Tensor:
        for part, (lo, hi) in zip(self.series_dev, self.row_ranges):
            if lo <= row < hi:
                return part[row - lo].to(device)
        raise IndexError("sharded seam block: no shard holds row %d" % row)


def is_sharded(block) -> bool:
    """Is this seam block's device series split over a mesh?"""
    return getattr(block, "mesh", None) is not None


def gather_shards(parts, row_ranges) -> np.ndarray:
    """The host copy of per-shard device tensors: each shard's rows copied
    device-to-host into its own rows of one host array, with no gather
    through one device."""
    nrows = max(hi for _lo, hi in row_ranges)
    out = np.empty((nrows,) + tuple(parts[0].shape[1:]),
                   dtype=np.float32)
    for part, (lo, hi) in zip(parts, row_ranges):
        out[lo:hi] = part.cpu().numpy()
    return out


class StageSeam:
    """In-memory seam between survey stages.  ``durable`` writes each
    deposited block's ``.dat`` at once (the staged contract); ``.inf``
    sidecars are written on every tier.  A non-durable seam spills one
    trial's ``.dat`` on demand (ensure_dat), journaled in ``manifest``
    (pipeline/manifest.SurveyManifest) when one is given.  ``depth`` is
    the sharded chunks' window (resolve_depth); ``obs`` receives the
    producers' dispatch telemetry (prepsubband's dedispersion steps)."""

    def __init__(self, workdir: str, durable: bool = True, manifest=None,
                 inflight_depth: Optional[int] = None, obs=None):
        self.workdir = os.path.abspath(workdir)
        self.durable = bool(durable)
        self.manifest = manifest
        self.obs = obs
        self.depth = resolve_depth(inflight_depth, obs=obs)
        self.blocks: List[SeamBlock] = []
        self._by_dat: Dict[str, tuple] = {}    # abs .dat -> (block, row)

    def add_block(self, block: SeamBlock) -> None:
        self.blocks.append(block)
        for row, name in enumerate(block.names):
            write_inf(block.infos[row], name + ".inf")
            self._by_dat[os.path.abspath(name + ".dat")] = (block, row)
        if self.durable:
            self.spill(block)

    def __len__(self) -> int:
        return sum(len(b.names) for b in self.blocks)

    def dat_paths(self) -> List[str]:
        return sorted(self._by_dat)

    def groups(self) -> Dict[int, List[SeamBlock]]:
        """Blocks grouped by padded length (the FFT/search batch axis)."""
        by_len: Dict[int, List[SeamBlock]] = {}
        for b in self.blocks:
            by_len.setdefault(b.numout, []).append(b)
        return by_len

    def spill(self, block: SeamBlock) -> int:
        """Write one block's ``.dat`` + ``.inf`` from the host copy;
        returns the bytes written."""
        total = 0
        for row, name in enumerate(block.names):
            write_dat(name + ".dat", block.series_host[row],
                      block.infos[row])
            total += block.series_host[row].nbytes
        return total

    def ensure_dat(self, datpath: str) -> bool:
        """Spill ONE trial's ``.dat`` from the host copy on demand (the
        fold reads its candidate's series from disk); nothing to do when
        the durable tier, or an earlier call, already wrote it.  Returns
        True when the path is on disk (or was never seam-held and
        exists)."""
        ent = self._by_dat.get(os.path.abspath(datpath))
        if ent is None or os.path.exists(datpath):
            return os.path.exists(datpath)
        block, row = ent
        write_dat(datpath, block.series_host[row], block.infos[row])
        if self.manifest is not None:
            self.manifest.record_many(
                [p for p in (datpath, block.names[row] + ".inf")
                 if os.path.exists(p)], "prepsubband")
        return True

    def release(self, block: SeamBlock) -> None:
        """Drop the seam's reference to a block's device series once its
        last FFT chunk has consumed it (the host copy stays for
        spills)."""
        block.series_dev = None


def fused_rfft_batch(series_dev, mesh=None):
    """Batched packed real FFT of a seam block [n, N] -> float32 pairs
    [n, N/2, 2] on the same device.  With a ``mesh`` ``series_dev`` is
    the list of per-shard tensors, and each shard's rows are transformed
    on its own device: a list of per-shard pairs, where they were."""
    if mesh is not None:
        return [fftpack.realfft_packed_pairs(part) for part in series_dev]
    return fftpack.realfft_packed_pairs(series_dev)
