"""In-memory stage seam between the survey's stages (single device).

PyTorch counterpart of ``presto_tpu/pipeline/fusion.py``: prepsubband
deposits the dedispersed DM fan-out as a device tensor
(:class:`SeamBlock`) in a :class:`StageSeam`, and the FFT + search
stage reads it without a disk round trip, then releases the block's
device series.  The durable tier also writes each trial's ``.dat`` from
the bit-identical host copy, so the artifacts equal a staged run's; a
non-durable seam writes one trial's ``.dat`` when the fold asks for it.
:func:`feed_blocks` decodes and preprocesses block k+1 on a worker
thread (:class:`DoubleBufferedIngest`) into a pinned staging buffer
(:class:`UploadRing`) while block k is on the device.  Sharded seams and
telemetry come in later slices.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from presto_tpu_torch.io.datfft import write_dat
from presto_tpu_torch.io.infodata import write_inf
from presto_tpu_torch.ops import fftpack

DEFAULT_INGEST_DEPTH = 2     # host blocks decoded ahead of the device


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
    worker decodes and preprocesses into and the consumer uploads.  A
    buffer returns to the worker's free list with the CUDA event
    recorded after its upload, and acquire() waits on that event before
    handing the buffer out again: an upload in flight is never
    overwritten."""

    def __init__(self, nbuf: int, blocklen: int, nchan: int, device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._bufs = [torch.empty((blocklen, nchan), dtype=torch.float32,
                                  pin_memory=pin) for _ in range(nbuf)]
        self._arrays = [b.numpy() for b in self._bufs]
        self._free: "queue.Queue" = queue.Queue()
        for i in range(nbuf):
            self._free.put((i, None))
        self._closed = threading.Event()

    def acquire(self) -> int:
        """A free buffer's index, its last upload complete."""
        while not self._closed.is_set():
            try:
                i, done = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
            if done is not None:
                done.synchronize()
            return i
        raise RuntimeError("upload ring closed")

    def array(self, i: int) -> np.ndarray:
        return self._arrays[i]

    def upload(self, i: int) -> torch.Tensor:
        """Buffer i on the device, channel-major [nchan, blocklen]: a
        non-blocking copy of the time-major buffer, transposed on the
        device (a copy, so bit-exact); the buffer then goes back to the
        free list."""
        tm = self._bufs[i].to(self.device, non_blocking=True, copy=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._free.put((i, done))
        return tm.t().contiguous()

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
    ``device``) for ``nblocks`` blocks from spectrum ``skip`` (zeros
    past the data).  The decode, preprocessing (``prep``) and upload
    staging of block k+1 run on a worker thread (DoubleBufferedIngest)
    while block k is on the device."""
    # a buffer for each block queued, the one being filled and the one
    # being uploaded
    depth = DEFAULT_INGEST_DEPTH
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


class StageSeam:
    """In-memory seam between survey stages.  ``durable`` writes each
    deposited block's ``.dat`` at once (the staged contract); ``.inf``
    sidecars are written on every tier.  A non-durable seam spills one
    trial's ``.dat`` on demand (ensure_dat), journaled in ``manifest``
    (pipeline/manifest.SurveyManifest) when one is given."""

    def __init__(self, workdir: str, durable: bool = True, manifest=None):
        self.workdir = os.path.abspath(workdir)
        self.durable = bool(durable)
        self.manifest = manifest
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


def fused_rfft_batch(series_dev: torch.Tensor) -> torch.Tensor:
    """Batched packed real FFT of a seam block [n, N] -> float32 pairs
    [n, N/2, 2] on the same device."""
    return fftpack.realfft_packed_pairs(series_dev)
