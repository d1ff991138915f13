"""The target-scale plan on the card: 4096 DM trials x 2^23 samples.

Counterpart of ``tools/target_scale.py``.  The plan is the reference's
mpiprepsubband configuration at its real shapes (BASELINE config 5):
256 channels in 64 subbands, 2^23 samples of 64 us (T = 536.9 s)
streamed in 2^17-sample blocks (two more prime the carries), DM 0-614
in steps of 0.15 split over 8 devices of 512 trials each, and a 29.7 Hz
pulsar at DM 356.4 in seeded noise.  :class:`Share` holds those
constants as defaults; every field is a parameter, so the tests run the
same code at a small size.

What :func:`run` does on the card (a mesh of ``ndev`` logical shards of
one card, parallel/mesh.set_logical_devices, unless several cards are
visible):

  * the residency plan (:func:`hbm_plan`) from the card's memory;
  * the full-width stage: the first streamed blocks at the real
    [numdms x numpts] shape through parallel/sharded.
    make_sharded_dedisperse_step over the mesh, each bit-equal to the
    one-device ops/dedispersion.float_dedisp_many_block;
  * the probe-width stage: the whole stream at 8 DM rows (the pulsar's
    among them) through the same sharded step, each sampled block's rows
    equal to the full-width rows, the pulsar row bit-equal to the host's
    float32 add order (:class:`HostProbe`), then the zmax search of the
    8 rows on the mesh and on one device with equal candidate lists, the
    pulsar recovered and the DM-0 row clean.

Host blocks (:func:`make_block`, NumPy, byte-equal to the JAX tool's)
are made once for the whole run by worker threads (:func:`host_blocks`)
and handed to every consumer in one pass (:func:`stream_pass`); the
pulsar-DM series of that pass is cached in the package's build
directory for the share's other apps (target_scale_chip,
target_scale_e2e).

Usage: python -m presto_tpu_torch.apps.target_scale [--json FILE]
       [-device cuda] [--numdms N ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import cuda_build
from presto_tpu_torch.io.atomic import atomic_open, atomic_write_text
from presto_tpu_torch.ops import dedispersion as dd
from presto_tpu_torch.ops import fftpack
from presto_tpu_torch.parallel import sharded
from presto_tpu_torch.parallel.mesh import (Mesh, set_logical_devices,
                                            visible_devices)
from presto_tpu_torch.search import accel, accel_cuda, build_cuda

#: DM rows of the probe-width stage (one a shard of an 8-device mesh)
NPROBE = 8
#: blocks streamed at the full width after the two priming blocks
FULL_WIDTH_BLOCKS = 4
#: blocks a consumer of stream_pass may have waiting
CONSUMER_QUEUE = 3


@dataclass(frozen=True)
class Share:
    """The plan's geometry (tools/target_scale.py:64-76 as defaults) and
    the share's search (tools/target_scale_e2e.py:56-61)."""
    numdms: int = 4096           # DM trials of the whole plan
    ndev: int = 8                # devices the plan is split over
    nsamp: int = 1 << 23         # samples of each dedispersed series
    numchan: int = 256
    nsub: int = 64
    numpts: int = 1 << 17        # samples a streamed block
    dt: float = 6.4e-5           # 64 us -> T = 536.9 s
    lofreq: float = 1100.0       # MHz; 100 MHz band at L-band
    chanwidth: float = 0.390625
    dm_lo: float = 0.0           # DM 0 .. 614 pc/cc
    ddm: float = 0.15
    psr_f0: float = 29.7         # the injected pulsar
    psr_dm: float = 356.4
    psr_amp: float = 0.03
    seed: int = 20260730
    zmax: int = 200
    numharm: int = 8
    sigma: float = 6.0
    group: int = 16              # DM trials a search group (e2e)

    @property
    def nblocks(self) -> int:
        """Streamed blocks: the series' blocks and two that prime the
        carries."""
        return self.nsamp // self.numpts + 2

    @property
    def dms_per_dev(self) -> int:
        return self.numdms // self.ndev

    @property
    def T(self) -> float:
        return self.nsamp * self.dt

    @property
    def numbins(self) -> int:
        return self.nsamp // 2


SHARE = Share()


def add_share_args(ap: argparse.ArgumentParser) -> None:
    """One ``--<field>`` option a Share field (default: the plan's)."""
    for f in dataclasses.fields(Share):
        ap.add_argument("--" + f.name, type=type(f.default), default=None,
                        help="share geometry (default %r)" % (f.default,))


def share_argv(share: Share) -> List[str]:
    """The options that make share_from_args give ``share`` back."""
    return [x for f in dataclasses.fields(share)
            for x in ("--" + f.name, repr(getattr(share, f.name)))]


def share_from_args(args) -> Share:
    return Share(**{f.name: getattr(args, f.name)
                    for f in dataclasses.fields(Share)
                    if getattr(args, f.name) is not None})


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-device", "--device", default="cuda",
                    help="device (default cuda; no card raises unless cpu)")
    ap.add_argument("--json", metavar="FILE",
                    help="write the result as JSON to FILE")
    add_share_args(ap)


def card_line(device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None off
    a card): the JSON's "device"."""
    from presto_tpu_torch.apps import profile_accel
    if torch.device(device).type != "cuda":
        return None
    return profile_accel.card_line()


def write_json(path: Optional[str], art: dict) -> None:
    if path:
        atomic_write_text(path, json.dumps(art, indent=1, default=float))


# ----------------------------------------------------------------------
# The plan: delays, blocks, residency
# ----------------------------------------------------------------------

def delays(share: Share = SHARE):
    """(channel delays [numchan], per-DM subband delays [numdms, nsub],
    DMs): tools/target_scale.py's delays() at the share's geometry."""
    dms = share.dm_lo + share.ddm * np.arange(share.numdms)
    chan_d = dd.delays_to_bins(
        dd.subband_search_delays(share.numchan, share.nsub, 0.0,
                                 share.lofreq, share.chanwidth), share.dt)
    dm_d = np.stack([
        dd.delays_to_bins(dd.subband_delays(share.numchan, share.nsub, dm,
                                            share.lofreq, share.chanwidth),
                          share.dt)
        for dm in dms])
    dm_d -= dm_d.min()
    if dm_d.max() >= share.numpts:
        raise ValueError("target_scale: a delay of %d samples does not fit "
                         "a %d-sample block" % (dm_d.max(), share.numpts))
    return (np.asarray(chan_d, np.int32), np.asarray(dm_d, np.int32), dms)


def psr_index(share: Share, dms) -> int:
    return int(np.argmin(np.abs(dms - share.psr_dm)))


def dm_slice(share: Share, dms) -> tuple:
    """Device 0's DM rows, placed so that the pulsar's DM lies inside
    them (tools/target_scale_chip.py:62-68)."""
    per = share.dms_per_dev
    lo = max(0, min(psr_index(share, dms) - per // 2, share.numdms - per))
    return lo, lo + per


def probe_rows(share: Share, dms) -> np.ndarray:
    """The probe-width stage's DM rows (tools/target_scale.py:152-153 at
    4096 DMs): thirds of the range, the pulsar's, the last, and eighths."""
    n = share.numdms
    return np.array([0, n // 3, 2 * n // 3, psr_index(share, dms), n - 1,
                     n // 8, n // 4, n // 2], np.int32)


#: channel rows make_block computes at a time (its float64 temporaries
#: stay in cache)
BLOCK_ROWS = 4


def make_block(i: int, share: Share = SHARE) -> np.ndarray:
    """Raw block i [numchan, numpts] float32: seeded noise and the
    dispersed pulsar, the bytes of tools/target_scale.py's make_block.
    That expression, row by row: the same normal stream cast to float32,
    and the pulse's float64 operations in its order in place (its
    ``np.outer(-tdel, 0)`` term adds -0.0, and ``np.mod`` of a modf
    fraction is the fraction plus 1 where it is negative)."""
    rng = np.random.default_rng(share.seed + i)
    nchan, n = share.numchan, share.numpts
    x = np.empty((nchan, n), np.float32)
    t = (i * n) * share.dt + share.dt * np.arange(n, dtype=np.float64)
    freqs = share.lofreq + share.chanwidth * (np.arange(nchan) + 0.5)
    tdel = 1.0 / 0.000241 * share.psr_dm / freqs ** 2   # dispersion.c:30
    ph = np.empty((BLOCK_ROWS, n))
    ip = np.empty((BLOCK_ROWS, n))
    neg = np.empty((BLOCK_ROWS, n), bool)
    for r0 in range(0, nchan, BLOCK_ROWS):
        k = min(nchan, r0 + BLOCK_ROWS) - r0
        x[r0:r0 + k] = rng.normal(size=(k, n))
        p = ph[:k]
        np.subtract(t[None, :], tdel[r0:r0 + k, None], out=p)
        p *= share.psr_f0
        np.modf(p, p, ip[:k])
        np.less(p, 0.0, out=neg[:k])
        np.add(p, 1.0, out=p, where=neg[:k])
        p -= 0.5
        p /= 0.03
        np.square(p, out=p)
        p *= -0.5
        np.exp(p, out=p)
        p *= share.psr_amp
        x[r0:r0 + k] += p.astype(np.float32)
    return x


def hbm_plan(share: Share = SHARE, total_bytes: Optional[int] = None,
             device="cuda") -> dict:
    """Per-device residency of the plan (bytes): the JAX tool's
    arithmetic (tools/target_scale.py:80-107) for a device of
    ``total_bytes`` (default: the card's memory,
    torch.cuda.get_device_properties), and how many DM trials of full
    series one such device holds beside the streaming working set.
    Raises when the streaming working set does not fit."""
    if total_bytes is None:
        dev = accel.resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("hbm_plan: give total_bytes for a %s device"
                             % dev.type)
        total_bytes = torch.cuda.get_device_properties(dev).total_memory
    per = share.dms_per_dev
    raw_block = share.numchan * share.numpts * 4      # replicated feed
    sub_block = share.nsub * share.numpts * 4
    out_block = per * share.numpts * 4                # DM-sharded output
    full = per * share.nsamp * 4
    streaming = 2 * raw_block + 2 * sub_block + out_block
    plan = {
        "dms_per_device": per,
        "raw_block_bytes": raw_block,
        "subband_block_bytes": sub_block,
        "out_block_bytes_per_device": out_block,
        "streaming_resident_per_device": streaming,
        "full_series_bytes_per_device": full,
        "full_series_fits_hbm": full < total_bytes,
        "streaming_fits_hbm": streaming < total_bytes,
        "device_bytes": int(total_bytes),
        "devices": share.ndev,
        "full_series_trials_per_device": int(
            (total_bytes - streaming) // (share.nsamp * 4)),
    }
    plan["note"] = (
        "%d DMs x %d samples x f32 = %.1f GiB a device against %.1f GiB: "
        "the full series %s; the streaming working set is %.2f GiB, and "
        "one device holds %d trials of full series beside it"
        % (per, share.nsamp, full / 2 ** 30, total_bytes / 2 ** 30,
           "fit" if plan["full_series_fits_hbm"] else
           "do not fit (stream blocks to .dat files, as mpiprepsubband "
           "writes per-worker files)", streaming / 2 ** 30,
           plan["full_series_trials_per_device"]))
    if not plan["streaming_fits_hbm"]:
        raise MemoryError("hbm_plan: the streaming working set (%d bytes) "
                          "exceeds the device's %d" % (streaming,
                                                       total_bytes))
    return plan


# ----------------------------------------------------------------------
# One pass of host blocks
# ----------------------------------------------------------------------

def default_workers() -> int:
    return max(1, (os.cpu_count() or 2) - 1)


def host_blocks(share: Share, n: int):
    """(i, make_block(i, share)) for i < n, in order.  default_workers()
    threads (NumPy releases the GIL in the normal draws and the array
    operations) make the blocks ahead of the consumer, at most two
    each."""
    workers = default_workers()
    ex = ThreadPoolExecutor(workers)
    try:
        futs: deque = deque()
        nxt = 0
        for i in range(n):
            while nxt < n and len(futs) < 2 * workers:
                futs.append(ex.submit(make_block, nxt, share))
                nxt += 1
            yield i, futs.popleft().result()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


class Consumer:
    """A stage fed by stream_pass: ``blocks`` is how many of the first
    blocks it takes; feed(i, block) is called for each in order."""
    blocks = 0

    def feed(self, i: int, block: np.ndarray) -> None:
        raise NotImplementedError


def stream_pass(share: Share, consumers: Sequence[Consumer]) -> dict:
    """One pass of host blocks: each block made once and handed to every
    consumer that takes it, each consumer in a thread of its own (a
    queue of CONSUMER_QUEUE blocks ahead), in order.  Returns the pass's
    seconds, the host seconds spent waiting for blocks and each
    consumer's seconds of work."""
    n = max(c.blocks for c in consumers)
    t0 = time.perf_counter()
    spent: Dict[str, float] = {}
    errors: List[BaseException] = []

    def work(c, q):
        name = type(c).__name__
        spent[name] = 0.0
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                tc = time.perf_counter()
                c.feed(*item)
                spent[name] += time.perf_counter() - tc
        except BaseException as e:        # re-raised by the pass
            errors.append(e)
            while q.get() is not None:    # let the producer finish
                pass

    queues = [queue.Queue(CONSUMER_QUEUE) for _ in consumers]
    threads = [threading.Thread(target=work, args=(c, q), daemon=True)
               for c, q in zip(consumers, queues)]
    for th in threads:
        th.start()
    wait = 0.0
    try:
        tw = time.perf_counter()
        for i, blk in host_blocks(share, n):
            wait += time.perf_counter() - tw
            for c, q in zip(consumers, queues):
                if i < c.blocks:
                    q.put((i, blk))
            tw = time.perf_counter()
    finally:
        for q in queues:
            q.put(None)
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return {"blocks": n, "pass_sec": time.perf_counter() - t0,
            "block_wait_sec": wait, "consumer_sec": spent,
            "workers": default_workers()}


def _window(a: np.ndarray, b: np.ndarray, d: int, n: int) -> np.ndarray:
    """Samples [d, d + n) of the row pair (a, b) concatenated (a view
    when they lie in a)."""
    return a[d:d + n] if d == 0 else np.concatenate((a[d:], b[:d]))


def subbands_np(chan_d: np.ndarray, nsub: int, a: np.ndarray,
                b: np.ndarray) -> np.ndarray:
    """The host's subband pass of one block pair: float32, each subband
    the channel-ascending chain of adds (tools/target_scale_chip.py's
    referee)."""
    numchan, numpts = a.shape
    per = numchan // nsub
    out = np.zeros((nsub, numpts), np.float32)
    for s in range(nsub):
        c0 = s * per
        acc = _window(a[c0], b[c0], int(chan_d[c0]), numpts).astype(
            np.float32)
        for ch in range(c0 + 1, c0 + per):
            acc = acc + _window(a[ch], b[ch], int(chan_d[ch]), numpts)
        out[s] = acc
    return out


def dedisp_rows_np(dm_d: np.ndarray, prev_sub: np.ndarray,
                   sub: np.ndarray) -> np.ndarray:
    """The host's DM fan-out of one block: [ndm, numpts] float32, each row
    the subband-ascending chain of adds."""
    nsub, numpts = sub.shape
    y2 = np.concatenate([prev_sub, sub], axis=1)
    out = np.zeros((dm_d.shape[0], numpts), np.float32)
    for d in range(dm_d.shape[0]):
        acc = y2[0, dm_d[d, 0]:dm_d[d, 0] + numpts].copy()
        for s in range(1, nsub):
            acc = acc + y2[s, dm_d[d, s]:dm_d[d, s] + numpts]
        out[d] = acc
    return out


class HostProbe(Consumer):
    """The pulsar-DM series dedispersed on the host over the whole stream
    (tools/target_scale_e2e.py's _host_probe_series), float32."""

    def __init__(self, share: Share, chan_d, dly):
        self.share = share
        self.blocks = share.nblocks
        self.chan_d = np.asarray(chan_d)
        self.dly = np.asarray(dly)[None, :]
        self.series = np.zeros(share.nsamp, np.float32)
        self._raw = None
        self._sub = None

    def feed(self, i, block):
        if i >= 1:
            sub = subbands_np(self.chan_d, self.share.nsub, self._raw, block)
            if i >= 2:
                n = self.share.numpts
                self.series[(i - 2) * n:(i - 1) * n] = dedisp_rows_np(
                    self.dly, self._sub, sub)[0]
            self._sub = sub
        self._raw = block


def probe_cache_path(share: Share) -> str:
    """The cached pulsar-DM series of a share, in the package's build
    directory, keyed by every field of the share (each one a generation
    parameter)."""
    fp = hashlib.sha1(repr(dataclasses.astuple(share)).encode()
                      ).hexdigest()[:12]
    return os.path.join(cuda_build.BUILD_DIR, "target_probe_%s.npy" % fp)


def save_probe(share: Share, series: np.ndarray) -> str:
    path = probe_cache_path(share)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with atomic_open(path, "wb") as f:
        np.save(f, np.asarray(series, np.float32))
    return path


def probe_series(share: Share = SHARE):
    """(the pulsar-DM series [nsamp] float32, host seconds it took): from
    the cache, else one pass of host blocks (then cached)."""
    path = probe_cache_path(share)
    t0 = time.perf_counter()
    if os.path.exists(path):
        return np.load(path), 0.0
    chan_d, dm_d, dms = delays(share)
    hp = HostProbe(share, chan_d, dm_d[psr_index(share, dms)])
    stream_pass(share, [hp])
    save_probe(share, hp.series)
    return hp.series, time.perf_counter() - t0


def probe_pairs(series: np.ndarray, nsamp: Optional[int] = None
                ) -> np.ndarray:
    """Packed spectrum [n/2, 2] float32 of the first ``nsamp`` samples of
    a series (default all), mean-free in float64 and transformed by the
    float64 rfft (tools/target_scale_e2e.py:606-608)."""
    import scipy.fft as sfft
    s = np.asarray(series[:nsamp or len(series)], np.float32).copy()
    n = s.shape[0]
    s -= s.mean(dtype=np.float64)
    X = sfft.rfft(s.astype(np.float64))[:n // 2]
    return np.stack([X.real, X.imag], -1).astype(np.float32)


# ----------------------------------------------------------------------
# The card's stages
# ----------------------------------------------------------------------

def share_mesh(share: Share, device) -> Mesh:
    """The plan's ``ndev`` devices: every card when enough are visible,
    else logical shards of the one device."""
    dev = accel.resolve_device(device)
    devs = visible_devices(dev)
    if dev.type == "cuda" and len(devs) >= share.ndev:
        return Mesh(tuple(devs[:share.ndev]))
    with set_logical_devices(share.ndev, dev):
        return Mesh(tuple(visible_devices(dev)))


class DeviceClock:
    """Device ms of a span (CUDA events) on a card, host ms elsewhere.
    With ``stream`` the span's work runs on that stream, after what the
    current stream has queued and before what it queues next, so that
    the span holds none of the kernels other threads queue meanwhile
    (they may still run beside it)."""

    def __init__(self, dev, stream=None):
        self.cuda = dev.type == "cuda"
        self.dev = dev
        self.stream = stream if self.cuda else None

    def __enter__(self):
        if self.cuda:
            self.a, self.b = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
            if self.stream is not None:
                self._outer = torch.cuda.current_stream(self.dev)
                self.stream.wait_stream(self._outer)
                self._ctx = torch.cuda.stream(self.stream)
                self._ctx.__enter__()
            self.a.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.b.record()
            if self.stream is not None:
                self._ctx.__exit__(*exc)
                self._outer.wait_stream(self.stream)
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


class FullWidth(Consumer):
    """The full-width stage: the first ``nsample`` streamed blocks (after
    the two priming blocks) at [numdms x numpts] through the sharded
    step, each held bit-equal to the one-device fan-out; the probe rows
    of each kept.  The step is timed on a stream of its own: the other
    consumers' kernels are not in its span, though they may run beside
    it on the card."""

    def __init__(self, share: Share, mesh: Mesh, chan_d, dm_d, rows,
                 nsample: int = FULL_WIDTH_BLOCKS):
        self.share = share
        self.blocks = 2 + nsample
        self.mesh = mesh
        self.dev = mesh.devices[0]
        self.chan_d, self.dm_d = chan_d, dm_d
        self.rows = torch.as_tensor(np.asarray(rows, np.int64),
                                    device=self.dev)
        self.plan = sharded.ShardedDedispPlan(mesh, share.nsub, 1, chan_d,
                                              dm_d)
        self.step = sharded.make_sharded_dedisperse_step(mesh, share.nsub)
        self.dm_dev = torch.as_tensor(dm_d.astype(np.int64), device=self.dev)
        self.kept: Dict[int, torch.Tensor] = {}
        self.equal: List[bool] = []
        self.ms: List[float] = []
        self.stream = (torch.cuda.Stream(self.dev)
                       if self.dev.type == "cuda" else None)
        self._raw = self._sub = None

    def feed(self, i, block):
        cur = self.plan.put_block(block)
        if i == 1:
            self._sub = self.plan.prime(self._raw, cur)
        elif i >= 2:
            with DeviceClock(self.dev, self.stream) as c:
                sub, series = self.step(self._raw, cur, self._sub,
                                        self.chan_d, self.dm_d)
            self.ms.append(c.ms)
            got = torch.cat([s.to(self.dev) for s in series])
            # the one-device run of the same block
            want = dd.float_dedisp_many_block(
                self._sub[0], dd.dedisp_subbands_block(
                    self._raw[0], cur[0], self.chan_d, self.share.nsub),
                self.dm_dev)
            self.equal.append(bool(torch.equal(got, want)))
            self.kept[i - 2] = got[self.rows].clone()
            del got, want, series
            self._sub = sub
        self._raw = cur

    def result(self) -> dict:
        per = float(np.median(self.ms)) if self.ms else None
        return {"full_width_blocks": len(self.ms),
                "full_width_shape": [self.share.numdms, self.share.numpts],
                "full_width_bit_equal": bool(self.equal) and all(self.equal),
                "full_width_ms_per_block": per,
                "full_width_extrapolated_sec": (
                    per * (self.share.nblocks - 2) / 1e3 if per else None)}


class ProbeWidth(Consumer):
    """The probe-width stage: the whole stream at the probe rows through
    the sharded step, the series kept on the device."""

    def __init__(self, share: Share, mesh: Mesh, chan_d, dm_d, rows):
        self.share = share
        self.blocks = share.nblocks
        self.mesh = mesh
        self.dev = mesh.devices[0]
        self.chan_d = chan_d
        self.dm_p = np.ascontiguousarray(dm_d[rows])
        self.plan = sharded.ShardedDedispPlan(mesh, share.nsub, 1, chan_d,
                                              self.dm_p)
        self.step = sharded.make_sharded_dedisperse_step(mesh, share.nsub)
        self.series = torch.empty((len(rows), share.nsamp),
                                  dtype=torch.float32, device=self.dev)
        self.t0 = None
        self._raw = self._sub = None

    def feed(self, i, block):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        cur = self.plan.put_block(block)
        if i == 1:
            self._sub = self.plan.prime(self._raw, cur)
        elif i >= 2:
            sub, series = self.step(self._raw, cur, self._sub, self.chan_d,
                                    self.dm_p)
            n = self.share.numpts
            self.series[:, (i - 2) * n:(i - 1) * n] = torch.cat(
                [s.to(self.dev) for s in series])
            self._sub = sub
        self._raw = cur


def search_config(share: Share) -> accel.AccelConfig:
    return accel.AccelConfig(zmax=share.zmax, numharm=share.numharm,
                             sigma=share.sigma)


def harmonic_of(f: float, f0: float, tol: float = 1e-3) -> bool:
    ratio = f / f0
    return round(ratio) >= 1 and abs(ratio - round(ratio)) < tol


def cand_rows(cands) -> list:
    return [[c.numharm, c.r, c.z, c.power, c.sigma] for c in cands]


def probe_search(share: Share, mesh: Mesh, series: torch.Tensor,
                 psr_row: int) -> dict:
    """The probe rows' spectra searched on the mesh (parallel/sharded.
    sharded_accel_search_many, each shard's rows on its device) and on
    one device (search_many): equal lists, the pulsar on top of its row,
    nothing at the pulsar's frequency in row 0 (DM 0)."""
    dev = mesh.devices[0]
    s = accel.AccelSearch(search_config(share), T=share.T,
                          numbins=share.numbins, device=dev)
    pairs = fftpack.realfft_packed_pairs(
        series - series.mean(dim=-1, keepdim=True))
    per = pairs.shape[0] // mesh.size
    parts = [pairs[k * per:(k + 1) * per].to(d)
             for k, d in enumerate(mesh.devices)]
    t0 = time.perf_counter()
    on_mesh = sharded.sharded_accel_search_many(s, parts, mesh)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = s.search_many(pairs)
    t_one = time.perf_counter() - t0
    equal = [cand_rows(a) == cand_rows(b) for a, b in zip(on_mesh, one)]
    top = accel.remove_duplicates(one[psr_row])
    c = top[0] if top else None
    rec = None if c is None else {
        "f": c.freq(share.T), "sigma": c.sigma, "numharm": c.numharm,
        "n_cands": len(top)}
    recovered = (c is not None and harmonic_of(c.freq(share.T), share.psr_f0)
                 and c.sigma > 50)
    clean = not any(abs(x.freq(share.T) - share.psr_f0) < 0.01
                    and x.sigma > 20
                    for x in accel.remove_duplicates(one[0]))
    return {"lists_equal_sharded_vs_one_device": all(equal),
            "lists_equal_by_row": equal,
            "ncands_by_row": [len(x) for x in one],
            "search_mesh_sec": t_mesh, "search_one_device_sec": t_one,
            "pulsar_recovered": rec, "pulsar_ok": bool(recovered),
            "wrong_dm_clean": bool(clean)}


def run(share: Share = SHARE, device="cuda",
        consumers: Sequence[Consumer] = ()):
    """(result, pulsar-DM series): the virtual-mesh run at the share's
    geometry (see the module docstring); ``consumers`` ride the same pass
    of host blocks.  The pulsar-DM series is also cached for the share's
    other apps."""
    dev = accel.resolve_device(device)
    t_all = time.perf_counter()
    art = {"device": card_line(dev), "torch_device": str(dev),
           "config": {k: v for k, v in dataclasses.asdict(share).items()},
           "nblocks": share.nblocks}
    art["hbm_plan"] = hbm_plan(share, device=dev) if dev.type == "cuda" \
        else None
    chan_d, dm_d, dms = delays(share)
    psr = psr_index(share, dms)
    rows = probe_rows(share, dms)
    if NPROBE % share.ndev:
        raise ValueError("target_scale: %d probe rows over %d devices"
                         % (NPROBE, share.ndev))
    mesh = share_mesh(share, dev)
    art["mesh"] = [str(d) for d in mesh.devices]
    full = FullWidth(share, mesh, chan_d, dm_d, rows)
    probe = ProbeWidth(share, mesh, chan_d, dm_d, rows)
    host = HostProbe(share, chan_d, dm_d[psr])
    before = (build_cuda.launches, accel_cuda.launches)
    art["stream"] = stream_pass(share, [full, probe, host] + list(consumers))
    art.update(full.result())
    n = share.numpts
    art["probe_stream_matches_full_width"] = all(
        bool(torch.equal(probe.series[:, k * n:(k + 1) * n], rows_k))
        for k, rows_k in full.kept.items())
    k_psr = int(np.flatnonzero(rows == psr)[0])
    host_dev = torch.as_tensor(host.series, device=dev)
    art["probe_row_equals_host"] = bool(torch.equal(probe.series[k_psr],
                                                    host_dev))
    del host_dev, full
    art["probe_cache"] = save_probe(share, host.series)
    art["probe_rows"] = rows.tolist()
    art["psr_dm_index"] = psr
    art.update(probe_search(share, mesh, probe.series, k_psr))
    art["launches"] = {"plane_build": build_cuda.launches - before[0],
                       "stage_reduce": accel_cuda.launches - before[1]}
    art["total_sec"] = time.perf_counter() - t_all
    art["ok"] = bool(art["full_width_bit_equal"]
                     and art["probe_stream_matches_full_width"]
                     and art["probe_row_equals_host"]
                     and art["lists_equal_sharded_vs_one_device"]
                     and art["pulsar_ok"] and art["wrong_dm_clean"])
    return art, host.series


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="target_scale")
    add_common_args(ap)
    args = ap.parse_args(argv)
    art, _series = run(share_from_args(args), device=args.device)
    write_json(args.json, art)
    print(json.dumps(art, indent=1, default=float))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
