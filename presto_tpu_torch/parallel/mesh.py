"""Device mesh for the DM-sharded pipeline, on PyTorch.

PyTorch counterpart of ``presto_tpu/parallel/mesh.py``.  The reference's
only distributed axis is DM trials over MPI ranks (mpiprepsubband: rank 0
reads and broadcasts the raw blocks, each worker owns numdms/(numprocs-1)
DM trials, no worker-to-worker traffic).  Here a :class:`Mesh` is an
ordered tuple of ``torch.device`` with axis names; the DM axis is split
into one contiguous row range per mesh entry (:func:`shard_row_ranges`),
each range computed on its entry's device.  Raw blocks are copied to
every distinct device (the MPI_Bcast), and nothing else crosses devices.

:func:`visible_devices` is the port's ``jax.devices()``: every CUDA card,
or ``n`` logical shards of one device inside :func:`set_logical_devices`
(the counterpart of the JAX tests' ``--xla_force_host_platform_device_
count``; the tests and the chip run use it, a one-card machine can show
the sharded path no other way).  Logical shards of one card share its
memory and its stream: they prove the per-shard programs and the
placement plumbing, not a speed-up.

:func:`init_distributed` joins a multi-process run (``prepsubband
-coordinator``) through ``torch.distributed`` with the gloo backend:
nothing on the compute path crosses processes (each rank dedisperses its
own shards from its own read of the file), so the process group only
carries the join and the final barrier, and gloo lets two ranks share
one card, which NCCL refuses.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.search.accel import resolve_device

_logical: Optional[Tuple[int, torch.device]] = None


@contextlib.contextmanager
def set_logical_devices(n: int, device="cuda") -> Iterator[None]:
    """Inside this context visible_devices() of ``device``'s type answers
    ``n`` logical shards of ``device`` (process-wide)."""
    global _logical
    prev = _logical
    _logical = (int(n), resolve_device(device))
    try:
        yield
    finally:
        _logical = prev


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh may take: the logical shards when
    set_logical_devices is active for this device type, else every CUDA
    card (``device`` "cuda") or the one CPU."""
    dev = resolve_device(device)
    if _logical is not None and _logical[1].type == dev.type:
        return [_logical[1]] * _logical[0]
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices (one entry per shard; logical shards
    repeat a device) and the mesh's axis names and shape."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("dm",)
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),)
                               + (1,) * (len(self.axis_names) - 1))
        n = 1
        for s in self.shape:
            n *= int(s)
        if n != len(self.devices) or len(self.shape) != len(self.axis_names):
            raise ValueError("mesh: shape %s and axes %s for %d devices"
                             % (self.shape, self.axis_names,
                                len(self.devices)))

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dm",),
              shape: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
    """A mesh over the first ``n_devices`` visible devices (default: all).
    On "cuda" with no card it raises."""
    devs = visible_devices(device)
    if n_devices is None:
        n_devices = len(devs)
    if not 1 <= n_devices <= len(devs):
        raise ValueError("make_mesh: %d devices asked, %d visible"
                         % (n_devices, len(devs)))
    return Mesh(tuple(devs[:n_devices]), tuple(axis_names),
                tuple(shape) if shape is not None else ())


def shard_row_ranges(mesh: Mesh, nrows: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) ranges of a ``nrows``-long leading axis split
    over the mesh, in mesh order.  ``nrows`` must divide evenly; callers
    pad first."""
    n = mesh.size
    if nrows % n:
        raise ValueError("shard_row_ranges: %d rows do not divide over %d "
                         "devices" % (nrows, n))
    per = nrows // n
    return [(k * per, (k + 1) * per) for k in range(n)]


def dm_sharding(mesh: Mesh, nrows: int
                ) -> List[Tuple[torch.device, Tuple[int, int]]]:
    """(device, (lo, hi)) of each shard of a DM axis of ``nrows`` rows."""
    return list(zip(mesh.devices, shard_row_ranges(mesh, nrows)))


def batch_sharding(mesh: Mesh, nrows: int
                   ) -> List[Tuple[torch.device, Tuple[int, int]]]:
    """(device, (lo, hi)) of each shard of a stacked micro-batch's
    leading axis (coalesced same-bucket jobs, or a job's DM fan-out),
    split over the mesh's first axis as dm_sharding splits a DM axis:
    the counterpart of the JAX package's NamedSharding over
    mesh.axis_names[0].  ``nrows`` need not divide: each shard takes
    ceil(nrows / size) rows, the last ones fewer (none past the end)."""
    per = -(-int(nrows) // mesh.size)
    return [(d, (min(k * per, nrows), min((k + 1) * per, nrows)))
            for k, d in enumerate(mesh.devices)]


def replicated(mesh: Mesh) -> List[torch.device]:
    """The devices that each hold a whole copy of a replicated input (the
    raw blocks): each distinct device once."""
    return mesh.distinct_devices()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = 600.0) -> int:
    """Join a multi-process run (the mpirun analog): the process group on
    ``tcp://<coordinator_address>`` with the gloo backend, world size
    ``num_processes``, rank ``process_id``.  All three are required:
    nothing on the machine tells a process of its cluster.  Joining
    again with the same grid is a no-op.  Returns the world size."""
    import datetime
    import torch.distributed as dist
    manual = (coordinator_address, num_processes, process_id)
    if not all(v is not None for v in manual):
        raise ValueError("init_distributed: pass the coordinator address, "
                         "the process count and this process's id "
                         "(got %r)" % (manual,))
    if dist.is_initialized():
        if (dist.get_world_size() != int(num_processes)
                or dist.get_rank() != int(process_id)):
            raise RuntimeError("init_distributed: already joined as rank "
                               "%d of %d" % (dist.get_rank(),
                                             dist.get_world_size()))
        return dist.get_world_size()
    dist.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def process_index() -> int:
    """This process's rank in the joined run (0 when none was joined)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0
