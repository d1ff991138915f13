"""CUDA build and dispatch telemetry (obs layer).

PyTorch counterpart of ``presto_tpu/obs/jaxtel.py``.  The work the
port does between its Python lines is the card's: the nvcc builds of
the kernel libraries (presto_tpu_torch/cuda_build.py), the searcher
plans the plan cache builds (serve/plancache.py), host<->device copies
and device-buffer occupancy.  This module gives those events names on
the shared metrics registry.  The metric names stay the JAX package's,
so dashboards, ``metrics()`` and ``transfer_snapshot`` keep one shape
across the two packages; in the port they count:

  jax_compiles_total{kind}        kernel-library builds (nvcc) and
                                  searcher-plan constructions
  jax_compile_seconds{kind}       their wall time histogram
  jax_dispatches_total{kind}      batched device-chain dispatches
                                  (one rFFT / search / single-pulse
                                  call over a batch of trials)
  jax_device_put_bytes_total      host -> device copy volume
  jax_device_get_bytes_total      device -> host copy volume
  jax_donated_bytes_total         buffers released to the allocator for
                                  reuse by the next stage
  jax_live_buffer_bytes           torch.cuda.memory_allocated (last)
  jax_live_buffer_hwm_bytes       its high-water mark

The dispatch counter joins with obs/costmodel's analytic per-dispatch
unit costs (kernel_flops_total{kind} / kernel_hbm_bytes_total{kind}).
Every helper takes the Observability handle and is one branch when
observability is disabled.
"""

from __future__ import annotations

from typing import Optional

import torch


def note_build(name: str, seconds: float) -> None:
    """cuda_build's hook: one kernel library compiled, booked on the
    process default handle (obs.get_obs: off until obs.configure), as
    a library is the process's, not one service's."""
    from presto_tpu_torch.obs import get_obs
    note_compile(get_obs(), kind="nvcc:%s" % name, seconds=seconds)


def device_id(device=None) -> str:
    """Stable identity of a torch device ('cuda_0', 'cpu_0'): the plan
    cache records it per plan so a device error evicts exactly the
    plans bound to that device.  None: the current CUDA device when a
    card is visible, else the CPU."""
    if device is None:
        if torch.cuda.is_available():
            return "cuda_%d" % torch.cuda.current_device()
        return "cpu_0"
    d = torch.device(device)
    if d.type == "cuda":
        idx = d.index
        if idx is None:
            # the current device; with no card visible no plan can be
            # bound to one, and the first card's identity names it
            idx = (torch.cuda.current_device()
                   if torch.cuda.is_available() else 0)
        return "cuda_%d" % idx
    return "%s_%d" % (d.type, d.index or 0)


def current_device_id() -> str:
    """The identity the scheduler's device-error eviction uses."""
    return device_id(None)


def note_compile(obs, kind: str, seconds: float, key=None,
                 device: Optional[str] = None) -> None:
    """One build (a kernel library's nvcc run, or a searcher plan's
    construction): count it, time it, remember it."""
    if obs is None or not obs.enabled:
        return
    obs.metrics.counter(
        "jax_compiles_total", "Kernel-library builds and plan "
        "constructions", ("kind",)).labels(kind=kind).inc()
    obs.metrics.histogram(
        "jax_compile_seconds", "Build wall time",
        ("kind",)).labels(kind=kind).observe(seconds)
    obs.flightrec.add("compile", plan_kind=kind,
                      seconds=round(float(seconds), 4),
                      key=repr(key) if key is not None else "",
                      device=device or "")


_DISPATCH_HELP = ("Batched device-chain dispatches (rFFT/search/"
                  "single-pulse calls)")


def note_dispatch(obs, kind: str, n: int = 1) -> None:
    """One batched device-chain dispatch: a single rFFT / accel-search /
    single-pulse call covering however many trials ride its batch
    axis.  The stacked serve executor's win is fewer of these for the
    same job count."""
    if obs is None or not obs.enabled:
        return
    obs.metrics.counter("jax_dispatches_total", _DISPATCH_HELP,
                        ("kind",)).labels(kind=kind).inc(int(n))
    from presto_tpu_torch.obs import costmodel
    costmodel.attribute_dispatch(obs, kind, int(n))


def note_put(obs, nbytes: int) -> None:
    """Host -> device copy volume."""
    if obs is None or not obs.enabled:
        return
    obs.metrics.counter("jax_device_put_bytes_total",
                        "Bytes uploaded host to device").inc(int(nbytes))


def note_get(obs, nbytes: int) -> None:
    """Device -> host copy volume."""
    if obs is None or not obs.enabled:
        return
    obs.metrics.counter("jax_device_get_bytes_total",
                        "Bytes downloaded device to host").inc(int(nbytes))


def note_donation(obs, nbytes: int) -> None:
    """Buffer bytes released for the next stage's reuse (a seam block's
    series handed back once its FFT has consumed it)."""
    if obs is None or not obs.enabled:
        return
    obs.metrics.counter("jax_donated_bytes_total",
                        "Buffer bytes donated for reuse").inc(int(nbytes))


def transfer_snapshot(obs) -> dict:
    """Current copy / donation / build / dispatch / cost totals off the
    shared registry (zeros when observability is disabled, so callers
    can diff snapshots unconditionally)."""
    out = {"put_bytes": 0, "get_bytes": 0, "donated_bytes": 0,
           "compiles": 0, "compile_seconds": 0.0, "dispatches": 0,
           "kernel_flops": 0.0, "kernel_hbm_bytes": 0.0}
    if obs is None or not obs.enabled:
        return out
    reg = obs.metrics
    out["dispatches"] = int(reg.counter(
        "jax_dispatches_total", _DISPATCH_HELP, ("kind",)).total())
    out["put_bytes"] = int(reg.counter(
        "jax_device_put_bytes_total",
        "Bytes uploaded host to device").value)
    out["get_bytes"] = int(reg.counter(
        "jax_device_get_bytes_total",
        "Bytes downloaded device to host").value)
    out["donated_bytes"] = int(reg.counter(
        "jax_donated_bytes_total", "Buffer bytes donated for reuse").value)
    comp = reg.counter("jax_compiles_total", "Kernel-library builds and "
                       "plan constructions", ("kind",))
    hist = reg.histogram("jax_compile_seconds", "Build wall time",
                         ("kind",))
    out["compiles"] = int(comp.total())
    out["compile_seconds"] = float(sum(h.sum for _l, h in hist.children()))
    for snap_key, name in (("kernel_flops", "kernel_flops_total"),
                           ("kernel_hbm_bytes", "kernel_hbm_bytes_total")):
        fam = reg.get(name)
        out[snap_key] = float(fam.total()) if fam is not None else 0.0
    return out


def sample_live_buffers(obs, device=None) -> Optional[int]:
    """Sample the live device-buffer bytes (torch.cuda.memory_allocated
    on ``device``'s card) into the gauge pair.  A CPU device has no
    allocator to read: None, and no sample."""
    if obs is None or not obs.enabled:
        return None
    d = torch.device(device) if device is not None else None
    if d is None or d.type != "cuda":
        return None
    nbytes = int(torch.cuda.memory_allocated(d))
    obs.metrics.gauge("jax_live_buffer_bytes",
                      "Live device buffer bytes (last sample)").set(nbytes)
    obs.metrics.gauge("jax_live_buffer_hwm_bytes",
                      "Live device buffer bytes high-water mark"
                      ).set_max(nbytes)
    return nbytes
