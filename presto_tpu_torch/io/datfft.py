"""`.dat` (float32 time series) and `.fft` (packed complex64) file I/O.

Host copy of ``presto_tpu/io/datfft.py`` for the PyTorch port, which imports
nothing from the JAX package.

Artifact parity with the reference: a `.dat` is raw little-endian
float32 samples; a `.fft` is the NR-packed real FFT written by realfft
(src/fastffts.c:198-270): n/2 complex64 values where element 0 holds
(DC, Nyquist) packed as (re, im) and elements 1..n/2-1 are the positive
-frequency amplitudes.  Both carry a `.inf` sidecar.

All writes are atomic (tmp + fsync + rename, io/atomic.py) so a killed
prepsubband/realfft never leaves a truncated artifact under its final
name; reads validate element alignment and (when a sidecar is
available) the sample count, raising a typed PrestoIOError on
mismatch instead of silently returning a short series.
"""

from __future__ import annotations

import os

import numpy as np

from presto_tpu_torch.io.atomic import atomic_open
from presto_tpu_torch.io.errors import PrestoIOError
from presto_tpu_torch.io.infodata import InfoData, read_inf, write_inf


def _check_aligned(path: str, itemsize: int, what: str) -> int:
    """File size must be a whole number of `itemsize`-byte elements;
    returns the element count."""
    size = os.path.getsize(path)
    if size % itemsize:
        raise PrestoIOError(
            "truncated %s (size %d is not a multiple of %d)"
            % (what, size, itemsize), path=path,
            expected_bytes=(size // itemsize + 1) * itemsize,
            actual_bytes=size, kind="truncated-data")
    return size // itemsize


def write_dat(path: str, data: np.ndarray, info: InfoData | None = None):
    with atomic_open(path, "wb") as f:
        data.astype(np.float32).tofile(f)
    if info is not None:
        base = path[:-4] if path.endswith(".dat") else path
        info.name = base
        info.N = data.size
        write_inf(info, base + ".inf")


def write_sdat(path: str, data: np.ndarray,
               info: InfoData | None = None):
    """Raw int16 `.sdat` with prepdata -shorts semantics
    (prepdata.c:696-744): subtract offset = floor(mean); if the dynamic
    range slightly exceeds int16 (< 1.5x) clip the low values by using
    offset = max - SHRT_MAX; if it is way too large, refuse (return
    None so the caller keeps floats).  Returns the applied offset.
    C-cast truncation toward zero is preserved via np.trunc."""
    avg, mx, mn = float(data.mean()), float(data.max()), float(data.min())
    offset = float(np.floor(avg))
    if (mx - mn) > 65535.0:
        if (mx - mn) < 1.5 * 65535.0:
            offset = mx - 32767.0
        else:
            return None
    q = np.trunc(data.astype(np.float64) + 1e-20 - offset)
    q = np.clip(q, -32768, 32767).astype("<i2")
    with atomic_open(path, "wb") as f:
        q.tofile(f)
    if info is not None:
        base = path[:-5] if path.endswith(".sdat") else path
        info.name = base
        info.N = data.size
        write_inf(info, base + ".inf")
    return offset


def read_dat(path: str, expected_n: int | None = None) -> np.ndarray:
    n = _check_aligned(path, 4, ".dat time series")
    if expected_n is not None and n != expected_n:
        raise PrestoIOError(
            ".dat sample count %d != expected %d" % (n, expected_n),
            path=path, expected_bytes=4 * expected_n,
            actual_bytes=4 * n, kind="size-mismatch")
    return np.fromfile(path, dtype=np.float32)


def read_dat_with_inf(path: str):
    """(.dat samples, InfoData), cross-checked: a sample count that
    disagrees with the sidecar's N means the pair is torn (one of the
    two updated, the other not) and raises PrestoIOError."""
    base = path[:-4] if path.endswith(".dat") else path
    info = read_inf(base)
    data = read_dat(base + ".dat", expected_n=int(info.N))
    return data, info


def write_fft(path: str, packed: np.ndarray, info: InfoData | None = None):
    """packed: complex64 array of n/2 NR-packed amplitudes."""
    with atomic_open(path, "wb") as f:
        packed.astype(np.complex64).tofile(f)
    if info is not None:
        base = path[:-4] if path.endswith(".fft") else path
        info.name = base
        write_inf(info, base + ".inf")


def read_fft(path: str, expected_n: int | None = None) -> np.ndarray:
    n = _check_aligned(path, 8, ".fft spectrum")
    if expected_n is not None and n != expected_n:
        raise PrestoIOError(
            ".fft amplitude count %d != expected %d" % (n, expected_n),
            path=path, expected_bytes=8 * expected_n,
            actual_bytes=8 * n, kind="size-mismatch")
    return np.fromfile(path, dtype=np.complex64)
