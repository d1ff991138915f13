"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` (a hand-written CUDA kernel) carries a plain C
entry point and is compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared``; each ``csrc/<name>.cpp``
(host C++: the ingest's decoder and prefetching feeder) with ``g++ -O3
-fPIC -shared -pthread``.  Either goes into
``_build/lib<name>-<source hash>.so`` inside this package (listed in
``.gitignore``) and is loaded with ``ctypes``.  The build runs at first
use; ``build_all`` starts one compiler per source at once.  A missing
toolchain raises: nothing falls back to another implementation.

Each compile is booked through obs/devtel (``jax_compiles_total{kind=
"nvcc:<name>"}``); ``is_built`` answers whether a source's library is
current in the build directory (serve/plancache.PlanStore counts the
plan libraries with it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "presto_tpu_torch need the CUDA toolkit")
    return path


HOST_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-pthread"]


def gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native IO library of "
                           "presto_tpu_torch needs a C++ compiler")
    return path


def _source(name: str) -> str:
    for ext in (".cu", ".cpp"):
        src = os.path.join(CSRC, name + ext)
        if os.path.exists(src):
            return src
    raise FileNotFoundError("no csrc/%s.cu or .cpp" % name)


def _command(src: str, out: str):
    if src.endswith(".cu"):
        return [nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src]
    return [gxx()] + HOST_FLAGS + ["-o", out, src]


def _target(name: str) -> str:
    src = _source(name)
    flags = ARCH if src.endswith(".cu") else " ".join(HOST_FLAGS)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + flags.encode()).hexdigest()
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest[:12]))


def is_built(name: str) -> bool:
    """Is the library of the current ``csrc/<name>`` source (and its
    compiler log) in the build directory?"""
    out = _target(name)
    return os.path.exists(out) and os.path.exists(out + ".txt")


def _start(name: str):
    """Start the compiler for one source (None when the library is
    current)."""
    if is_built(name):
        return None
    out = _target(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (out, os.getpid(), threading.get_ident())
    proc = subprocess.Popen(_command(_source(name), tmp),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.time()


def _finish(name: str, job) -> str:
    """Wait for the compiler; returns its output, kept beside the
    library."""
    if job is None:
        with open(_target(name) + ".txt") as f:
            return f.read()
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("build failed for %s:\n%s"
                           % (os.path.basename(_source(name)), log))
    with open(out + ".txt", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    from presto_tpu_torch.obs import devtel
    devtel.note_build(name, time.time() - t0)
    return log


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source in parallel; returns the compiler's
    output (for a kernel, register and shared-memory use from
    ``-Xptxas -v``) per name."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, j) for n, j in jobs.items()}


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) in nvcc's ``-Xptxas -v`` output: its
    registers, stack frame and spill store / load bytes."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["static_smem"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp`` (built if
    needed; one build at a time in a process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.time()
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name))
            lib.build_seconds = time.time() - t0
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, rc))


def launch(fn, device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device`` (a
    CUDA device) current and raise on its error code: the entry's
    cudaFuncSetAttribute and its <<<>>> launch act on the calling
    thread's current device, and ``stream`` is that device's current
    stream, so a kernel for a tensor on cuda:1 is configured and
    launched on cuda:1 whichever device was current before."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(rc, getattr(fn, "__name__", "kernel"))
