"""The stage reducer's CUDA source, run on the CPU under emulation.

There is no nvcc here, so ``presto_tpu_torch/csrc/stage_reduce.cu`` is
compiled with the host C++ compiler against the emulation header of
``tests/test_torch_plane_build_emu.py``: each CTA runs its threads as
std::threads, a std::barrier stands for ``__syncthreads``, shared memory
is a per-CTA buffer filled with garbage, ``cp.async`` is a plain copy
(zero-filled past its source size) whose commit and wait are no-ops, and
the ``<<<...>>>`` launch becomes a call.  The result is held bit-equal to
``accel_cuda.reduce_stages_plain`` on the same inputs (colmax max error
0, colz equal): the kernel adds the terms in the plain version's order.
This checks the kernel's windows, offset tables, alignment shifts, chunk
ring and masking; it says nothing of speed, and the card check in
chip_smoke.py stays the word on what nvcc builds.

The multi-plane instantiation (C entry ``stage_reduce_planes``, the jerk
search's) is held bit-equal to ``accel_cuda.reduce_stages_planes_plain``
with one to four distinct planes and repeated pointers, and with one
plane repeated to the single-plane entry.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from presto_tpu_torch import cuda_build
from presto_tpu_torch.search import accel, accel_cuda
from test_torch_plane_build_emu import EMU_H


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The stage_reduce, stage_reduce_planes and stage_reduce_info C
    entries, built with the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulation")
    d = tmp_path_factory.mktemp("stage_reduce_emu")
    (d / "cuda_emu.h").write_text(EMU_H)
    with open("%s/stage_reduce.cu" % cuda_build.CSRC) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <math_constants.h>", "")
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = (float4*)emu_smem;")
    src, nsub = re.subn(r"(\w+<NST, MULTI>)<<<([^>]*)>>>\(",
                        r"emu_launch(\1, \2, ", src)
    assert nsub == 1, "the kernel launch was not found"
    (d / "stage_reduce_emu.cpp").write_text(src)
    so = d / "libstage_reduce_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-pthread", "-fno-strict-aliasing", "-I", str(d), "-o",
                    str(so), str(d / "stage_reduce_emu.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.stage_reduce.restype = ctypes.c_int
    lib.stage_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.stage_reduce_planes.restype = ctypes.c_int
    lib.stage_reduce_planes.argtypes = lib.stage_reduce.argtypes
    lib.stage_reduce_info.restype = ctypes.c_int
    lib.stage_reduce_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    return lib


def search_zmaps(zmax, numharm, nrows):
    """The searcher's z maps for (zmax, numharm), the rows from numz to
    nrows mapped to themselves (the plane's pad rows)."""
    cfg = accel.AccelConfig(zmax=zmax, numharm=numharm)
    fz = accel._harm_fracs_and_zinds(cfg, cfg.numz)
    zi = [np.concatenate([z, np.arange(cfg.numz, nrows)])[:nrows]
          for stage in fz for (_h, _t, z) in stage]
    return (np.stack(zi) if zi else np.zeros((0, nrows))).astype(np.int32)


def run_both(lib, P, start_cols, zinds, slab, nstages):
    """The emulated kernel and the plain version on the same inputs."""
    sc = torch.tensor(start_cols, dtype=torch.int32)
    zi = torch.from_numpy(np.ascontiguousarray(zinds))
    nrows, ldp = P.shape
    cm = torch.full((len(start_cols), nstages, slab), float("nan"))
    cz = torch.full((len(start_cols), nstages, slab), -1, dtype=torch.int32)
    rc = lib.stage_reduce(P.data_ptr(), ldp, nrows, sc.data_ptr(),
                          zi.data_ptr(), cm.data_ptr(), cz.data_ptr(),
                          len(start_cols), slab, nstages, None)
    assert rc == 0
    want_m, want_z = accel_cuda.reduce_stages_plain(P, sc, zi, slab, nstages)
    return cm, cz, want_m, want_z


def assert_bit_equal(cm, cz, want_m, want_z):
    assert float((cm - want_m).abs().max()) == 0.0
    assert torch.equal(cm.view(torch.int32), want_m.view(torch.int32))
    assert torch.equal(cz, want_z)


# (zmax, numharm, nrows, ldp, slab, start_cols): the searcher's maps with
# nonzero pad rows and a chunk that straddles numz (the maps' jump), ragged
# slabs at unaligned starts and an odd ldp, aligned slabs over several full
# chunks, and a row count that leaves the last chunk short
CASES = [
    (20, 4, 24, 5000, 1000, [0, 1234, 3999]),
    (20, 8, 24, 5001, 1000, [0, 1234, 3999]),
    (28, 16, 32, 5000, 1000, [0, 1234, 3999]),
    (60, 8, 64, 2048, 512, [0, 768, 1536]),
    (44, 16, 48, 1029, 300, [7, 729]),
    (20, 8, 21, 777, 333, [1, 444]),
    (12, 1, 16, 600, 256, [0, 344]),
    (12, 2, 13, 601, 257, [3, 344]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "z%d-h%d-r%d-ldp%d" % (
    c[0], c[1], c[2], c[3]))
def test_kernel_source_bit_equal_to_plain_under_emulation(emulated, case):
    zmax, numharm, nrows, ldp, slab, start_cols = case
    rng = np.random.default_rng(zmax * 100 + numharm)
    P = torch.from_numpy(rng.random((nrows, ldp), dtype=np.float32))
    tie = start_cols[-1] + 5            # a tie over z: the lowest z wins
    P[:, tie] = P[:, tie].max()
    nstages = int(np.log2(numharm)) + 1
    zi = search_zmaps(zmax, numharm, nrows)
    cm, cz, want_m, want_z = run_both(emulated, P, start_cols, zi, slab,
                                      nstages)
    assert_bit_equal(cm, cz, want_m, want_z)
    assert int(cz[-1, 0, 5]) == 0


def test_jumping_maps_read_from_global_memory(emulated):
    """Nondecreasing maps with steps above one put every chunk over its
    staging capacity: the terms come from global memory, still exact."""
    rng = np.random.default_rng(3)
    nrows, ldp, slab = 40, 900, 400
    P = torch.from_numpy(rng.random((nrows, ldp), dtype=np.float32))
    zi = np.sort(rng.integers(0, nrows, size=(7, nrows)), axis=1)
    zi[:, ::5] = np.arange(0, nrows, 5)     # some steps of 5
    zi = np.maximum.accumulate(zi, axis=1).astype(np.int32)
    cm, cz, want_m, want_z = run_both(emulated, P, [0, 499], zi, slab, 4)
    assert_bit_equal(cm, cz, want_m, want_z)


def test_geometry_fits_shared_memory(emulated):
    """Every instantiation's ring of chunk buffers fits a CTA's 227 KB;
    numharm 8 (4 stages) leaves room for four CTAs an SM; stage counts
    without an instantiation are refused."""
    out = (ctypes.c_int * 5)()
    smem = {}
    for nst in range(1, 6):
        assert emulated.stage_reduce_info(nst, 0, out) == 0
        threads, zc, stages, smem[nst], _ctas = list(out)
        assert (threads, zc, stages) == (256, 8, 2)
        assert 0 < smem[nst] <= 232448
    assert 4 * (smem[4] + 1024) <= 232448
    for nst in (0, 6):
        assert emulated.stage_reduce_info(nst, 0, out) != 0
        assert emulated.stage_reduce(0, 8, 8, 0, 0, 0, 0, 1, 8, nst,
                                     None) != 0


def run_planes(lib, planes, start_cols, zinds, slab, nstages):
    """The emulated multi-plane kernel and its plain version."""
    sc = torch.tensor(start_cols, dtype=torch.int32)
    zi = torch.from_numpy(np.ascontiguousarray(zinds))
    nrows, ldp = planes[0].shape
    table = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
    cm = torch.full((len(start_cols), nstages, slab), float("nan"))
    cz = torch.full((len(start_cols), nstages, slab), -1, dtype=torch.int32)
    rc = lib.stage_reduce_planes(ctypes.addressof(table), ldp, nrows,
                                 sc.data_ptr(), zi.data_ptr(), cm.data_ptr(),
                                 cz.data_ptr(), len(start_cols), slab,
                                 nstages, None)
    assert rc == 0
    want_m, want_z = accel_cuda.reduce_stages_planes_plain(planes, sc, zi,
                                                           slab, nstages)
    return cm, cz, want_m, want_z


# (zmax, numharm, nrows, ldp, slab, start_cols, plane of each slot): 1 to 4
# distinct planes, a plane named by several terms, the fundamental's plane
# reused by a term, and the chunk that straddles numz
PLANE_CASES = [
    (20, 2, 24, 5000, 1000, [0, 1234, 3999], (0, 1)),
    (20, 4, 24, 5001, 1000, [0, 1234, 3999], (0, 1, 2, 3)),
    (20, 4, 21, 777, 333, [1, 444], (0, 1, 1, 2)),
    (20, 8, 24, 5000, 1000, [0, 3999], (0, 1, 2, 3, 2, 1, 0, 3)),
    (28, 16, 32, 1029, 300, [7, 729], (0,) + (1, 2, 3) * 5),
    (12, 4, 16, 600, 256, [0, 344], (0, 0, 0, 0)),
]


@pytest.mark.parametrize("case", PLANE_CASES, ids=lambda c: "h%d-r%d-%s" % (
    c[1], c[2], "".join(map(str, c[6]))))
def test_multi_plane_kernel_bit_equal_to_plain(emulated, case):
    zmax, numharm, nrows, ldp, slab, start_cols, slots = case
    rng = np.random.default_rng(zmax * 10 + numharm + len(set(slots)))
    distinct = [torch.from_numpy(rng.random((nrows, ldp), dtype=np.float32))
                for _ in range(max(slots) + 1)]
    tie = start_cols[-1] + 5            # a tie over z: the lowest z wins
    for P in distinct:
        P[:, tie] = 2.0
    planes = [distinct[k] for k in slots]
    nstages = int(np.log2(numharm)) + 1
    zi = search_zmaps(zmax, numharm, nrows)
    cm, cz, want_m, want_z = run_planes(emulated, planes, start_cols, zi,
                                        slab, nstages)
    assert_bit_equal(cm, cz, want_m, want_z)
    assert int(cz[-1, 0, 5]) == 0


@pytest.mark.parametrize("numharm", [2, 8, 16])
def test_multi_plane_with_one_plane_equals_single_plane(emulated, numharm):
    """One plane in every slot: the multi-plane entry gives the
    single-plane entry's bits."""
    rng = np.random.default_rng(numharm)
    nrows, ldp, slab, start_cols = 24, 3001, 1000, [0, 1500, 2001]
    P = torch.from_numpy(rng.random((nrows, ldp), dtype=np.float32))
    nstages = int(np.log2(numharm)) + 1
    zi = search_zmaps(20, numharm, nrows)
    cm, cz, _m, _z = run_planes(emulated, [P] * numharm, start_cols, zi,
                                slab, nstages)
    sm, sz, _m2, _z2 = run_both(emulated, P, start_cols, zi, slab, nstages)
    assert_bit_equal(cm, cz, sm, sz)


def test_multi_plane_geometry(emulated):
    """The multi-plane instantiations (nstages 2..5) take the single-plane
    ring plus the pointer table (numharm 8 still fits four CTAs an SM);
    nstages 1 and 6 are refused."""
    out = (ctypes.c_int * 5)()
    smem = {}
    for nst in range(2, 6):
        assert emulated.stage_reduce_info(nst, 0, out) == 0
        single = out[3]
        assert emulated.stage_reduce_info(nst, 1, out) == 0
        smem[nst] = out[3]
        assert smem[nst] == single + 8 * (1 << (nst - 1)) <= 232448
    assert 4 * (smem[4] + 1024) <= 232448
    for nst in (1, 6):
        assert emulated.stage_reduce_info(nst, 1, out) != 0
        assert emulated.stage_reduce_planes(0, 8, 8, 0, 0, 0, 0, 1, 8, nst,
                                            None) != 0
