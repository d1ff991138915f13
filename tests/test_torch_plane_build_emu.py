"""The plane builder's CUDA source, run on the CPU under emulation.

There is no nvcc here, so ``presto_tpu_torch/csrc/plane_build.cu`` is
compiled with the host C++ compiler against a small emulation of the
CUDA features it uses: each CTA runs its threads as std::threads, a
std::barrier stands for ``__syncthreads``, shared memory is a per-CTA
buffer filled with garbage, and the ``<<<...>>>`` launch becomes a call.
The result is held against ``build_cuda.build_plane_plain`` on the same
inputs with the card's tolerance (max |kernel - plain| <= 1e-4 *
max |plain|, pads exactly 0).  This checks the kernel's index math,
twiddles, padding and barriers; it says nothing of speed, and the card
check in chip_smoke.py stays the word on what nvcc builds.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from presto_tpu_torch import cuda_build
from presto_tpu_torch.search import build_cuda

EMU_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
#define CUDART_INF_F __builtin_huge_valf()
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9,
       cudaSharedmemCarveoutMaxShared = 100 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F,
                                                                 int, int) {
  *n = 1;
  return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
// cp.async as a plain copy (zero-filling past nbytes); its groups need no
// commit or wait, since the copy has landed when the call returns
inline void cp_async16(float* dst, const float* src, int nbytes) {
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, nbytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
struct Idx { unsigned x, y, z; };
thread_local Idx threadIdx, blockIdx;
thread_local char* emu_smem;
thread_local std::barrier<>* emu_bar;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int nthreads, int smem, cudaStream_t,
                A... args) {
  std::vector<char> sm(smem);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(sm.data(), 0x7f, smem);
      std::barrier<> bar(nthreads);
      std::vector<std::thread> th;
      for (int t = 0; t < nthreads; ++t)
        th.emplace_back([&, t] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          emu_smem = sm.data();
          emu_bar = &bar;
          kernel(args...);
        });
      for (auto& x : th) x.join();
    }
}
"""

# (log2n, nblocks, nb_pad, numz, numz_pad, uselen, off): every
# instantiated n, with pad blocks that are and are not a multiple of the
# blocks a CTA builds, and windows with and without 16-byte stores
CASES = [(8, 5, 8, 3, 8, 96, 64), (8, 6, 7, 2, 3, 97, 63),
         (9, 3, 8, 2, 8, 168, 88), (9, 5, 6, 3, 5, 201, 55),
         (10, 3, 8, 5, 8, 768, 128), (10, 5, 6, 2, 3, 999, 5),
         (11, 5, 8, 3, 8, 1500, 200), (11, 7, 9, 1, 2, 2047, 0),
         (12, 13, 16, 2, 3, 3000, 300), (12, 13, 14, 3, 5, 3001, 301),
         (13, 3, 5, 2, 3, 7680, 256), (13, 2, 3, 2, 3, 7001, 700),
         (14, 2, 3, 1, 2, 15360, 512), (14, 1, 2, 2, 3, 13311, 1537)]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The plane_build C entry, built with the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulation")
    d = tmp_path_factory.mktemp("plane_build_emu")
    (d / "cuda_emu.h").write_text(EMU_H)
    with open("%s/plane_build.cu" % cuda_build.CSRC) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("extern __shared__ float2 buf[];",
                      "float2* buf = (float2*)emu_smem;")
    src, nsub = re.subn(r"(\w+<L>)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ",
                        src)
    assert nsub == 1, "the kernel launch was not found"
    (d / "plane_build_emu.cpp").write_text(src)
    so = d / "libplane_build_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-pthread", "-I", str(d), "-o", str(so),
                    str(d / "plane_build_emu.cpp")], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(so)).plane_build
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "n%d-u%d" % (1 << c[0], c[5]))
def test_kernel_source_matches_plain_under_emulation(emulated, case):
    log2n, nblocks, nb_pad, numz, numz_pad, uselen, off = case
    n = 1 << log2n
    g = torch.Generator().manual_seed(log2n)
    S = torch.randn((nblocks, n // 2), dtype=torch.complex64, generator=g)
    Kc = torch.randn((numz, n), dtype=torch.complex64, generator=g)
    tw = build_cuda._twiddle_table(n, "cpu")
    plane = torch.full((numz_pad, nb_pad * uselen), float("nan"))
    rc = emulated(S.data_ptr(), Kc.data_ptr(), tw.data_ptr(),
                  plane.data_ptr(), nblocks, nb_pad, numz, numz_pad, log2n,
                  uselen, off, None)
    assert rc == 0
    want = build_cuda.build_plane_plain(S, Kc, numz_pad, nb_pad, uselen, off)
    err = float((plane - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max())
    assert not plane[numz:].any()
    assert not plane[:, nblocks * uselen:].any()


def test_uninstantiated_length_is_refused(emulated):
    """log2 n outside 8..14 has no template: the C entry refuses it."""
    tw = torch.zeros(1, dtype=torch.complex64)
    for log2n in (7, 15):
        assert emulated(0, 0, tw.data_ptr(), 0, 1, 8, 1, 8, log2n, 128, 0,
                        None) != 0
