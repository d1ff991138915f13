// Staged harmonic-sum reduction for the acceleration search (sm_90a).
//
// Replaces the Pallas kernel make_stage_reducer -> reduce_stages of
// presto_tpu/search/accel_pallas.py (VMEM window banks, 128-lane gathers,
// bf16x3 one-hot matmul).
//
// What it computes: for every search column j = start_cols[s] + t and
// every plane row z, the staged sum
//     acc = P[z, j];  then per stage st >= 1, per odd harm < 2^st:
//     acc += P[zinds[term, z], round_half_up(j * harm / 2^st)]
// and after each stage the max over z and its row (lowest z on a tie):
//     colmax[s, st, t], colz[s, st, t].
// The adds run in the same term order as the JAX package (stage by stage,
// ascending odd harm), so the float32 sums are identical to its bits.
//
// What bounds it on this card: device memory.  The fundamental plane must
// be read once (3.5 GB at zmax=200 over 2^21 bins); the subharmonic reads
// touch a fraction of the rows at a fraction of the columns and are served
// from L2 when neighbouring threads share them.  There are ~numz * (1 +
// nterms) adds per column, far below the card's rate.
//
// Design: one thread per column, looping over z ascending with each
// stage's running max and argmax in registers (the stage count is a
// template parameter, so the term loops unroll).  Neighbouring threads
// read neighbouring columns, so every load is coalesced; the row map is
// the same for the whole warp and broadcasts from L1.

#include <cuda_runtime.h>
#include <math_constants.h>

template <int NST>
__global__ void __launch_bounds__(256)
stage_reduce_kernel(const float* __restrict__ P, long long ldp, int nrows,
                    const int* __restrict__ start_cols,
                    const int* __restrict__ zinds, float* __restrict__ colmax,
                    int* __restrict__ colz, int nslabs, int slab) {
  constexpr int NTERMS = (1 << (NST - 1)) - 1;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nslabs * slab) return;
  const int s = (int)(gid / slab);
  const int t = (int)(gid - (long long)s * slab);
  const long long j = (long long)start_cols[s] + t;
  long long rind[NTERMS > 0 ? NTERMS : 1];
  {
    int ti = 0;
#pragma unroll
    for (int st = 1; st < NST; ++st) {
      const long long htot = 1LL << st;
#pragma unroll
      for (int harm = 1; harm < (1 << st); harm += 2) {
        // round-half-up of j*harm/htot without overflow (accel.py split)
        rind[ti++] = (j / htot) * harm + ((j % htot) * harm + (htot >> 1)) / htot;
      }
    }
  }
  float best[NST];
  int bz[NST];
#pragma unroll
  for (int st = 0; st < NST; ++st) {
    best[st] = -CUDART_INF_F;
    bz[st] = 0;
  }
  for (int z = 0; z < nrows; ++z) {
    float acc = P[(long long)z * ldp + j];
    if (acc > best[0]) {
      best[0] = acc;
      bz[0] = z;
    }
    int ti = 0;
#pragma unroll
    for (int st = 1; st < NST; ++st) {
#pragma unroll
      for (int q = 0; q < (1 << (st - 1)); ++q, ++ti) {
        const int zr = __ldg(zinds + ti * nrows + z);
        acc += P[(long long)zr * ldp + rind[ti]];
      }
      if (acc > best[st]) {
        best[st] = acc;
        bz[st] = z;
      }
    }
  }
#pragma unroll
  for (int st = 0; st < NST; ++st) {
    const long long o = ((long long)s * NST + st) * slab + t;
    colmax[o] = best[st];
    colz[o] = bz[st];
  }
}

extern "C" int stage_reduce(const void* P, long long ldp, int nrows,
                            const void* start_cols, const void* zinds,
                            void* colmax, void* colz, int nslabs, int slab,
                            int nstages, void* stream) {
  const long long n = (long long)nslabs * slab;
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)P;
  const int* sc = (const int*)start_cols;
  const int* zi = (const int*)zinds;
  float* cm = (float*)colmax;
  int* cz = (int*)colz;
  switch (nstages) {
    case 1: stage_reduce_kernel<1><<<grid, 256, 0, st>>>(p, ldp, nrows, sc, zi, cm, cz, nslabs, slab); break;
    case 2: stage_reduce_kernel<2><<<grid, 256, 0, st>>>(p, ldp, nrows, sc, zi, cm, cz, nslabs, slab); break;
    case 3: stage_reduce_kernel<3><<<grid, 256, 0, st>>>(p, ldp, nrows, sc, zi, cm, cz, nslabs, slab); break;
    case 4: stage_reduce_kernel<4><<<grid, 256, 0, st>>>(p, ldp, nrows, sc, zi, cm, cz, nslabs, slab); break;
    case 5: stage_reduce_kernel<5><<<grid, 256, 0, st>>>(p, ldp, nrows, sc, zi, cm, cz, nslabs, slab); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
