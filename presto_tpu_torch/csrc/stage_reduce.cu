// Staged harmonic-sum reduction for the acceleration search (Hopper, sm_90a).
//
// Replaces the Pallas kernel make_stage_reducer -> reduce_stages of
// presto_tpu/search/accel_pallas.py (its pl.pallas_call is at :245; VMEM
// window banks, 128-lane gathers, a bf16x3 one-hot matmul).
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
// The multi-plane variant (MULTI, C entry stage_reduce_planes) computes the
// same sums with the fundamental read from planes[0] and term i from
// planes[i + 1] (the jerk search: each subharmonic has its own w plane, as
// the JAX package's XLA scan _scan_planes_py, presto_tpu/search/accel.py,
// reads them).  All planes share nrows and ldp.  The pointer table is
// copied to shared memory once a CTA; everything else is the single-plane
// kernel, whose instantiations (MULTI false) compile to the same code.
//
// What bounds it on this card: device memory.  Each input read once is
// the plane (3.53 GB at zmax 200 over 2^21 bins, 1.09 ms at 3.35 TB/s).
// But a column tile needs, besides its own columns, a window of each
// term's columns (h/htot of the tile's width) over the rows the z map
// sends the tile's rows to (about h/htot of them), and those windows are
// other tiles' columns, so each CTA reads them again: ~3.5x the plane at
// numharm 8 and ~6.4x at numharm 16 (chip_smoke.py prints this design
// byte count).  Going below it needs reuse across tiles in L2 or a fused
// build + reduce.
//
// Design:
//  * One CTA per (slab, tile of THREADS columns), one column a thread.  It
//    walks z in chunks of ZC rows through a ring of STAGES shared-memory
//    buffers: chunk c + 1 is copied with 16-byte cp.async while chunk c is
//    summed, one barrier a chunk.  Four CTAs an SM at numharm 8 (51 KB of
//    shared memory and at most 64 registers each), two at numharm 16.
//  * A thread's own column (the fundamental) needs no neighbour's data: it
//    is loaded straight into registers, a chunk ahead.
//  * A buffer holds, per term, the rows [zinds[term][z0], zinds[term][z0 +
//    ZC - 1]] of the term's window, each from the 16-byte-aligned address
//    at or below the window's first column.  A z map is nondecreasing and,
//    over the real rows, steps by 0 or 1, so a term's rows in a chunk
//    number at most CAP = ceil((ZC - 1) h / htot) + 2.  A chunk where some
//    term needs more is marked direct, and its terms are read from global
//    memory: the chunk that straddles numz (the pad rows map to
//    themselves, so every map jumps there), or any chunk where a map climbs
//    faster than the searcher's maps do.
//  * Addressing.  Beside the data, each buffer holds a table of 32-bit
//    shared-memory offsets, one per (row of the chunk, term), which folds
//    in the window's row slot and its alignment shift (row starts are
//    unaligned for an odd ldp).  A thread computes its column's offset in
//    each window once a tile, so the inner loop per row and term is one
//    shared load, one add and, at a stage's end, the max update; the table
//    row comes in 16-byte loads.  Neighbouring threads read the same or
//    adjacent words (h/htot < 1): no bank conflicts.  Global offsets stay
//    64-bit (one wide multiply of 32-bit row and ldp): the zmax-400 plane
//    has 1.75 G cells.
//  * The last tile of a slab is masked; windows past the plane's end are
//    zero-filled by the copy (cp.async src-size), never read beyond it.
//  * Geometry fixed at compile time: THREADS, ZC, STAGES below, and per
//    stage count the window sizes in Geo<NST>.
//  * Multi-plane: the same windows and the same bytes a tile as the
//    single-plane kernel (each term has its own window either way); what
//    differs is the bound, since each distinct plane is an input read
//    once, over the rows and columns its terms name.  Three CTAs an SM
//    (the pointer table's registers spill under four at numharm 8).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;  // columns a tile, one a thread
constexpr int ZC = 8;         // z rows a chunk
constexpr int STAGES = 2;     // chunk buffers in the ring

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Term i in the order the sums are taken: stage st >= 1 holds the odd
// harms below 2^st, so term i is harm 2 (i - 2^(st-1) + 1) + 1 over 2^st.
__host__ __device__ constexpr int term_stage(int i) {
  int st = 1;
  while ((1 << st) - 1 <= i) ++st;
  return st;
}
__host__ __device__ constexpr int term_harm(int i) {
  return 2 * (i - ((1 << (term_stage(i) - 1)) - 1)) + 1;
}
// round_half_up(j * harm / 2^st) without overflow (the accel.py split)
__host__ __device__ constexpr int term_col(int j, int i) {
  const int st = term_stage(i), h = term_harm(i);
  return (j >> st) * h + (((j & ((1 << st) - 1)) * h + (1 << (st - 1))) >> st);
}
// a term's distinct columns over a tile: at most ceil((T-1) h / htot) + 1;
// its window row stride covers those plus an alignment shift of up to 3
__host__ __device__ constexpr int term_width(int i) {
  return 4 * cdiv(cdiv((THREADS - 1) * term_harm(i), 1 << term_stage(i)) + 4,
                  4);
}
__host__ __device__ constexpr int term_cap(int i) {
  return cdiv((ZC - 1) * term_harm(i), 1 << term_stage(i)) + 2;
}

// static_for<0, N>(f) calls f(Int<0>{}), ..., f(Int<N - 1>{}): the term
// index is a constant in each call, so every window's geometry folds
template <int I>
struct Int {
  static constexpr int value = I;
};
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<I + 1, N>(f);
  }
}

template <int NST>
struct Geo {
  static constexpr int NTERMS = (1 << (NST - 1)) - 1;
  static constexpr int NE = NTERMS + 1;  // offset-table entries a row
  // float offset of term i's window in a buffer
  __host__ __device__ static constexpr int base(int i) {
    int b = 0;
    for (int k = 0; k < i; ++k) b += term_cap(k) * term_width(k);
    return b;
  }
  static constexpr int DATA = base(NTERMS);
  static constexpr int TABLE = ZC * NE + 4;  // offsets, then the direct flag
  static constexpr int BUF = DATA + TABLE;   // a multiple of 4 (16 bytes)
  static constexpr int SMEM = STAGES * BUF * 4;
  // the multi-plane kernel's pointer table follows the ring
  static constexpr int SMEM_MULTI = SMEM + NE * 8;
  // CTAs an SM that its 228 KB of shared memory holds (1 KB each reserved)
  static constexpr int FIT = 233472 / (SMEM + 1024);
  static constexpr int MINB = FIT < 4 ? FIT : 4;
  // the multi-plane kernel's plane pointers cost registers: at numharm 8
  // it spills under the 64 that four CTAs an SM leave, so it asks for 3
  static constexpr int MINB_MULTI = FIT < 3 ? FIT : 3;
  static_assert(BUF % 4 == 0 && (NE % 4 == 0 || NE < 4), "16-byte rows");
  static_assert(ZC * NE <= THREADS, "a thread for each table entry");
};

#ifdef __CUDACC__
// 16 bytes global -> shared, asynchronous, bytes past nbytes zeroed (the
// L2 fetches the source's 256-byte block: windows are row pieces)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int nbytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::
                   "r"(d), "l"(src), "r"(nbytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// 16 bytes of the plane at element idx (a multiple of 4) into dst, with
// the part past the plane's last element (total) zero-filled
__device__ __forceinline__ void copy16(float* dst, const float* P,
                                       long long idx, long long total) {
  const long long left = total - idx;
  const int nbytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
  cp_async16(dst, nbytes ? P + idx : P, nbytes);
}

__device__ __forceinline__ void take_max(float acc, int z, float& best,
                                         int& bz) {
  if (acc > best) {  // strict: the lowest z keeps a tie
    best = acc;
    bz = z;
  }
}

// The plane a read comes from: src(0) the fundamental's, src(i + 1) term
// i's; one plane P, or (MULTI) the pointer table in shared memory.
template <bool MULTI>
struct Src {
  const float* P;
  const float* const* table;
  __device__ __forceinline__ const float* operator()(int k) const {
    if constexpr (MULTI)
      return table[k];
    else
      return P;
  }
};

// Issue the copies of chunk c into buffer B and write its offset table.
template <int NST, class S>
__device__ __forceinline__ void stage_chunk(float* B, S src,
                                            int ldp, int nrows,
                                            const int* __restrict__ zinds,
                                            int c, int j0, int tid) {
  using g = Geo<NST>;
  const long long total = (long long)nrows * ldp;
  const int z0 = c * ZC;
  const int rows = min(ZC, nrows - z0);
  const int* zc = zinds + z0;  // term i's map of the chunk: zc[i * nrows]
  bool direct = false;
  static_for<0, g::NTERMS>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int CAP = term_cap(i);
    direct |=
        __ldg(zc + i * nrows + rows - 1) - __ldg(zc + i * nrows) + 1 > CAP;
  });
  if (!direct) {
    static_for<0, g::NTERMS>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      constexpr int W = term_width(i), U = W / 4, BASE = g::base(i);
      const int lo = __ldg(zc + i * nrows);
      const int n = __ldg(zc + i * nrows + rows - 1) - lo + 1;
      const int cb = term_col(j0, i);
#pragma unroll 1
      for (int u = tid; u < n * U; u += THREADS) {
        const int r = u / U, k = u - r * U;
        const long long a = (((long long)(lo + r) * ldp + cb) & ~3LL) + 4 * k;
        copy16(B + BASE + r * W + 4 * k, src(i + 1), a, total);
      }
    });
  }
  int* O = reinterpret_cast<int*>(B + g::DATA);
  if (tid < rows * g::NE) {
    const int zz = tid / g::NE, e = tid - zz * g::NE;
    int off = 0;  // entry 0 pads the row to 16 bytes
    static_for<0, g::NTERMS>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      constexpr int W = term_width(i), BASE = g::base(i);
      if (e == i + 1) {
        const int zr = __ldg(zc + i * nrows + zz);
        off = direct ? zr
                     : BASE + (zr - __ldg(zc + i * nrows)) * W +
                           (int)(((long long)zr * ldp + term_col(j0, i)) & 3);
      }
    });
    O[tid] = off;
  }
  if (tid == 0) O[ZC * g::NE] = direct;
}

// Column j's values in the rows of chunk c (none past the last row).
__device__ __forceinline__ void load_fund(float (&f)[ZC], const float* P,
                                          int ldp, int nrows, int c, int j,
                                          bool live) {
  const int z0 = c * ZC;
#pragma unroll
  for (int zz = 0; zz < ZC; ++zz)
    if (live && z0 + zz < nrows)
      f[zz] = __ldg(P + (long long)(z0 + zz) * ldp + j);
}

// One table row: the NE offsets of chunk row zz (16-byte loads when NE >= 4)
template <int NE>
__device__ __forceinline__ void load_row(const int* O, int (&o)[NE]) {
  if constexpr (NE >= 4) {
#pragma unroll
    for (int k = 0; k < NE / 4; ++k) {
      const int4 v = reinterpret_cast<const int4*>(O)[k];
      o[4 * k] = v.x;
      o[4 * k + 1] = v.y;
      o[4 * k + 2] = v.z;
      o[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NE; ++k) o[k] = O[k];
  }
}

// One row z of column j: its own value f, then term by term the values
// term(Int<i>) in the sums' order, with each stage's max update.
template <int NST, class Term>
__device__ __forceinline__ void sum_row(float acc, int z, Term term,
                                        float (&best)[NST], int (&bz)[NST]) {
  take_max(acc, z, best[0], bz[0]);
  static_for<0, Geo<NST>::NTERMS>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    acc += term(ic);
    if constexpr (((i + 2) & (i + 1)) == 0) {  // the stage's last term
      constexpr int st = term_stage(i);
      take_max(acc, z, best[st], bz[st]);
    }
  });
}

// Sum chunk c (column j's values f, the term windows in buffer B) into the
// running maxima of column j.
template <int NST, class S>
__device__ __forceinline__ void sum_chunk(const float* B, S src,
                                          int ldp, int nrows, int c,
                                          int j, const float (&f)[ZC],
                                          const int (&co)[Geo<NST>::NE],
                                          float (&best)[NST], int (&bz)[NST]) {
  using g = Geo<NST>;
  const int z0 = c * ZC;
  const int rows = min(ZC, nrows - z0);
  const int* O = reinterpret_cast<const int*>(B + g::DATA);
  if (!O[ZC * g::NE]) {
    auto row = [&](int zz) {
      int o[g::NE];
      load_row<g::NE>(O + zz * g::NE, o);
      sum_row<NST>(f[zz], z0 + zz, [&](auto ic) {
        constexpr int i = decltype(ic)::value;
        return B[o[i + 1] + co[i + 1]];
      }, best, bz);
    };
    if (rows == ZC) {
#pragma unroll
      for (int zz = 0; zz < ZC; ++zz) row(zz);
    } else {
#pragma unroll
      for (int zz = 0; zz < ZC; ++zz)
        if (zz < rows) row(zz);
    }
  } else {
    // the chunk straddles a jump of a z map: terms from global memory,
    // the table holding each term's plane row
#pragma unroll
    for (int zz = 0; zz < ZC; ++zz)
      if (zz < rows) {
        const int* o = O + zz * g::NE;
        sum_row<NST>(f[zz], z0 + zz, [&](auto ic) {
          constexpr int i = decltype(ic)::value;
          return __ldg(src(i + 1) + (long long)o[i + 1] * ldp +
                       term_col(j, i));
        }, best, bz);
      }
  }
}

template <int NST, bool MULTI>
__global__ void __launch_bounds__(THREADS, MULTI ? Geo<NST>::MINB_MULTI
                                                : Geo<NST>::MINB)
stage_reduce_kernel(const float* __restrict__ P, int ldp, int nrows,
                    const int* __restrict__ start_cols,
                    const int* __restrict__ zinds, float* __restrict__ colmax,
                    int* __restrict__ colz, int slab,
                    const float* const* __restrict__ planes) {
  using g = Geo<NST>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const float** table = reinterpret_cast<const float**>(smem + STAGES * g::BUF);
  if constexpr (MULTI) {
    if (tid < g::NE) table[tid] = planes[tid];
    __syncthreads();
  }
  const Src<MULTI> src{P, table};
  const int s = blockIdx.y;
  const int t = blockIdx.x * THREADS + tid;  // column within the slab
  const int j0 = __ldg(start_cols + s) + blockIdx.x * THREADS;
  const int j = j0 + tid;
  const bool live = t < slab;
  // this column's offset in each term window, once a tile (co[0] unused)
  int co[g::NE];
  co[0] = 0;
  static_for<0, g::NTERMS>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    co[i + 1] = term_col(j, i) - term_col(j0, i);
  });
  float best[NST];
  int bz[NST];
#pragma unroll
  for (int st = 0; st < NST; ++st) {
    best[st] = -CUDART_INF_F;
    bz[st] = 0;
  }
  const int nchunks = cdiv(nrows, ZC);
  // the column's own values of chunk c and c + 1, loaded a chunk ahead
  float f[ZC], fnext[ZC];
  load_fund(fnext, src(0), ldp, nrows, 0, j, live);
#pragma unroll 1
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks)
      stage_chunk<NST>(smem + c * g::BUF, src, ldp, nrows, zinds, c, j0, tid);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int zz = 0; zz < ZC; ++zz) f[zz] = fnext[zz];
    load_fund(fnext, src(0), ldp, nrows, c + 1, j, live);
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();              // ... everyone's; chunk c - 1 is summed
    const int cn = c + STAGES - 1;
    if (cn < nchunks)
      stage_chunk<NST>(smem + (cn % STAGES) * g::BUF, src, ldp, nrows, zinds,
                       cn, j0, tid);
    cp_async_commit();
    if (live)
      sum_chunk<NST>(smem + (c % STAGES) * g::BUF, src, ldp, nrows, c, j, f,
                     co, best, bz);
  }
  if (live) {
#pragma unroll
    for (int st = 0; st < NST; ++st) {
      const long long o = ((long long)s * NST + st) * slab + t;
      colmax[o] = best[st];
      colz[o] = bz[st];
    }
  }
}

template <int NST, bool MULTI>
constexpr int smem_bytes() {
  return MULTI ? Geo<NST>::SMEM_MULTI : Geo<NST>::SMEM;
}

// Dynamic shared memory above 48 KB, and the SM's split of its 256 KB
// toward shared memory, so that Geo::MINB CTAs fit.
template <int NST, bool MULTI>
cudaError_t configure() {
  cudaError_t e = cudaFuncSetAttribute(
      stage_reduce_kernel<NST, MULTI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NST, MULTI>());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(stage_reduce_kernel<NST, MULTI>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// P: the plane (MULTI false) or unused; planes: the device pointer table
// (MULTI true) or null.
template <int NST, bool MULTI>
int launch(const void* P, const void* planes, long long ldp, int nrows,
           const void* start_cols, const void* zinds, void* colmax,
           void* colz, int nslabs, int slab, cudaStream_t stream) {
  cudaError_t e = configure<NST, MULTI>();
  if (e != cudaSuccess) return (int)e;
  if (nslabs == 0 || slab == 0) return 0;
  dim3 grid(cdiv(slab, THREADS), nslabs);
  const int smem = smem_bytes<NST, MULTI>();
  stage_reduce_kernel<NST, MULTI><<<grid, THREADS, smem, stream>>>(
      (const float*)P, (int)ldp, nrows, (const int*)start_cols,
      (const int*)zinds, (float*)colmax, (int*)colz, slab,
      (const float* const*)planes);
  return (int)cudaGetLastError();
}

template <int NST, bool MULTI>
int info(int* out) {
  out[0] = THREADS;
  out[1] = ZC;
  out[2] = STAGES;
  out[3] = smem_bytes<NST, MULTI>();
  cudaError_t e = configure<NST, MULTI>();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], stage_reduce_kernel<NST, MULTI>, THREADS,
      smem_bytes<NST, MULTI>());
}

}  // namespace

// P: float32 [nrows, ldp], 16-byte aligned, ldp < 2^31 - 256;
// start_cols int32 [nslabs];
// zinds int32 [2^(nstages-1) - 1, nrows], each row nondecreasing.
extern "C" int stage_reduce(const void* P, long long ldp, int nrows,
                            const void* start_cols, const void* zinds,
                            void* colmax, void* colz, int nslabs, int slab,
                            int nstages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ldp <= 0 || ldp >= (1LL << 31) - THREADS)
    return (int)cudaErrorInvalidValue;  // columns are 32-bit in the kernel
  switch (nstages) {
    case 1: return launch<1, false>(P, nullptr, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 2: return launch<2, false>(P, nullptr, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 3: return launch<3, false>(P, nullptr, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 4: return launch<4, false>(P, nullptr, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 5: return launch<5, false>(P, nullptr, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    default: return (int)cudaErrorInvalidValue;  // no instantiation
  }
}

// planes: device array of 2^(nstages-1) plane pointers (the fundamental's,
// then each term's), each float32 [nrows, ldp] and 16-byte aligned; the
// rest as stage_reduce.  nstages 2..5 (one plane at nstages 1: stage_reduce).
extern "C" int stage_reduce_planes(const void* planes, long long ldp,
                                   int nrows, const void* start_cols,
                                   const void* zinds, void* colmax,
                                   void* colz, int nslabs, int slab,
                                   int nstages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ldp <= 0 || ldp >= (1LL << 31) - THREADS)
    return (int)cudaErrorInvalidValue;
  switch (nstages) {
    case 2: return launch<2, true>(nullptr, planes, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 3: return launch<3, true>(nullptr, planes, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 4: return launch<4, true>(nullptr, planes, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    case 5: return launch<5, true>(nullptr, planes, ldp, nrows, start_cols, zinds, colmax, colz, nslabs, slab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The geometry of one instantiation: out = {threads a CTA, rows a chunk,
// chunk buffers, dynamic shared memory bytes, CTAs an SM}; multi selects
// the multi-plane kernel (nstages 2..5).
extern "C" int stage_reduce_info(int nstages, int multi, int* out) {
  if (multi) {
    switch (nstages) {
      case 2: return info<2, true>(out);
      case 3: return info<3, true>(out);
      case 4: return info<4, true>(out);
      case 5: return info<5, true>(out);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (nstages) {
    case 1: return info<1, false>(out);
    case 2: return info<2, false>(out);
    case 3: return info<3, false>(out);
    case 4: return info<4, false>(out);
    case 5: return info<5, false>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
