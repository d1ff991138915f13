// F-Fdot plane build for the acceleration search (Hopper, sm_90a).
//
// Replaces the Pallas kernel make_plane_builder -> build of
// presto_tpu/search/build_pallas.py (its pl.pallas_call is at :136; a
// factored DFT as MXU matmuls over a 64x128 stage layout).
//
// What it computes: for z-row z and r-block b,
//     plane[z, b*uselen + i] = |IFFT_n(S_b[k mod n/2] * Kc_z[k])[off + i]|^2
// for i in [0, uselen), where S_b is the block's forward spectrum (the FFT
// of the x2-spread block equals the length-n/2 FFT tiled twice), Kc_z the
// conjugated FFT'd z-response kernel, and the inverse FFT carries 1/n.
// Rows z >= numz and blocks b >= nblocks are written as zeros.
//
// What bounds it on this card: device memory.  The plane is written once
// (numz_pad * nb_pad * uselen * 4 bytes: 3.53 GB at zmax 200 over 2^21
// bins, 1.06 ms at 3.35 TB/s); S and the kernel bank (18 + 14 MB) stay in
// the 50 MB L2.  The FFT is ~5 n log2 n flops a row, under 1 ms at the
// float32 rate, but a radix-2 FFT in shared memory took 22x the bound.
// What the design does about each cost on the way to the bound:
//
//  * Register-resident Stockham FFT.  Each thread holds G groups of 16
//    complex values (T = n / (16 G) threads a CTA) and does radix-16
//    butterflies in registers: n = 16 * 16 * 16 * {2, 4} or
//    16 * 16 * {1, 2, 4, 8, 16} (n = 256 and 512 are for short spectra
//    at small zmax).  At n = 8192 and 16384 (FUSE) a thread holds
//    as many groups as the last radix (2 or 4), so the last radix runs
//    across its groups in registers right after the last radix-16 pass:
//    2 shared-memory exchanges a row, where the radix-2 FFT took 13
//    passes.  The ordering is self-sorting: the first pass reads the
//    product in natural order straight from global memory and the last
//    pass leaves natural order, so there is no bit-reversed scatter.
//  * Conflict-free exchanges.  The exchange buffer stores element i at
//    i + i/16: the first pass's stride-16 writes and every later pass's
//    contiguous reads and writes hit 16 distinct bank pairs per half-warp.
//  * Twiddles.  Pass p >= 1 (radix R, Ns = 16^p) multiplies input r of
//    butterfly j by w^r, w = exp(2 pi i (j mod Ns) / (Ns R)): one
//    coalesced, L1-resident load of w from a table built in float64 and
//    stored as complex64 (search/build_cuda._twiddle_table), then the
//    powers by repeated products in registers (a few float32 roundings).
//  * Occupancy before operand reuse.  At n = 8192 a CTA is 256 threads of
//    32 values (128 registers), two CTAs an SM (2 x 68 KB of exchange):
//    two rows in flight hide each other's barriers.  Holding the row's
//    Kc_z in registers as well would take another 64 registers a thread
//    and so the second CTA; S and the bank stay in L2 instead.  Below
//    n = 8192 (G = 1, 16 values a thread) there are registers to spare,
//    and a CTA holds Kc_z across NB = 4 r-blocks: L2 reads fall from
//    3n/2 to n/2 + n/NB complex values a row.  S_b[k] and S_b[k + n/2]
//    are one load.  Global loads are 8 bytes a thread, consecutive
//    threads on consecutive addresses (256 bytes a warp).
//  * Epilogue.  |.|^2 of the good window [off, off + uselen) is written
//    straight from registers: consecutive threads hold consecutive
//    outputs, so each warp store covers one 128-byte line.  Pad rows and
//    pad blocks are zero-filled in the same launch (16-byte stores when
//    uselen is a multiple of 4).
//  * Registers.  0 bytes of spill in every instantiation (chip_smoke.py
//    reads nvcc -Xptxas -v).  n = 16384 runs one CTA an SM (136 KB of
//    exchange) of 256 threads holding 64 values each.

#include <cuda_runtime.h>

namespace {

template <int L>
struct Geo {
  static constexpr int N = 1 << L;
  static constexpr int P = (L + 3) / 4;            // passes
  static constexpr int RLAST = (L % 4) ? (1 << (L % 4)) : 16;
  // FUSE: a thread holds RLAST groups, and the last radix runs across
  // them in registers after the last radix-16 pass (one exchange fewer)
  static constexpr bool FUSE = L >= 13;
  static constexpr int G = FUSE ? RLAST : 1;       // groups a thread
  static constexpr int T = N / (16 * G);           // threads a CTA
  static constexpr int NB = G == 1 ? 4 : 1;        // blocks a CTA
  static constexpr int MINB = L == 13 ? 2 : 1;     // CTAs an SM
  static constexpr int SMEM = (N + N / 16) * 8;    // padded exchange
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// exp(+2 pi i m / 16); m is a compile-time constant after unrolling
__device__ __forceinline__ float2 w16(int m) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  const float c2 = 0.70710678118654752f;
  switch (m & 15) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, s1);
    case 2: return make_float2(c2, c2);
    case 3: return make_float2(s1, c1);
    case 4: return make_float2(0.f, 1.f);
    case 6: return make_float2(-c2, c2);
    case 9: return make_float2(-c1, -s1);
    default: return make_float2(0.f, 0.f);  // not reached (m in 0..9)
  }
}

// Inverse-sign DFTs in registers, natural order in and out.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = mul_i(csub(a1, a3));
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = cadd(d02, d13);
  a3 = csub(d02, d13);
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft4(e[0], e[1], e[2], e[3]);
    dft4(o[0], o[1], o[2], o[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = cmul(o[k], w16(2 * k));
      v[k] = cadd(e[k], t);
      v[k + 4] = csub(e[k], t);
    }
  } else {
    static_assert(R == 16, "radix");
    // x[4 n2 + n1]: DFT-4 over n2, twiddle w16^(n1 k1), DFT-4 over n1
#pragma unroll
    for (int n1 = 0; n1 < 4; ++n1)
      dft4(v[n1], v[4 + n1], v[8 + n1], v[12 + n1]);
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
#pragma unroll
      for (int n1 = 1; n1 < 4; ++n1)
        v[4 * k1 + n1] = cmul(v[4 * k1 + n1], w16(n1 * k1));
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1)
      dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
    // X[k1 + 4 k2] sits at v[4 k1 + k2]: transpose back
    float2 t[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = v[4 * (k & 3) + (k >> 2)];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = t[k];
  }
}

template <int R>
__device__ __forceinline__ void twiddle(float2* v, float2 w) {
  float2 wr = w;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    v[r] = cmul(v[r], wr);
    if (r + 1 < R) wr = cmul(wr, w);
  }
}

__host__ __device__ constexpr int table_off(int p) {  // sum 16^q, 1<=q<p
  return p <= 1 ? 0 : table_off(p - 1) + (1 << (4 * (p - 1)));
}

__device__ __forceinline__ void zero_window(float* out, int uselen, int tid,
                                            int nthreads) {
  if ((uselen & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int i = tid; i < (uselen >> 2); i += nthreads)
      o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < uselen; i += nthreads) out[i] = 0.f;
  }
}

// Pass 0: the product straight from global memory, radix 16, Ns = 1.
// kc holds the row's Kc_z when the CTA reuses it (NB > 1); else it is
// read here.
template <int L>
__device__ __forceinline__ void first_pass(const float2* __restrict__ s,
                                           const float2* __restrict__ k,
                                           const float2 (&kc)[Geo<L>::G][16],
                                           float2* buf, int tid) {
  using g = Geo<L>;
  constexpr int Q = g::N / 16;
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi) {
    const int j = tid + g::T * gi;
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 a = __ldg(s + j + r * Q);     // S[k] = S[k + n/2]
      if constexpr (g::NB > 1) {
        v[r] = cmul(a, kc[gi][r]);
        v[r + 8] = cmul(a, kc[gi][r + 8]);
      } else {
        v[r] = cmul(a, __ldg(k + j + r * Q));
        v[r + 8] = cmul(a, __ldg(k + j + (r + 8) * Q));
      }
    }
    dft<16>(v);
#pragma unroll
    for (int r = 0; r < 16; ++r) buf[pad(16 * j + r)] = v[r];
  }
}

// Passes 1 .. P-2: radix 16 from and to the exchange buffer.
template <int L, int p>
__device__ __forceinline__ void mid_pass(float2* buf,
                                         const float2* __restrict__ tw,
                                         int tid) {
  using g = Geo<L>;
  constexpr int Ns = 1 << (4 * p);
  constexpr int Q = g::N / 16;
  float2 v[g::G][16];
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi) {
    const int j = tid + g::T * gi;
#pragma unroll
    for (int r = 0; r < 16; ++r) v[gi][r] = buf[pad(j + r * Q)];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi) {
    const int j = tid + g::T * gi;
    const int jm = j & (Ns - 1);
    twiddle<16>(v[gi], __ldg(tw + table_off(p) + jm));
    dft<16>(v[gi]);
    const int base = (j - jm) * 16 + jm;
#pragma unroll
    for (int r = 0; r < 16; ++r) buf[pad(base + r * Ns)] = v[gi][r];
  }
  __syncthreads();
}

// Pass P-1: radix RLAST from the exchange buffer, |.|^2 of the window
// straight to the plane (butterfly j < Ns, so output m = j + s * Ns).
template <int L>
__device__ __forceinline__ void last_pass(const float2* buf,
                                          const float2* __restrict__ tw,
                                          float* __restrict__ out, int off,
                                          int uselen, int tid) {
  using g = Geo<L>;
  constexpr int R = g::RLAST;
  constexpr int PER = 16 / R;
  constexpr int Ns = 1 << (4 * (g::P - 1));
  constexpr float scale = 1.0f / (float)g::N;  // a power of two: exact
  float2 v[g::G][16];
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi)
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid + g::T * (gi * PER + q);
#pragma unroll
      for (int r = 0; r < R; ++r) v[gi][q * R + r] = buf[pad(j + r * Ns)];
    }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi)
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = tid + g::T * (gi * PER + q);
      float2* x = &v[gi][q * R];
      twiddle<R>(x, __ldg(tw + table_off(g::P - 1) + j));
      dft<R>(x);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int i = j + s * Ns - off;
        if ((unsigned)i < (unsigned)uselen) {
          const float re = x[s].x * scale, im = x[s].y * scale;
          out[i] = re * re + im * im;
        }
      }
    }
}

// Passes P-2 and P-1 when FUSE: the last radix-16 pass (Ns = T, so
// butterfly tid + T g holds outputs g N/G + tid + s Ns), then the last
// radix G across the thread's groups, |.|^2 of the window to the plane.
template <int L>
__device__ __forceinline__ void fused_last(const float2* buf,
                                           const float2* __restrict__ tw,
                                           float* __restrict__ out, int off,
                                           int uselen, int tid) {
  using g = Geo<L>;
  constexpr int p = g::P - 2;
  constexpr int Ns = 1 << (4 * p);
  static_assert(Ns == g::T && g::G == g::RLAST, "fused geometry");
  constexpr int Q = g::N / 16;
  constexpr float scale = 1.0f / (float)g::N;  // a power of two: exact
  float2 v[g::G][16];
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi)
#pragma unroll
    for (int r = 0; r < 16; ++r) v[gi][r] = buf[pad(tid + g::T * gi + r * Q)];
  __syncthreads();
  const float2 w = __ldg(tw + table_off(p) + tid);
#pragma unroll
  for (int gi = 0; gi < g::G; ++gi) {
    twiddle<16>(v[gi], w);
    dft<16>(v[gi]);
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int m = tid + s * Ns;
    float2 x[g::G];
#pragma unroll
    for (int gi = 0; gi < g::G; ++gi) x[gi] = v[gi][s];
    twiddle<g::G>(x, __ldg(tw + table_off(p + 1) + m));
    dft<g::G>(x);
#pragma unroll
    for (int gi = 0; gi < g::G; ++gi) {
      const int i = m + gi * (g::N / g::G) - off;
      if ((unsigned)i < (unsigned)uselen) {
        const float re = x[gi].x * scale, im = x[gi].y * scale;
        out[i] = re * re + im * im;
      }
    }
  }
}

template <int L>
__global__ void __launch_bounds__(Geo<L>::T, Geo<L>::MINB)
plane_build_kernel(const float2* __restrict__ S, const float2* __restrict__ Kc,
                   const float2* __restrict__ tw, float* __restrict__ plane,
                   int nblocks, int nb_pad, int numz, int uselen, int off) {
  using g = Geo<L>;
  extern __shared__ float2 buf[];
  const int tid = threadIdx.x;
  const int z = blockIdx.y;
  const int b0 = blockIdx.x * g::NB;
  float* row = plane + (size_t)z * nb_pad * uselen;
  if (z >= numz) {
    for (int b = b0; b < b0 + g::NB && b < nb_pad; ++b)
      zero_window(row + (size_t)b * uselen, uselen, tid, g::T);
    return;
  }
  const float2* k = Kc + (size_t)z * g::N;
  float2 kc[g::G][16];
  if constexpr (g::NB > 1) {
#pragma unroll
    for (int gi = 0; gi < g::G; ++gi)
#pragma unroll
      for (int r = 0; r < 16; ++r)
        kc[gi][r] = __ldg(k + tid + g::T * gi + r * (g::N / 16));
  }
#pragma unroll 1
  for (int b = b0; b < b0 + g::NB && b < nb_pad; ++b) {
    float* out = row + (size_t)b * uselen;
    if (b >= nblocks) {
      zero_window(out, uselen, tid, g::T);
      continue;
    }
    first_pass<L>(S + (size_t)b * (g::N / 2), k, kc, buf, tid);
    __syncthreads();
    if constexpr (g::P > 2 + g::FUSE) mid_pass<L, 1>(buf, tw, tid);
    if constexpr (g::P > 3 + g::FUSE) mid_pass<L, 2>(buf, tw, tid);
    if constexpr (g::FUSE)
      fused_last<L>(buf, tw, out, off, uselen, tid);
    else
      last_pass<L>(buf, tw, out, off, uselen, tid);
  }
}

template <int L>
int launch(const void* S, const void* Kc, const void* tw, void* plane,
           int nblocks, int nb_pad, int numz, int numz_pad, int uselen,
           int off, cudaStream_t stream) {
  using g = Geo<L>;
  cudaError_t e = cudaFuncSetAttribute(
      plane_build_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nb_pad + g::NB - 1) / g::NB, numz_pad);
  plane_build_kernel<L><<<grid, g::T, g::SMEM, stream>>>(
      (const float2*)S, (const float2*)Kc, (const float2*)tw, (float*)plane,
      nblocks, nb_pad, numz, uselen, off);
  return (int)cudaGetLastError();
}

}  // namespace

// tw: the per-pass twiddle bases, pass p >= 1 at table_off(p):
// exp(+2 pi i m / (16^p R_p)) for m < 16^p (search/build_cuda.py).
extern "C" int plane_build(const void* S, const void* Kc, const void* tw,
                           void* plane, int nblocks, int nb_pad, int numz,
                           int numz_pad, int log2n, int uselen, int off,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (log2n) {
    case 8: return launch<8>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                             numz_pad, uselen, off, st);
    case 9: return launch<9>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                             numz_pad, uselen, off, st);
    case 10: return launch<10>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                               numz_pad, uselen, off, st);
    case 11: return launch<11>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                               numz_pad, uselen, off, st);
    case 12: return launch<12>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                               numz_pad, uselen, off, st);
    case 13: return launch<13>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                               numz_pad, uselen, off, st);
    case 14: return launch<14>(S, Kc, tw, plane, nblocks, nb_pad, numz,
                               numz_pad, uselen, off, st);
    default: return (int)cudaErrorInvalidValue;  // no instantiation
  }
}
