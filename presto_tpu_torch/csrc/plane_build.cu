// F-Fdot plane build for the acceleration search (Hopper, sm_90a).
//
// Replaces the Pallas kernel make_plane_builder -> build of
// presto_tpu/search/build_pallas.py (factored DFT as MXU matmuls).
//
// What it computes: for z-row z and r-block b,
//     plane[z, b*uselen + i] = |IFFT_n(S_b[k mod n/2] * Kc_z[k])[off + i]|^2
// for i in [0, uselen), where S_b is the block's forward spectrum (the FFT
// of the x2-spread block equals the length-n/2 FFT tiled twice), Kc_z the
// conjugated FFT'd z-response kernel, and the inverse FFT carries 1/n.
// Rows z >= numz and blocks b >= nblocks are written as zeros.
//
// What bounds it on this card: device memory.  It must write the plane
// once (numz_pad * nb_pad * uselen * 4 bytes, 3.5 GB at zmax=200 over 2^21
// bins) and reads S and the kernel bank, which stay in the 50 MB L2.  The
// FFT itself is ~5 n log2 n flops per row, far below the float32 rate.
//
// Design: one thread block per (block, z-row); the whole length-n complex
// row lives in dynamic shared memory (64 KB at n = 8192), loaded in
// bit-reversed order straight from the product, then log2(n) radix-2
// stages with a float64-accurate twiddle table, then |.|^2 of the good
// window only, written coalesced into plane layout.  Blocks of one z-row
// run next to each other, so the row's kernel spectrum is read from L2.
// Nothing of the TPU version's matmul factorisation is kept: the FFT does
// ~25x fewer operations than the factored DFT.

#include <cuda_runtime.h>

__global__ void __launch_bounds__(512)
plane_build_kernel(const float2* __restrict__ S, const float2* __restrict__ Kc,
                   const float2* __restrict__ tw, float* __restrict__ plane,
                   int nblocks, int nb_pad, int numz, int log2n, int uselen,
                   int off) {
  extern __shared__ float2 buf[];
  const int n = 1 << log2n;
  const int half_n = n >> 1;
  const int b = blockIdx.x;
  const int z = blockIdx.y;
  float* out = plane + ((size_t)z * nb_pad + b) * (size_t)uselen;
  if (b >= nblocks || z >= numz) {
    for (int i = threadIdx.x; i < uselen; i += blockDim.x) out[i] = 0.0f;
    return;
  }
  const float2* s = S + (size_t)b * half_n;
  const float2* k = Kc + (size_t)z * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 a = s[i & (half_n - 1)];
    const float2 c = k[i];
    buf[__brev((unsigned)i) >> (32 - log2n)] =
        make_float2(a.x * c.x - a.y * c.y, a.x * c.y + a.y * c.x);
  }
  __syncthreads();
  for (int st = 1; st <= log2n; ++st) {
    const int half = 1 << (st - 1);
    const int tstride = n >> st;
    for (int t = threadIdx.x; t < half_n; t += blockDim.x) {
      const int j = t & (half - 1);
      const int i0 = ((t >> (st - 1)) << st) + j;
      const int i1 = i0 + half;
      const float2 w = tw[j * tstride];
      const float2 u = buf[i0];
      const float2 v = buf[i1];
      const float2 vw = make_float2(v.x * w.x - v.y * w.y,
                                    v.x * w.y + v.y * w.x);
      buf[i0] = make_float2(u.x + vw.x, u.y + vw.y);
      buf[i1] = make_float2(u.x - vw.x, u.y - vw.y);
    }
    __syncthreads();
  }
  const float scale = 1.0f / (float)n;  // a power of two: exact
  for (int i = threadIdx.x; i < uselen; i += blockDim.x) {
    const float2 c = buf[off + i];
    const float re = c.x * scale;
    const float im = c.y * scale;
    out[i] = re * re + im * im;
  }
}

extern "C" int plane_build(const void* S, const void* Kc, const void* tw,
                           void* plane, int nblocks, int nb_pad, int numz,
                           int numz_pad, int log2n, int uselen, int off,
                           void* stream) {
  const int smem = (int)(sizeof(float2) << log2n);
  cudaError_t e = cudaFuncSetAttribute(
      plane_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nb_pad, numz_pad);
  plane_build_kernel<<<grid, 512, smem, (cudaStream_t)stream>>>(
      (const float2*)S, (const float2*)Kc, (const float2*)tw, (float*)plane,
      nblocks, nb_pad, numz, log2n, uselen, off);
  return (int)cudaGetLastError();
}
