// The Mamba-2 SSD intra-chunk core, per (chunk c, head h):
//
//   G[i, j]  = C[i] . B[j]                                      (lc, lc)
//   att[i,j] = G[i, j] * exp(cum[i] - cum[j])  for j <= i, else 0
//   y[i]     = sum_j att[i, j] * xdt[j]                         (lc, p)
//   S_c      = sum_j (xdt[j] * exp(cum[lc-1] - cum[j]))^T B[j]  (p, n)
//
// with xdt (BC, lc, h, p), B, C (BC, lc, n), cum (BC, lc, h) float32, and
// y (BC, lc, h, p), S_c (BC, h, p, n) float32 out.
//
// Replaces the TPU kernel ssd_intra of src/repro/kernels/ssd/ssd.py (the
// _ssd_intra_kernel Pallas body over a (BC, h) grid, the whole (lc, lc)
// att resident in VMEM).
//
// Bound on an H100: memory.  On the serving path (hymba-1.5b prefill:
// BC = 32 chunks of lc = 256, h = 50 heads of p = 64, n = 16) the inputs
// and the float32 outputs are 166 MB, ~0.05 ms at 3.35 TB/s; the work,
// lc*(lc+1)/2*(2n + 2p + 2) + 2*lc*p*n flops a (chunk, head), 9.4 GFLOP
// a layer, would take ~0.01 ms on the bfloat16 tensor cores but ~0.14 ms
// on the float32 CUDA cores this first kernel uses.
//
// Design: the TPU kernel keeps the (lc x lc) att in VMEM; at lc = 256 in
// float32 that is 256 KB, above the 227 KB of shared memory a Hopper block
// can have.  Here att is never stored: one block of 256 threads per
// (chunk, head), one query row i a thread, with C[i] and the row's y
// accumulator in registers.  The block walks the chunk's rows j in tiles
// of kTJ = 32, staging B[j] and xdt[j] of the tile (and exp(cum_last -
// cum[j])) in shared memory; each thread forms G[i, j] = C[i] . B[j] on the
// fly (all threads read the same B[j], a broadcast), masks the exponent
// BEFORE exp (for j > i, cum[i] - cum[j] is positive and can overflow; it
// becomes -inf and exp gives 0), and adds att * xdt[j] to its row.  S_c
// needs every row j of the chunk, so in the same walk each thread also
// accumulates its (P*N)/256 elements of S_c from the staged tile.  B and C
// are shared by the h heads of a chunk and are re-read from device memory
// (L2) by each head's block: the first thing to fix later.  The sums run
// in another order than the plain version's einsums
// (kernels/ssd/ref.py), so the two agree to float32 rounding.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

constexpr int kRows = 256;   // rows a block: the largest chunk, one a thread
constexpr int kTJ = 32;      // rows j a staged tile

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kRows)
ssd_intra_kernel(float* __restrict__ y, float* __restrict__ s_out,
                 const T* __restrict__ xdt, const T* __restrict__ b,
                 const T* __restrict__ c, const float* __restrict__ cum,
                 int64_t lc, int64_t h) {
  constexpr int kS = (P * N + kRows - 1) / kRows;   // S_c elements a thread
  __shared__ float cums[kRows];
  __shared__ float bs[kTJ][N];
  __shared__ float xs[kTJ][P];
  __shared__ float sdec[kTJ];
  const int64_t chunk = blockIdx.x;
  const int64_t hh = blockIdx.y;
  const int i = threadIdx.x;
  const bool row = i < lc;

  for (int j = i; j < lc; j += kRows) cums[j] = cum[(chunk * lc + j) * h + hh];
  __syncthreads();
  const float cum_i = row ? cums[i] : 0.0f;
  const float cum_last = cums[lc - 1];
  float ci[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    ci[n] = row ? load(c, (chunk * lc + i) * N + n) : 0.0f;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
  float sacc[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) sacc[k] = 0.0f;

  for (int64_t j0 = 0; j0 < lc; j0 += kTJ) {
    const int jend = static_cast<int>(lc - j0 < kTJ ? lc - j0 : kTJ);
    __syncthreads();                               // the last tile is consumed
    for (int e = i; e < kTJ * N; e += kRows) {
      const int jr = e / N, nn = e - jr * N;
      bs[jr][nn] = jr < jend ? load(b, (chunk * lc + j0 + jr) * N + nn) : 0.0f;
    }
    for (int e = i; e < kTJ * P; e += kRows) {
      const int jr = e / P, pp = e - jr * P;
      xs[jr][pp] = jr < jend
          ? load(xdt, ((chunk * lc + j0 + jr) * h + hh) * P + pp) : 0.0f;
    }
    if (i < kTJ) sdec[i] = i < jend ? expf(cum_last - cums[j0 + i]) : 0.0f;
    __syncthreads();

    // y: rows i >= j0 meet this tile; j > i is masked before exp
    if (row && j0 <= i) {
      for (int jr = 0; jr < jend; ++jr) {
        float g = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) g = fmaf(ci[n], bs[jr][n], g);
        const int64_t j = j0 + jr;
        const float e = j <= i ? cum_i - cums[j] : -INFINITY;
        const float att = g * expf(e);
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(att, xs[jr][p], acc[p]);
      }
    }
    // S_c: this thread's elements (p, n) over the tile's rows
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int idx = i + k * kRows;
      if (idx < P * N) {
        const int p = idx / N, n = idx - p * N;
        for (int jr = 0; jr < jend; ++jr)
          sacc[k] = fmaf(xs[jr][p] * sdec[jr], bs[jr][n], sacc[k]);
      }
    }
  }
  if (row) {
#pragma unroll
    for (int p = 0; p < P; ++p) y[((chunk * lc + i) * h + hh) * P + p] = acc[p];
  }
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int idx = i + k * kRows;
    if (idx < P * N) s_out[(chunk * h + hh) * P * N + idx] = sacc[k];
  }
}

template <typename T, int P, int N>
int launch(void* y, void* s_c, const void* xdt, const void* b, const void* c,
           const void* cum, int64_t bc, int64_t lc, int64_t h,
           cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(bc), static_cast<unsigned>(h));
  ssd_intra_kernel<T, P, N><<<grid, kRows, 0, st>>>(
      static_cast<float*>(y), static_cast<float*>(s_c),
      static_cast<const T*>(xdt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(cum), lc, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pn(void* y, void* s_c, const void* xdt, const void* b,
              const void* c, const void* cum, int64_t bc, int64_t lc,
              int64_t h, int64_t p, int64_t n, cudaStream_t st) {
  if (p == 16 && n == 16) return launch<T, 16, 16>(y, s_c, xdt, b, c, cum, bc, lc, h, st);
  if (p == 64 && n == 16) return launch<T, 64, 16>(y, s_c, xdt, b, c, cum, bc, lc, h, st);
  if (p == 64 && n == 128) return launch<T, 64, 128>(y, s_c, xdt, b, c, cum, bc, lc, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y: (BC, lc, h, p) and s_c: (BC, h, p, n) float32 out; xdt: (BC, lc, h, p),
// b, c: (BC, lc, n) all float32 (bf16 = 0) or all bfloat16 (bf16 = 1);
// cum: (BC, lc, h) float32.  lc <= 256; (p, n) is (16, 16), (64, 16) or
// (64, 128); h < 65536.  Returns cudaGetLastError().
int ssd_intra(void* y, void* s_c, const void* xdt, const void* b,
              const void* c, const void* cum, int64_t bc, int64_t lc,
              int64_t h, int64_t p, int64_t n, int64_t bf16, void* stream) {
  if (bc == 0 || lc == 0 || h == 0) return 0;
  if (lc > kRows || h > 65535 || bc > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pn<__nv_bfloat16>(y, s_c, xdt, b, c, cum, bc, lc, h, p,
                                         n, st)
              : launch_pn<float>(y, s_c, xdt, b, c, cum, bc, lc, h, p, n, st);
}

}  // extern "C"
