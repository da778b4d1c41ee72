// Tiled matrix product C = X @ Y with a float32 accumulator:
// X (M, K), Y (K, N), each float32 or bfloat16; C float32 or bfloat16.
//
// Replaces the TPU kernel matmul_2d of src/repro/kernels/matmul/matmul.py
// (the _matmul_kernel Pallas body: (128, 128) output tiles, a 512-deep K
// panel, an fp32 VMEM scratch carried along the sequential K grid axis).
//
// Bound on an H100: operations at large sizes, bytes at small K or N.  A
// 1024^3 product is 2.1 GFLOP: 0.0022 ms at the tensor cores' 989 TFLOP/s
// (bfloat16) and 0.032 ms at the 67 TFLOP/s of float32 FMAs; the rotate
// shape (2^20, 2) @ (2, 2) moves 16.8 MB and is bound by bytes (0.005 ms).
// This kernel runs on the CUDA cores with a separate multiply and add, so
// its own ceiling is half the float32 FMA rate: it will lose to
// torch.matmul by a wide factor, and wgmma, TMA and the tensor cores are
// the redesign that follows once every kernel is ported.
//
// Float contract: every output accumulates, from 0.0f, the products over k
// in ascending order, acc = __fadd_rn(acc, __fmul_rn(x_ik, y_kj)), never
// contracted into an FMA, then one rounding to the output type
// (__float2bfloat16_rn for bfloat16).  The plain version
// (kernels/matmul/ref.py, matmul) runs the same rounded ops in the same
// order, so the two agree bit for bit.  bfloat16 inputs widen to float
// exactly and their products are exact in float32.
//
// Design: a block of 16 x 16 threads owns a 64 x 64 output tile, each
// thread a 4 x 4 patch in registers.  K advances in 16-deep panels staged
// in shared memory (A transposed, padded against bank conflicts; inputs
// widened to float on load).  The last panel stops at K, so a short
// contraction (K = 2 for rotate) does K steps and not 16.  Elements past
// M or N load as 0 and their outputs are not stored.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kTileThreads = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kTileThreads)
matmul_2d_kernel(O* __restrict__ c, const T* __restrict__ a,
                 const T* __restrict__ b, int64_t m, int64_t k, int64_t n) {
  __shared__ float as[BK][BM + 4];     // A panel, transposed: as[kk][row]
  __shared__ float bs[BK][BN];         // B panel: bs[kk][col]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / kTileThreads; ++r) {
      const int e = tid + r * kTileThreads;
      const int ar = e / BK, ak = e % BK;
      const int64_t gr = row0 + ar, gk = k0 + ak;
      as[ak][ar] = (gr < m && gk < k) ? widen(a[gr * k + gk]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / kTileThreads; ++r) {
      const int e = tid + r * kTileThreads;
      const int bk = e / BN, bc = e % BN;
      const int64_t gk = k0 + bk, gc = col0 + bc;
      bs[bk][bc] = (gk < k && gc < n) ? widen(b[gk * n + gc]) : 0.0f;
    }
    __syncthreads();
    auto step = [&](int kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
    };
    if (k0 + BK <= k) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {                           // the last, partial panel
      const int kn = static_cast<int>(k - k0);
      for (int kk = 0; kk < kn; ++kk) step(kk);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx * TN + j;
      if (gc < n) store(c + gr * n + gc, acc[i][j]);
    }
  }
}

template <typename T, typename O>
int launch(void* c, const void* a, const void* b, int64_t m, int64_t k,
           int64_t n, cudaStream_t st) {
  // x walks the row tiles (up to 2^31 - 1 of them: the tall, narrow
  // rotate shape), y the column tiles
  const int64_t gx = (m + BM - 1) / BM, gy = (n + BN - 1) / BN;
  if (gx > 0x7fffffff || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  matmul_2d_kernel<T, O><<<grid, kTileThreads, 0, st>>>(
      static_cast<O*>(c), static_cast<const T*>(a), static_cast<const T*>(b),
      m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c: (M, N); a: (M, K); b: (K, N).  in_bf16 / out_bf16: 0 for float32,
// 1 for bfloat16.  Returns cudaGetLastError().
int matmul_2d(void* c, const void* a, const void* b, int64_t m, int64_t k,
              int64_t n, int64_t in_bf16, int64_t out_bf16, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(c, a, b, m, k, n, st)
                    : launch<__nv_bfloat16, float>(c, a, b, m, k, n, st);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(c, a, b, m, k, n, st)
                  : launch<float, float>(c, a, b, m, k, n, st);
}

}  // extern "C"
