// RMSNorm over the rows of an (M, N) buffer:
//
//   y[i, j] = x[i, j] * rsqrt(mean_j(x[i, j]^2) + eps) * gain[j]
//
// Replaces the TPU kernel rmsnorm_2d of src/repro/kernels/rmsnorm/rmsnorm.py
// (the _rmsnorm_kernel Pallas body over (block_rows, N) row blocks).
//
// Bound on an H100: memory.  Each row is read once and written once
// (2*M*N elements) plus the N float32 gains; a multiply-add per element
// for the statistics and two multiplies for the scale are nothing next
// to that.  On the serving path the rows are (8192, 1600) bfloat16 and
// (8192, 3200) float32 in prefill, (4, 1600) in decode.
//
// Design: one block a row.  The threads stride over the row and sum x*x
// in float32, then a warp-shuffle reduction and one across the warps in
// shared memory give the sum; thread 0 forms inv = rsqrt(sum / N + eps)
// and a second strided pass writes (x * inv) * gain, rounded to x's type
// on store -- the order of the TPU kernel (x * inv * gain).  N is 1600,
// 3200 or 64 on the path, no power of two: the strided loops stop at N
// and nothing is padded, since padding would change the mean.  The
// second pass re-reads the row, which an L2 of 50 MB holds for a row of
// at most a few KB, so HBM sees it once.  The sum is taken in another
// order than torch's mean and rsqrtf is within 2 ulp, so the kernel
// agrees with the plain version (kernels/rmsnorm/ref.py) to a few float32
// ulp, one bfloat16 ulp after rounding, not bit for bit.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

constexpr int kNormThreads = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(T* __restrict__ y, const T* __restrict__ x,
               const float* __restrict__ gain, int64_t n, float eps) {
  __shared__ float partial[kNormThreads / 32];
  __shared__ float inv_shared;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  float ss = 0.0f;
  for (int64_t j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = load(x, base + j);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < (blockDim.x >> 5) ? partial[threadIdx.x] : 0.0f;
    v = warp_sum(v);
    if (threadIdx.x == 0) {
      const float ms = __fdiv_rn(v, static_cast<float>(n));
      inv_shared = rsqrtf(__fadd_rn(ms, eps));
    }
  }
  __syncthreads();
  const float inv = inv_shared;
  for (int64_t j = threadIdx.x; j < n; j += blockDim.x) {
    store(y, base + j, __fmul_rn(__fmul_rn(load(x, base + j), inv), gain[j]));
  }
}

template <typename T>
int launch(void* y, const void* x, const void* gain, int64_t m, int64_t n,
           float eps, cudaStream_t st) {
  // a warp for every 32 columns up to kNormThreads, at least one warp
  int64_t threads = (n + 31) / 32 * 32;
  if (threads > kNormThreads) threads = kNormThreads;
  rmsnorm_kernel<T><<<static_cast<unsigned>(m), static_cast<unsigned>(threads),
                      0, st>>>(static_cast<T*>(y), static_cast<const T*>(x),
                               static_cast<const float*>(gain), n, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (M, N) float32 (bf16 = 0) or bfloat16 (bf16 = 1); gain: (N,)
// float32; eps_bits: eps's float32 bits.  M < 2**31 rows (one block a
// row).  Returns cudaGetLastError().
int rmsnorm_2d(void* y, const void* x, const void* gain, int64_t m, int64_t n,
               int64_t eps_bits, int64_t bf16, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float eps = repro::f32_from_bits(eps_bits);
  return bf16 ? launch<__nv_bfloat16>(y, x, gain, m, n, eps, st)
              : launch<float>(y, x, gain, m, n, eps, st);
}

}  // extern "C"
