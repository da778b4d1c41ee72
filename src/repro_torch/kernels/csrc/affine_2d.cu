// The paper's eager vector primitives on an (M, N) buffer:
//
//   affine_2d:  y[i, j] = x[i, j] * s[j] + t[j]   (translate, scale, affine)
//   vecadd_2d:  y[i, j] = x[i, j] + z[i, j]       (Table 1's vector add)
//
// Replaces the TPU kernels affine_2d and vecadd_2d of
// src/repro/kernels/affine/affine.py (the _affine_kernel and
// _vecadd_kernel Pallas bodies, over (bm, bn) blocks padded to 8 x 128).
//
// Bound on an H100: memory.  affine_2d reads x once and writes y once
// (2*M*N words) plus the 2*N row parameters; vecadd_2d reads two buffers
// and writes one (3*M*N words); over 3.35 TB/s of HBM.  One or two float
// operations per element are nothing next to that.
//
// Float contract:
//   * float32: y = __fadd_rn(__fmul_rn(x, s), t) -- a rounded multiply,
//     then a rounded add, never contracted into an FMA (nvcc's --fmad
//     cannot touch the _rn intrinsics); vecadd is one __fadd_rn.
//   * bfloat16: each op is formed in float and rounded to bfloat16 after
//     it (__float2bfloat16_rn after the multiply and again after the add),
//     which is what eager torch does for bfloat16 tensors.
// The plain versions (kernels/affine/ref.py) run the same rounded ops, so
// kernel and plain version agree bit for bit, signed zeros included
// (scale is x*s + 0, so x*s = -0.0 is stored as +0.0).
//
// Design: the TPU pads N up to 128 lanes, so N = 2 or 3 (a point cloud)
// wastes 97 % of each block; here the buffer is flat, one element a
// thread per int64 grid-stride step, and the column is j mod N.
// Vectorised 16-byte loads are later work.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float mul_rn(float a, float b, float) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void affine_2d_kernel(T* __restrict__ y, const T* __restrict__ x,
                                 const T* __restrict__ s,
                                 const T* __restrict__ t, int64_t total,
                                 int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < total; j += stride) {
    const int64_t c = j % n;
    // the product rounded to T before the add, the sum rounded on store
    const float prod = mul_rn(load(x, j), load(s, c), T());
    store(y, j, __fadd_rn(prod, load(t, c)));
  }
}

template <typename T>
__global__ void vecadd_2d_kernel(T* __restrict__ y, const T* __restrict__ x,
                                 const T* __restrict__ z, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < total; j += stride) {
    store(y, j, __fadd_rn(load(x, j), load(z, j)));
  }
}

template <typename T>
int launch_affine(void* y, const void* x, const void* s, const void* t,
                  int64_t m, int64_t n, cudaStream_t st) {
  const int64_t total = m * n;
  const unsigned grid = repro::blocks_for(total, repro::kMaxBlocksX);
  affine_2d_kernel<T><<<grid, repro::kThreads, 0, st>>>(
      static_cast<T*>(y), static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(t), total, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vecadd(void* y, const void* x, const void* z, int64_t total,
                  cudaStream_t st) {
  const unsigned grid = repro::blocks_for(total, repro::kMaxBlocksX);
  vecadd_2d_kernel<T><<<grid, repro::kThreads, 0, st>>>(
      static_cast<T*>(y), static_cast<const T*>(x), static_cast<const T*>(z),
      total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (M, N); s, t: (N,); bf16 = 0 for float32, 1 for bfloat16.
// Returns cudaGetLastError().
int affine_2d(void* y, const void* x, const void* s, const void* t,
              int64_t m, int64_t n, int64_t bf16, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_affine<__nv_bfloat16>(y, x, s, t, m, n, st)
              : launch_affine<float>(y, x, s, t, m, n, st);
}

// x, z, y: (M, N), total = M*N; bf16 as above.  Returns cudaGetLastError().
int vecadd_2d(void* y, const void* x, const void* z, int64_t total,
              int64_t bf16, void* stream) {
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_vecadd<__nv_bfloat16>(y, x, z, total, st)
              : launch_vecadd<float>(y, x, z, total, st);
}

}  // extern "C"
