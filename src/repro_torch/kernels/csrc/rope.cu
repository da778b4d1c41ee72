// Rotary position embedding, half-split pairing, on a (BH, S, D) buffer:
//
//   y1 = x1 * cos - x2 * sin,   y2 = x2 * cos + x1 * sin
//
// with x1 = x[..., :D/2], x2 = x[..., D/2:] and cos/sin (S, D/2) at the
// row's sequence position.
//
// Replaces the TPU kernel rope_3d of src/repro/kernels/rope/rope.py (the
// _rope_kernel Pallas body over (1, bs, D) blocks with the tables staged
// per sequence block).
//
// Bound on an H100: memory.  x is read once and y written once (2*BH*S*D
// elements); the tables (2*S*D/2) are shared by the BH rows of a
// position and stay in L2.  Six float operations an output pair are
// nothing next to the bytes.  On the serving path q is (100, 2048, 64)
// and k (20, 2048, 64) bfloat16 in prefill, (100, 1, 64) in decode.
//
// Design: one thread per (row, pair) in an int64 grid-stride loop; each
// thread reads x1, x2, cos and sin once and writes y1 and y2.  Every op
// rounds as eager torch does: float32 through __fmul_rn/__fadd_rn/
// __fsub_rn (never contracted into an FMA), bfloat16 formed in float and
// rounded to bfloat16 after each op (__float2bfloat16_rn), so the kernel
// equals its plain version (kernels/rope/ref.py) bit for bit.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// one rounded op in T: float32 as it is, bfloat16 rounded after the op
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void rope_kernel(T* __restrict__ y, const T* __restrict__ x,
                            const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t, int64_t rows,
                            int64_t s, int64_t half) {
  const int64_t total = rows * half;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t r = idx / half;
    const int64_t i = idx - r * half;
    const int64_t t = (r % s) * half + i;
    const int64_t o = r * 2 * half + i;
    const float x1 = load(x, o), x2 = load(x, o + half);
    const float c = load(cos_t, t), sn = load(sin_t, t);
    const float y1 = __fsub_rn(rnd(__fmul_rn(x1, c), T()),
                               rnd(__fmul_rn(x2, sn), T()));
    const float y2 = __fadd_rn(rnd(__fmul_rn(x2, c), T()),
                               rnd(__fmul_rn(x1, sn), T()));
    store(y, o, y1);
    store(y, o + half, y2);
  }
}

template <typename T>
int launch(void* y, const void* x, const void* c, const void* sn, int64_t rows,
           int64_t s, int64_t half, cudaStream_t st) {
  const unsigned grid = repro::blocks_for(rows * half, repro::kMaxBlocksX);
  rope_kernel<T><<<grid, repro::kThreads, 0, st>>>(
      static_cast<T*>(y), static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(sn), rows, s, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (BH, S, 2*half), rows = BH*S; cos, sin: (S, half), all of one
// type: float32 (bf16 = 0) or bfloat16 (bf16 = 1).  Returns
// cudaGetLastError().
int rope_3d(void* y, const void* x, const void* c, const void* sn, int64_t rows,
            int64_t s, int64_t half, int64_t bf16, void* stream) {
  if (rows == 0 || half == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(y, x, c, sn, rows, s, half, st)
              : launch<float>(y, x, c, sn, rows, s, half, st);
}

}  // extern "C"
