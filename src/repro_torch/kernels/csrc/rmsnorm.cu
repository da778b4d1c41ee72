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
// Design: two kernels of one arithmetic, chosen by the C entry.
//
//   * rmsnorm_vec_kernel, for rows whose bytes are a multiple of 16 at
//     16-byte-aligned bases (every row on the serving path).  A group of
//     W warps takes a row; each lane loads its share as 16-byte vectors
//     (uint4: 8 bfloat16 or 4 float32 values; neighbouring lanes on
//     neighbouring vectors), at most kMaxVec of them, and holds them in
//     registers from the sum of squares to the scale: HBM sees each row
//     once.  The loops are unrolled to kMaxVec and guarded, so N = 1600
//     or 3200 (no power of two) is never padded.  W is the least power
//     of two whose lanes hold the row (W = 1 at 1600 bfloat16: 200
//     vectors, <= 7 a lane; W = 4 at 3200 float32), or, for fewer rows
//     than the card has SMs (decode), enough warps for one vector a
//     lane.  With W = 1 a block holds four rows and no barrier; with
//     W > 1 a block is one row and the warps' sums meet in shared memory
//     after one __syncthreads().  The gain comes as float4.
//   * rmsnorm_kernel, the scalar one: a block a row, strided 2- or 4-byte
//     loads and two passes over the row (the second served by L2), for
//     any width and any base (N = 33 or 100 in bytes no multiple of 16, a
//     view one element off alignment, rows of more than 8192 vectors).
//
// Arithmetic, in both: the lane sums x*x in float32 (fmaf, its vectors
// in order), a butterfly of warp shuffles adds the lanes, the warps'
// sums are added in order, inv = rsqrt(sum / N + eps), and y =
// (x * inv) * gain, rounded to x's type on store -- the order of the TPU
// kernel (x * inv * gain).  The sum is taken in another order than
// torch's mean and rsqrtf is within 2 ulp, so the kernels agree with
// the plain version (kernels/rmsnorm/ref.py) to a few float32 ulp, one
// bfloat16 ulp after rounding, not bit for bit
// (tests/torch_bounds.py::rmsnorm_bound; tests/test_torch_bounds.py
// emulates the vector kernel's order).
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

constexpr int kNormThreads = 256;
// 16-byte vectors a lane holds at most: W = 32 warps of 32 lanes hold a
// row of 8192 vectors (65536 bfloat16 or 32768 float32 values)
constexpr int kMaxVec = 8;
constexpr int kMaxWarps = 32;
// rows a block of the one-warp-a-row instance
constexpr int kRowsPerBlock = 4;

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

// A 16-byte vector as float32 values, and back with one rounding each.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // the low half is the lower address
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return static_cast<uint32_t>(
        __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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

// W warps a row; a block holds kRowsPerBlock rows when W = 1, else one.
template <int W>
constexpr int vec_threads() { return W == 1 ? 32 * kRowsPerBlock : 32 * W; }

template <typename T, int W>
__global__ void __launch_bounds__(vec_threads<W>())
rmsnorm_vec_kernel(T* __restrict__ y, const T* __restrict__ x,
                   const float* __restrict__ gain, int64_t m, int nv,
                   int64_t n, float eps) {
  constexpr int kV = Vec<T>::kN;
  constexpr int kGroup = 32 * W;   // lanes a row
  const int t = threadIdx.x % kGroup;
  const int64_t row = W == 1
      ? static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32
      : static_cast<int64_t>(blockIdx.x);
  if (W == 1 && row >= m) return;   // a whole warp; no barrier follows
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nv;
  uint4* yr = reinterpret_cast<uint4*>(y) + row * nv;

  uint4 buf[kMaxVec];
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int j = t + k * kGroup;
    if (j < nv) buf[k] = xr[j];
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    if (t + k * kGroup < nv) {
      float f[kV];
      Vec<T>::unpack(buf[k], f);
#pragma unroll
      for (int e = 0; e < kV; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  ss = warp_sum(ss);
  if (W > 1) {
    __shared__ float partial[W > 1 ? W : 1];
    if ((t & 31) == 0) partial[t >> 5] = ss;
    __syncthreads();
    ss = partial[0];
#pragma unroll
    for (int w = 1; w < W; ++w) ss += partial[w];
  }
  const float inv =
      rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(n)), eps));

  const float4* g4 = reinterpret_cast<const float4*>(gain);
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int j = t + k * kGroup;
    if (j < nv) {
      float f[kV];
      Vec<T>::unpack(buf[k], f);
#pragma unroll
      for (int q = 0; q < kV / 4; ++q) {
        const float4 g = __ldg(g4 + j * (kV / 4) + q);
        const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = f[4 * q + e];
          v = __fmul_rn(__fmul_rn(v, inv), gs[e]);
        }
      }
      yr[j] = Vec<T>::pack(f);
    }
  }
}

template <typename T, int W>
int launch_vec(void* y, const void* x, const void* gain, int64_t m, int nv,
               int64_t n, float eps, cudaStream_t st) {
  const int64_t rows = W == 1 ? kRowsPerBlock : 1;
  const int64_t grid = (m + rows - 1) / rows;
  rmsnorm_vec_kernel<T, W><<<static_cast<unsigned>(grid), vec_threads<W>(), 0,
                             st>>>(
      static_cast<T*>(y), static_cast<const T*>(x),
      static_cast<const float*>(gain), m, nv, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// The warps a row for nv vectors: the least power of two that holds the
// row at kMaxVec a lane; for fewer rows than SMs, enough for one vector
// a lane (capped at kMaxWarps).
inline int warps_for(int64_t m, int64_t nv) {
  int w = 1;
  while (static_cast<int64_t>(32) * w * kMaxVec < nv) w <<= 1;
  if (m < 132)
    while (w < kMaxWarps && static_cast<int64_t>(32) * w < nv) w <<= 1;
  return w;
}

// Whether the vector kernel takes `w` warps a row of nv vectors: a power
// of two up to kMaxWarps whose lanes hold the row at kMaxVec a lane.
inline bool warps_ok(int64_t w, int64_t nv) {
  return w >= 1 && w <= kMaxWarps && (w & (w - 1)) == 0 &&
         static_cast<int64_t>(32) * w * kMaxVec >= nv;
}

// row_warps: the knob (0 for warps_for's choice).  A knob the row cannot
// take, or one for a launch the vector kernel does not take, is refused.
// The warps a row decide which lane sums which vectors, so two counts
// may round a row's sum differently (within the bound, not bit for bit).
template <typename T>
int launch(void* y, const void* x, const void* gain, int64_t m, int64_t n,
           float eps, int64_t row_warps, cudaStream_t st) {
  constexpr int64_t kV = Vec<T>::kN;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(x) |
        reinterpret_cast<uintptr_t>(gain)) % 16 == 0) && n % kV == 0 &&
      n / kV <= static_cast<int64_t>(32) * kMaxWarps * kMaxVec;
  if (row_warps != 0 && !(aligned && warps_ok(row_warps, n / kV))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (aligned) {
    const int nv = static_cast<int>(n / kV);
    switch (row_warps != 0 ? static_cast<int>(row_warps) : warps_for(m, nv)) {
      case 1: return launch_vec<T, 1>(y, x, gain, m, nv, n, eps, st);
      case 2: return launch_vec<T, 2>(y, x, gain, m, nv, n, eps, st);
      case 4: return launch_vec<T, 4>(y, x, gain, m, nv, n, eps, st);
      case 8: return launch_vec<T, 8>(y, x, gain, m, nv, n, eps, st);
      case 16: return launch_vec<T, 16>(y, x, gain, m, nv, n, eps, st);
      default: return launch_vec<T, 32>(y, x, gain, m, nv, n, eps, st);
    }
  }
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
// float32; eps_bits: eps's float32 bits; row_warps: the vector kernel's
// warps a row, 0 for its own choice.  M < 2**31 rows.  Rows of a
// multiple of 16 bytes at 16-byte-aligned x, y and gain take the vector
// kernel, others the scalar one.  Returns cudaGetLastError().
int rmsnorm_2d(void* y, const void* x, const void* gain, int64_t m, int64_t n,
               int64_t eps_bits, int64_t bf16, int64_t row_warps,
               void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float eps = repro::f32_from_bits(eps_bits);
  return bf16 ? launch<__nv_bfloat16>(y, x, gain, m, n, eps, row_warps, st)
              : launch<float>(y, x, gain, m, n, eps, row_warps, st);
}

}  // extern "C"
