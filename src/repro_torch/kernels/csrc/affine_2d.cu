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
// wastes 97 % of each block; here the buffer is flat.
//   * vecadd_2d: where x, z and y lie at 16-byte-aligned bases,
//     vecadd_vec_kernel walks the buffer as 16-byte vectors (uint4: 4
//     float32 or 8 bfloat16 values) in chunks of kUnroll * kVecThreads
//     vectors (8 KB of x and of z), one chunk a block at a time in a
//     grid-stride loop over a grid sized to the blocks the card holds at
//     once (one wave).  Inside a chunk neighbouring threads take
//     neighbouring vectors, and a thread loads its kUnroll vectors of x
//     and z before it adds any.  On an H100, chunks that keep a block on
//     contiguous memory beat kUnroll vectors strided across the whole
//     buffer by 1-2 % at hymba's (8192, 1600), and 128-thread blocks
//     beat 256-thread ones by ~4 % at 1024 x 1024 float32, whose 256
//     chunks of 256 threads spread unevenly over 132 SMs.  The last
//     total % width elements go to vecadd_2d_kernel in a second launch
//     (a scalar tail inside the vector kernel cost it 6 % in float32).
//     Other bases take vecadd_2d_kernel alone, one element a thread per
//     int64 grid-stride step.
//   * affine_2d: one element a thread per int64 grid-stride step, the
//     column j mod N.  Vectorised 16-byte accesses are later work here.
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

// A 16-byte vector of x plus one of z, element by element: __fadd_rn in
// float32, a bfloat16 sum rounded once with __float2bfloat16_rn (a
// bfloat16 widens to float32 exactly as its bits in the upper half).
__device__ __forceinline__ uint4 add_vec(const uint4& a, const uint4& b,
                                         float) {
  return make_uint4(
      __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
}
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b) {
  const float lo =
      __fadd_rn(__uint_as_float(a << 16), __uint_as_float(b << 16));
  const float hi = __fadd_rn(__uint_as_float(a & 0xffff0000u),
                             __uint_as_float(b & 0xffff0000u));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
__device__ __forceinline__ uint4 add_vec(const uint4& a, const uint4& b,
                                         __nv_bfloat16) {
  return make_uint4(add_pair(a.x, b.x), add_pair(a.y, b.y),
                    add_pair(a.z, b.z), add_pair(a.w, b.w));
}

constexpr int kUnroll = 4;
constexpr int kVecThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kVecThreads)
vecadd_vec_kernel(T* __restrict__ y, const T* __restrict__ x,
                  const T* __restrict__ z, int64_t nvec) {
  constexpr int64_t kChunk = static_cast<int64_t>(kUnroll) * kVecThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* zv = reinterpret_cast<const uint4*>(z);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t c = blockIdx.x * kChunk + threadIdx.x; c < nvec;
       c += gridDim.x * kChunk) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = c + u * kVecThreads;
      if (v < nvec) {
        a[u] = xv[v];
        b[u] = zv[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = c + u * kVecThreads;
      if (v < nvec) yv[v] = add_vec(a[u], b[u], T());
    }
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

// The blocks of vecadd_vec_kernel<T> that the card holds at once (its
// SMs times the blocks an SM takes at the kernel's registers), asked
// once: a grid of that size runs in one wave.
template <typename T>
int64_t resident_blocks() {
  static int64_t blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vecadd_vec_kernel<T>,
                                                  kVecThreads, 0);
    blocks = static_cast<int64_t>(sms > 0 ? sms : 1) *
             (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T>
int launch_vecadd(void* y, const void* x, const void* z, int64_t total,
                  cudaStream_t st) {
  constexpr int64_t kW = 16 / sizeof(T);
  int64_t done = 0;   // elements the vector kernel takes
  if (((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(x) |
        reinterpret_cast<uintptr_t>(z)) % 16) == 0 && total >= kW) {
    const int64_t nvec = total / kW;
    int64_t grid = (nvec + kVecThreads * kUnroll - 1) / (kVecThreads * kUnroll);
    const int64_t cap = resident_blocks<T>();
    if (grid > cap) grid = cap;
    vecadd_vec_kernel<T><<<static_cast<unsigned>(grid), kVecThreads, 0, st>>>(
        static_cast<T*>(y), static_cast<const T*>(x), static_cast<const T*>(z),
        nvec);
    done = nvec * kW;
  }
  if (done < total) {   // a base off 16 bytes, or the last total % kW
    const unsigned grid = repro::blocks_for(total - done, repro::kMaxBlocksX);
    vecadd_2d_kernel<T><<<grid, repro::kThreads, 0, st>>>(
        static_cast<T*>(y) + done, static_cast<const T*>(x) + done,
        static_cast<const T*>(z) + done, total - done);
  }
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

// x, z, y: (M, N), total = M*N; bf16 as above.  16-byte-aligned x, z and
// y take the vector kernel (and the scalar one for the last total % 16
// bytes), others the scalar one.  Returns cudaGetLastError().
int vecadd_2d(void* y, const void* x, const void* z, int64_t total,
              int64_t bf16, void* stream) {
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_vecadd<__nv_bfloat16>(y, x, z, total, st)
              : launch_vecadd<float>(y, x, z, total, st);
}

}  // extern "C"
