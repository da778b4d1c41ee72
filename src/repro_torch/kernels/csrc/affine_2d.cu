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
//   * affine_2d: three regimes, chosen by the C entry from N, the type's
//     width W (4 float32 or 8 bfloat16 values a 16-byte vector) and the
//     16-byte alignment of the bases, as launch_vecadd chooses:
//       - W % N == 0 (N = 1, 2, 4; 8 in bfloat16), x and y aligned:
//         affine_flat_kernel.  Every vector holds W / N whole rows, so its
//         column pattern is fixed: each thread tiles s and t into one
//         16-byte register pattern each, once, and walks the flat buffer
//         in vecadd_vec_kernel's chunked one-wave layout.  The last
//         total % W elements (which start on column 0, since the vectors
//         end on a row's end) go to affine_2d_kernel in a second launch.
//         The point clouds' (N, 2) translate and scale take this regime.
//       - N % W == 0 otherwise, all four bases aligned:
//         affine_col_kernel.  A thread owns one column vector: it loads
//         s and t for it once as one 16-byte vector each and walks its
//         rows, kUnroll rows loaded before any is stored; neighbouring
//         threads take neighbouring vectors of one row (a block's 128
//         threads cover min(N / W, 128) column vectors of 128 / that many
//         rows at once).  The grid is column tiles x row chunks, sized to
//         one wave.  No modulo at all.  Every transformer width and
//         kernel_bench's (1024, 1024) take this regime.
//       - everything else (N = 3, N = 100, bases off 16 bytes):
//         affine_2d_kernel, one element a thread per int64 grid-stride
//         step.  Its column is j mod N taken once a thread, then stepped
//         by the stride mod N with one compare and subtract a step: a
//         64-bit division per element is a software routine of tens of
//         instructions, as costly as the pass at these sizes.
//     bfloat16 values are unpacked from 32-bit pairs as add_pair does (a
//     bfloat16 widens to float32 exactly as its bits in the upper half).
//     On an H100 (80GB HBM3, 700 W) the one-element-a-thread kernel took
//     0.0112 ms at (1024, 1024) float32, 0.0098 in bfloat16 and 0.0145
//     at (2**20, 2) float32, 1.04-1.10x torch.addcmul; the column and
//     flat kernels take 0.0093, 0.0082 and 0.0118, 0.86-0.93x addcmul
//     (chip_smoke.py's rows).
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
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  int64_t c = j % n;                  // the column, once a thread
  const int64_t step = stride % n;    // then stepped: c < n, step < n
  for (; j < total; j += stride) {
    // the product rounded to T before the add, the sum rounded on store
    const float prod = mul_rn(load(x, j), load(s, c), T());
    store(y, j, __fadd_rn(prod, load(t, c)));
    c += step;
    if (c >= n) c -= n;
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

// y = x * s + t on a 16-byte vector of x against 16-byte patterns of s
// and t, element by element: float32 __fadd_rn(__fmul_rn(x, s), t); in
// bfloat16 the product rounded to bfloat16 and widened, t added, the sum
// rounded (mul_rn and store above).
__device__ __forceinline__ uint32_t affine_word(uint32_t x, uint32_t s,
                                                uint32_t t, float) {
  return __float_as_uint(__fadd_rn(
      __fmul_rn(__uint_as_float(x), __uint_as_float(s)), __uint_as_float(t)));
}
__device__ __forceinline__ float affine_bf16(float x, float s, float t) {
  const float prod = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, s)));
  return __fadd_rn(prod, t);
}
__device__ __forceinline__ uint32_t affine_word(uint32_t x, uint32_t s,
                                                uint32_t t, __nv_bfloat16) {
  const float lo = affine_bf16(__uint_as_float(x << 16),
                               __uint_as_float(s << 16),
                               __uint_as_float(t << 16));
  const float hi = affine_bf16(__uint_as_float(x & 0xffff0000u),
                               __uint_as_float(s & 0xffff0000u),
                               __uint_as_float(t & 0xffff0000u));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
template <typename T>
__device__ __forceinline__ uint4 affine_vec(const uint4& x, const uint4& s,
                                            const uint4& t) {
  return make_uint4(affine_word(x.x, s.x, t.x, T()),
                    affine_word(x.y, s.y, t.y, T()),
                    affine_word(x.z, s.z, t.z, T()),
                    affine_word(x.w, s.w, t.w, T()));
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

// The 16-byte pattern of a parameter row p of n values (n divides the
// vector's width W): element k of the vector is column k mod n.
__device__ __forceinline__ uint4 tile_row(const float* p, int n) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  return make_uint4(w[0], w[1 & (n - 1)], w[2 & (n - 1)], w[3 & (n - 1)]);
}
__device__ __forceinline__ uint4 tile_row(const __nv_bfloat16* p, int n) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = static_cast<uint32_t>(h[(2 * k) & (n - 1)]) |
           (static_cast<uint32_t>(h[(2 * k + 1) & (n - 1)]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x, y: the flat (M*N,) buffer as nvec 16-byte vectors, N a power of two
// that divides the width W, so every vector has s's and t's pattern.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
affine_flat_kernel(T* __restrict__ y, const T* __restrict__ x,
                   const T* __restrict__ s, const T* __restrict__ t,
                   int64_t nvec, int n) {
  constexpr int64_t kChunk = static_cast<int64_t>(kUnroll) * kVecThreads;
  const uint4 sp = tile_row(s, n), tp = tile_row(t, n);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int64_t c = blockIdx.x * kChunk + threadIdx.x; c < nvec;
       c += gridDim.x * kChunk) {
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = c + u * kVecThreads;
      if (v < nvec) a[u] = xv[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = c + u * kVecThreads;
      if (v < nvec) yv[v] = affine_vec<T>(a[u], sp, tp);
    }
  }
}

// x, y: (M, nvc) 16-byte vectors, s, t: (nvc,) vectors.  A block's
// threads cover tile_c column vectors of kVecThreads / tile_c rows.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
affine_col_kernel(T* __restrict__ y, const T* __restrict__ x,
                  const T* __restrict__ s, const T* __restrict__ t,
                  int64_t m, int64_t nvc, int tile_c) {
  const int rows = kVecThreads / tile_c;     // rows a block takes at once
  const int r_in = static_cast<int>(threadIdx.x) / tile_c;
  const int64_t cv = static_cast<int64_t>(blockIdx.x) * tile_c +
                     (static_cast<int>(threadIdx.x) - r_in * tile_c);
  if (r_in >= rows || cv >= nvc) return;
  const uint4 sv = reinterpret_cast<const uint4*>(s)[cv];
  const uint4 tv = reinterpret_cast<const uint4*>(t)[cv];
  const uint4* xv = reinterpret_cast<const uint4*>(x) + cv;
  uint4* yv = reinterpret_cast<uint4*>(y) + cv;
  const int64_t chunk = static_cast<int64_t>(kUnroll) * rows;
  for (int64_t r0 = blockIdx.y * chunk + r_in; r0 < m;
       r0 += gridDim.y * chunk) {
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * rows;
      if (r < m) a[u] = xv[r * nvc];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * rows;
      if (r < m) yv[r * nvc] = affine_vec<T>(a[u], sv, tv);
    }
  }
}

template <typename T>
void launch_affine_scalar(T* y, const T* x, const T* s, const T* t,
                          int64_t total, int64_t n, cudaStream_t st) {
  const unsigned grid = repro::blocks_for(total, repro::kMaxBlocksX);
  affine_2d_kernel<T><<<grid, repro::kThreads, 0, st>>>(y, x, s, t, total, n);
}

template <typename T>
int launch_affine(void* yp, const void* xp, const void* sp, const void* tp,
                  int64_t m, int64_t n, cudaStream_t st) {
  constexpr int64_t kW = 16 / sizeof(T);
  auto* y = static_cast<T*>(yp);
  const auto* x = static_cast<const T*>(xp);
  const auto* s = static_cast<const T*>(sp);
  const auto* t = static_cast<const T*>(tp);
  const int64_t total = m * n;
  const bool xy = repro::aligned16(y, x);
  if (xy && kW % n == 0 && total >= kW) {
    static const int64_t resident =
        repro::resident_blocks(affine_flat_kernel<T>, kVecThreads);
    const int64_t nvec = total / kW;
    int64_t grid = (nvec + kVecThreads * kUnroll - 1) / (kVecThreads * kUnroll);
    if (grid > resident) grid = resident;
    affine_flat_kernel<T><<<static_cast<unsigned>(grid), kVecThreads, 0, st>>>(
        y, x, s, t, nvec, static_cast<int>(n));
    const int64_t done = nvec * kW;   // a multiple of n: the tail's column 0
    if (done < total) {
      launch_affine_scalar<T>(y + done, x + done, s, t, total - done, n, st);
    }
  } else if (xy && n % kW == 0 && repro::aligned16(s, t)) {
    static const int64_t resident =
        repro::resident_blocks(affine_col_kernel<T>, kVecThreads);
    const int64_t nvc = n / kW;
    const int tile_c = static_cast<int>(nvc < kVecThreads ? nvc : kVecThreads);
    const int64_t chunk = static_cast<int64_t>(kUnroll) * (kVecThreads / tile_c);
    const int64_t gx = (nvc + tile_c - 1) / tile_c;
    int64_t gy = (m + chunk - 1) / chunk;
    const int64_t cap = resident / gx > 1 ? resident / gx : 1;
    if (gy > cap) gy = cap;
    if (gy > 65535) gy = 65535;
    affine_col_kernel<T><<<dim3(static_cast<unsigned>(gx),
                                static_cast<unsigned>(gy)),
                           kVecThreads, 0, st>>>(y, x, s, t, m, nvc, tile_c);
  } else {
    launch_affine_scalar<T>(y, x, s, t, total, n, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vecadd(void* y, const void* x, const void* z, int64_t total,
                  cudaStream_t st) {
  constexpr int64_t kW = 16 / sizeof(T);
  int64_t done = 0;   // elements the vector kernel takes
  if (repro::aligned16(y, x, z) && total >= kW) {
    const int64_t nvec = total / kW;
    int64_t grid = (nvec + kVecThreads * kUnroll - 1) / (kVecThreads * kUnroll);
    static const int64_t cap =
        repro::resident_blocks(vecadd_vec_kernel<T>, kVecThreads);
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

// x, y: (M, N); s, t: (N,); bf16 = 0 for float32, 1 for bfloat16.  The
// regime (flat vectors, column vectors or scalar) follows from N and the
// bases' alignment, as the header says.  Returns cudaGetLastError().
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
