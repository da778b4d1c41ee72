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
// Rounding: every op rounds as eager torch does: float32 through
// __fmul_rn/__fadd_rn/__fsub_rn (never contracted into an FMA), bfloat16
// formed in float and rounded to bfloat16 after each op
// (__float2bfloat16_rn), so both kernels equal their plain version
// (kernels/rope/ref.py) bit for bit.
//
// Design: two kernels, chosen in the C entry.
//   * rope_vec_kernel takes a launch whose half row (D/2 values) is a
//     multiple of 16 bytes -- every RoPE head width of the configs, 64,
//     80, 96 and 128, in bfloat16 and float32 -- on 16-byte-aligned x, y,
//     cos and sin.  A thread holds one 16-byte vector of a half row (8
//     pairs in bfloat16, 4 in float32): threadIdx.x walks the vectors of
//     the half (hv = D/2 / its width, at most 128), threadIdx.y the
//     positions of a tile, threadIdx.z and blockIdx.y the heads (striding
//     past the grid's 65535), blockIdx.x the position tiles.  A prefill
//     tile fills its 128-thread block (one head a block); a decode launch
//     (S = 1) takes 128 / hv heads a block, so its grid is no larger than
//     the work (4 blocks for 100 heads of D = 64 in bfloat16).  The thread
//     loads its position's cos and sin vectors into registers, then reads
//     x1 and x2 and writes y1 and y2 of its head as 16-byte vectors.  No
//     thread divides: its position, vector and head come from the grid;
//     offsets inside a head are 32-bit (the C entry sends heads of 2**31
//     elements and more to the scalar kernel), 64-bit arithmetic is the
//     head's base alone.  A warp's loads of x1 (or x2) are 32 / hv runs of
//     hv contiguous vectors, and the two halves of a row fill each other's
//     sectors; the tables are read again for each head, from L2.  On an
//     H100 80GB HBM3 (700 W) at the prefill q shape this grid of one head
//     a block ran at 1.02-1.03x a device copy of the same bytes; groups of
//     heads a block with the tables loaded once a group, 2 or 4 heads a
//     step, on a one-wave or a 4-wave grid, took 1.03-1.11x (PERF.md).
//   * rope_kernel, one thread per (row, pair) in an int64 grid-stride
//     loop with 2-byte (bfloat16) accesses, takes every other launch: a
//     half row of no multiple of 16 bytes (D = 20 in bfloat16, D = 2) or
//     a base off 16 bytes.  It ran every launch before the 16-byte
//     kernel: on an H100 80GB HBM3 (700 W) 0.03805 ms at the prefill q
//     shape, 1.39 TB/s (PERF.md).
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

// (y1, y2) of one pair, rounded as eager torch rounds (before the store)
template <typename T>
__device__ __forceinline__ void rotate(float x1, float x2, float c, float sn,
                                       float& y1, float& y2) {
  y1 = __fsub_rn(rnd(__fmul_rn(x1, c), T()), rnd(__fmul_rn(x2, sn), T()));
  y2 = __fadd_rn(rnd(__fmul_rn(x2, c), T()), rnd(__fmul_rn(x1, sn), T()));
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
    float y1, y2;
    rotate<T>(load(x, o), load(x, o + half), load(cos_t, t), load(sin_t, t),
              y1, y2);
    store(y, o, y1);
    store(y, o + half, y2);
  }
}

// A 16-byte vector as float values (exact), and back with one rounding
// to T each.
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

constexpr int kRopeThreads = 128;
constexpr int64_t kMaxHeadBlocks = 65535;   // the grid's y limit

// x, y: (bh, s_len, 2 half), cos, sin: (s_len, half), all 16-byte aligned;
// half a multiple of Vec<T>::kN, blockDim = (half / kN, positions a tile,
// heads a block), s_len * 2 half < 2**31; thread z of block row blockIdx.y
// takes heads blockIdx.y * blockDim.z + threadIdx.z, + gridDim.y *
// blockDim.z, ...
template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope_vec_kernel(T* __restrict__ y, const T* __restrict__ x,
                const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                int64_t bh, int s_len, int half) {
  constexpr int kN = Vec<T>::kN;
  const int pos = blockIdx.x * blockDim.y + threadIdx.y;
  if (pos >= s_len) return;
  const int col = threadIdx.x * kN;            // in the half row
  const int64_t head = static_cast<int64_t>(s_len) * 2 * half;
  const int off = pos * 2 * half + col;        // in the head
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.z;
  int64_t h = static_cast<int64_t>(blockIdx.y) * blockDim.z + threadIdx.z;
  if (h >= bh) return;
  // the first head's x1 and x2 are asked for before the tables arrive, so
  // a thread of one head (any launch of at most 65535 block rows) waits on
  // memory once
  const T* xh = x + h * head + off;
  uint4 a = *reinterpret_cast<const uint4*>(xh);
  uint4 b = *reinterpret_cast<const uint4*>(xh + half);
  float c[kN], sn[kN];
  Vec<T>::unpack(*reinterpret_cast<const uint4*>(cos_t + pos * half + col), c);
  Vec<T>::unpack(*reinterpret_cast<const uint4*>(sin_t + pos * half + col), sn);
  for (;;) {
    float x1[kN], x2[kN], y1[kN], y2[kN];
    Vec<T>::unpack(a, x1);
    Vec<T>::unpack(b, x2);
#pragma unroll
    for (int k = 0; k < kN; ++k)
      rotate<T>(x1[k], x2[k], c[k], sn[k], y1[k], y2[k]);
    T* yh = y + h * head + off;
    *reinterpret_cast<uint4*>(yh) = Vec<T>::pack(y1);
    *reinterpret_cast<uint4*>(yh + half) = Vec<T>::pack(y2);
    h += step;
    if (h >= bh) break;
    xh = x + h * head + off;
    a = *reinterpret_cast<const uint4*>(xh);
    b = *reinterpret_cast<const uint4*>(xh + half);
  }
}

template <typename T>
void launch_vec(T* y, const T* x, const T* c, const T* sn, int64_t bh,
                int64_t s, int64_t half, cudaStream_t st) {
  const int64_t hv = half / Vec<T>::kN;
  const int64_t py = kRopeThreads / hv < s ? kRopeThreads / hv : s;
  const int64_t gx = (s + py - 1) / py;
  // heads a block: 1 where a tile fills the block, more for short
  // sequences (a decode step: 32 heads of 4 vectors at D = 64 bfloat16)
  int64_t hz = kRopeThreads / (hv * py);
  if (hz > 64) hz = 64;                          // the block's z limit
  if (hz > bh) hz = bh;
  int64_t gy = (bh + hz - 1) / hz;
  if (gy > kMaxHeadBlocks) gy = kMaxHeadBlocks;
  rope_vec_kernel<T><<<dim3(static_cast<unsigned>(gx),
                            static_cast<unsigned>(gy)),
                       dim3(static_cast<unsigned>(hv),
                            static_cast<unsigned>(py),
                            static_cast<unsigned>(hz)), 0, st>>>(
      y, x, c, sn, bh, static_cast<int>(s), static_cast<int>(half));
}

template <typename T>
void launch(void* y, const void* x, const void* c, const void* sn,
            int64_t rows, int64_t s, int64_t half, cudaStream_t st) {
  auto* yo = static_cast<T*>(y);
  auto* xi = static_cast<const T*>(x);
  auto* ci = static_cast<const T*>(c);
  auto* si = static_cast<const T*>(sn);
  if ((half * static_cast<int64_t>(sizeof(T))) % 16 == 0
      && half / Vec<T>::kN <= kRopeThreads
      && s * 2 * half < (int64_t{1} << 31)
      && repro::aligned16(yo, xi, ci, si)) {
    launch_vec<T>(yo, xi, ci, si, rows / s, s, half, st);
    return;
  }
  rope_kernel<T><<<repro::blocks_for(rows * half, repro::kMaxBlocksX),
                   repro::kThreads, 0, st>>>(yo, xi, ci, si, rows, s, half);
}

}  // namespace

extern "C" {

// x, y: (BH, S, 2*half), rows = BH*S; cos, sin: (S, half), all of one
// type: float32 (bf16 = 0) or bfloat16 (bf16 = 1).  A half row of a
// multiple of 16 bytes (at most 128 vectors, heads under 2**31 elements)
// on 16-byte-aligned x, y, cos and sin takes the 16-byte kernel, any
// other launch the scalar one.  Returns cudaGetLastError().
int rope_3d(void* y, const void* x, const void* c, const void* sn, int64_t rows,
            int64_t s, int64_t half, int64_t bf16, void* stream) {
  if (rows == 0 || half == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(y, x, c, sn, rows, s, half, st);
  } else {
    launch<float>(y, x, c, sn, rows, s, half, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
