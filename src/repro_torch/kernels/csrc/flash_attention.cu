// Causal, sliding-window, grouped-query attention with an online softmax:
//
//   o[bh, i] = sum_j softmax_j(mask(q[bh, i] . k[g, j] * scale)) v[g, j],
//   g = bh / group, qpos = q_offset + i, kpos = j,
//   mask: kpos < T, kpos <= qpos (causal), kpos > qpos - window (window)
//
// Replaces the TPU kernel flash_attention_3d of
// src/repro/kernels/flash_attention/flash_attention.py (the _flash_kernel
// Pallas body over a (BHq, q_blocks, kv_blocks) grid, m/l/acc in VMEM
// scratch carried across the kv steps).
//
// Bound on an H100: operations.  On the serving path (hymba-1.5b prefill:
// q (100, 2048, 64), k/v (20, 2048, 64) bfloat16, window 1024, group 5)
// the live (q, k) pairs need 4*D flops each, ~40 GFLOP a layer, against
// 63 MB of q, k, v and output; at 989 TFLOP/s of bfloat16 tensor cores
// that is ~0.04 ms, above the bytes' ~0.019 ms.  This first kernel runs
// on the CUDA cores in float32 (67 TFLOP/s peak), so it sits well above
// the bound: tensor cores (wgmma) and TMA are later work.
//
// Design: one block of kBQ = 128 threads per (bh, 128-query tile), one
// query row a thread: the row's q (widened to float32, then scaled -- the
// TPU kernel's order), its acc and its m and l live in registers.  The
// block walks the kv tiles of kBK = 32 keys in order and skips the dead
// ones with the TPU kernel's tile test (a tile is live when k_lo < T,
// k_lo <= q_hi if causal, k_hi > q_lo - window with a window); a tile is
// staged in shared memory as float32 (K and V, 2*32*D floats), every
// thread reading the same key at once (a broadcast); the tile's scores
// go to a shared (32, 128) array, a column a thread, so the loops over a
// tile's keys need not be unrolled to keep them in registers (a fully
// unrolled tile took minutes to compile).  GQA maps by index:
// the kv head is bh / group, no expanded K/V.  Masked scores take the
// TPU kernel's finite sentinel -1e30, not -inf: a row whose keys in a
// live tile are all masked gets p = 1 there, and its first unmasked tile
// erases that with corr = exp(-1e30 - m) = 0 (with -inf the same row
// would give exp(-inf + inf) = NaN).  l is floored at 1e-30 before the
// divide, as in the TPU kernel.  The sums run in another order than the
// plain version's (kernels/flash_attention/ref.py: one float32 softmax
// over all keys), so the two agree to float32 rounding, not bit for bit.
#include <cuda_bf16.h>

#include "launch.cuh"

namespace {

constexpr int kBQ = 128;     // query rows a block, one a thread
constexpr int kBK = 32;      // keys a kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_kernel(T* __restrict__ o, const T* __restrict__ q,
             const T* __restrict__ k, const T* __restrict__ v, int64_t s,
             int64_t t, int64_t group, float scale, int causal, int64_t window,
             int64_t q_offset) {
  __shared__ float ks[kBK][D];
  __shared__ float vs[kBK][D];
  __shared__ float sc[kBK][kBQ];   // the tile's scores, a column a thread
  const int64_t bh = blockIdx.x;
  const int64_t kvh = bh / group;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int64_t row = row0 + threadIdx.x;
  const bool active = row < s;
  const int64_t q_lo = q_offset + row0;
  const int64_t q_hi = q_lo + kBQ - 1;
  const int64_t qpos = q_offset + row;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? __fmul_rn(load(q, (bh * s + row) * D + d), scale) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  for (int64_t k_lo = 0; k_lo < t; k_lo += kBK) {
    // the TPU kernel's tile liveness; uniform over the block
    if (causal && k_lo > q_hi) break;          // every later tile is dead too
    if (window >= 0 && !(k_lo + kBK - 1 > q_lo - window)) continue;
    __syncthreads();                           // the last tile is consumed
    for (int e = threadIdx.x; e < kBK * D; e += kBQ) {
      const int jr = e / D, dd = e - jr * D;
      const int64_t kk = k_lo + jr;
      const bool in = kk < t;
      ks[jr][dd] = in ? load(k, (kvh * t + kk) * D + dd) : 0.0f;
      vs[jr][dd] = in ? load(v, (kvh * t + kk) * D + dd) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    float m_cur = kNegInf;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float a = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], ks[j][d], a);
      const int64_t kpos = k_lo + j;
      bool ok = kpos < t;
      if (causal) ok = ok && kpos <= qpos;
      if (window >= 0) ok = ok && kpos > qpos - window;
      const float sj = ok ? a : kNegInf;
      sc[j][threadIdx.x] = sj;
      m_cur = fmaxf(m_cur, sj);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    float psum = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(sc[j][threadIdx.x] - m_new);
      psum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = corr * l + psum;
    m = m_new;
  }
  if (!active) return;
  const float l_floor = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) store(o, (bh * s + row) * D + d, acc[d] / l_floor);
}

template <typename T, int D>
int launch(void* o, const void* q, const void* k, const void* v, int64_t bhq,
           int64_t s, int64_t t, int64_t group, float scale, int causal,
           int64_t window, int64_t q_offset, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(bhq),
                  static_cast<unsigned>((s + kBQ - 1) / kBQ));
  flash_kernel<T, D><<<grid, kBQ, 0, st>>>(
      static_cast<T*>(o), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), s, t, group, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(void* o, const void* q, const void* k, const void* v, int64_t bhq,
             int64_t s, int64_t t, int64_t group, int64_t d, float scale,
             int causal, int64_t window, int64_t q_offset, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 64: return launch<T, 64>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 80: return launch<T, 80>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 96: return launch<T, 96>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 128: return launch<T, 128>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o, q: (BHq, S, D); k, v: (BHkv, T, D), BHq = group * BHkv; all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); D in {16, 64, 80, 96, 128};
// scale_bits: the scale's float32 bits; window < 0 for none.  BHq < 2**31
// and S < 2**16 * 128.  Returns cudaGetLastError().
int flash_attention_3d(void* o, const void* q, const void* k, const void* v,
                       int64_t bhq, int64_t s, int64_t t, int64_t group,
                       int64_t d, int64_t scale_bits, int64_t causal,
                       int64_t window, int64_t q_offset, int64_t bf16,
                       void* stream) {
  if (bhq == 0 || s == 0 || t == 0) return 0;
  if (bhq > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = repro::f32_from_bits(scale_bits);
  const int c = causal ? 1 : 0;
  return bf16 ? launch_d<__nv_bfloat16>(o, q, k, v, bhq, s, t, group, d, scale,
                                        c, window, q_offset, st)
              : launch_d<float>(o, q, k, v, bhq, s, t, group, d, scale, c,
                                window, q_offset, st);
}

}  // extern "C"
