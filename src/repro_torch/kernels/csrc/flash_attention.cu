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
// that is ~0.04 ms, above the bytes' ~0.019 ms.
//
// Shared by both kernels below: a block owns 128 query rows of one q head
// bh and reads kv head bh / group by index (no expanded K/V); it walks
// the kv tiles in order and skips the dead ones with the TPU kernel's tile
// test (a tile is live when k_lo < T, k_lo <= q_hi if causal, k_hi > q_lo
// - window with a window).  Masked scores take the TPU kernel's finite
// sentinel -1e30, not -inf: a row whose keys in a live tile are all masked
// gets p = 1 there, and its first unmasked tile erases that with corr =
// exp(-1e30 - m) = 0 (with -inf the same row would give exp(-inf + inf) =
// NaN).  l is floored at 1e-30 before the divide, as in the TPU kernel.
// The sums run in another order than the plain version's
// (kernels/flash_attention/ref.py: one float32 softmax over all keys), so
// the two agree to a bound (tests/torch_bounds.py, flash_bound), not bit
// for bit.
//
// bfloat16: the wgmma kernel (namespace wg).  Two consumer warpgroups of
// 64 query rows and one producer warp.  The producer loads the block's Q
// once and the live K and V tiles (BK = 128 keys for D <= 64, 64 above)
// through a 2-stage shared-memory ring, all by TMA from 3-D tensor maps
// (D, S, BHq) and (D, T, BHkv), so a ragged last tile reads TMA's zeros and
// never the next head's rows; a row of D values is staged as 64-wide
// panels in the 128-byte swizzle, the last one zero-filled past D (80, 96).
// Each warpgroup computes S = Q K^T with wgmma m64 nBK k16 (Q and K both
// K-major, D / 16 steps: the zero-filled depth is never multiplied),
// scales the fp32 scores, masks them and runs the online softmax on the
// accumulator fragments in registers (a row's max across the 4 threads
// that hold it by shuffles; the row sums stay per thread until the end),
// rounds P to bfloat16 in registers -- the accumulator fragment of 16 keys
// is the A fragment of a k16 step -- and accumulates O += P V with wgmma
// m64 nDN k16, P from registers and V an N-major operand (the transpose
// bit), DN = D rounded up to 64 (V's zero columns give zero outputs that
// are not stored).  O stays fp32 in registers; the epilogue divides by l,
// rounds to bfloat16 and stores the rows < S.  The scale multiplies the
// fp32 scores (exact where it is a power of two: D = 16, 64), and P is
// rounded to bfloat16 while l sums the fp32 p: the TPU kernel's own float32
// dots run at default precision, bfloat16 operands on its matrix unit.
//
// float32: the CUDA-core kernel (namespace simt).  One block of kBQ = 128
// threads per (bh, 128-query tile), one query row a thread: the row's q
// (widened to float32, then scaled -- the TPU kernel's order), its acc and
// its m and l live in registers.  Kv tiles of kBK = 32 keys are staged in
// shared memory, every thread reading the same key at once (a broadcast);
// the tile's scores go to a shared (32, 128) array, a column a thread, so
// the loops over a tile's keys need not be unrolled to keep them in
// registers (a fully unrolled tile took minutes to compile).
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

constexpr float kNegInf = -1e30f;

namespace simt {

constexpr int kBQ = 128;     // query rows a block, one a thread
constexpr int kBK = 32;      // keys a kv tile

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }

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

}  // namespace simt

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                            // query rows a block
constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;    // + the producer warp
constexpr int kPanel = 128;                        // bytes a swizzled row

template <int D>
struct Cfg {
  static constexpr int NP = (D + 63) / 64;         // 64-wide panels a row
  static constexpr int BK = D <= 64 ? 128 : 64;    // keys a kv tile
  static constexpr int DN = 64 * NP;               // the P V width
  static constexpr int Q_BYTES = NP * BQ * kPanel;
  static constexpr int KV_BYTES = NP * BK * kPanel;   // K or V of a tile
  static constexpr int SMEM = Q_BYTES + 2 * 2 * KV_BYTES + 1024;
};

// S (64 x N) = Q (64 x 16) . K^T (16 x N), both K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 128) {
    hopper::wgmma_ss_n128<0>(d, da, db, 1);
  } else {
    hopper::wgmma_ss_n64<0>(d, da, db, 1);
  }
}

// O (64 x N) += P (64 x 16, registers) . V (16 x N, N-major)
template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    hopper::wgmma_rs_n128<1>(d, a, db, 1);
  } else {
    hopper::wgmma_rs_n64<1>(d, a, db, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
             int64_t bhq, int64_t s, int64_t t, int64_t group, float scale,
             int causal, int64_t window, int64_t q_offset) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NP = C::NP, DN = C::DN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[2], empty[2];
  // Q (NP panels of (BQ, 64)), then per stage K and V (NP panels of
  // (BK, 64) each), 1024-byte aligned
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* qs = smem_raw + (base - raw);
  uint8_t* kvs = qs + C::Q_BYTES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the latest (heaviest under a causal mask) query tiles first
  const int64_t n_qt = (s + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x % bhq;
  const int64_t qt = n_qt - 1 - blockIdx.x / bhq;
  const int64_t kvh = bh / group;
  const int64_t q_lo = q_offset + qt * BQ, q_hi = q_lo + BQ - 1;
  // the live kv tiles j0 <= j < j1 (the TPU kernel's tile test)
  int64_t j1 = (t + BK - 1) / BK;
  if (causal && q_hi / BK + 1 < j1) j1 = q_hi / BK + 1;
  int64_t j0 = 0;
  if (window >= 0) {
    const int64_t lo = q_lo - window - BK + 1;   // live: j * BK > lo
    j0 = lo < 0 ? 0 : lo / BK + 1;
  }
  const int ntiles = j1 > j0 ? static_cast<int>(j1 - j0) : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int st = 0; st < 2; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {                  // the producer warp
    if (lane == 0) {
      hopper::mbar_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        hopper::tma_load_3d(qs + p * BQ * kPanel, &map_q, &q_full, 64 * p,
                            static_cast<int>(qt * BQ), static_cast<int>(bh));
      for (int i = 0; i < ntiles; ++i) {
        const int st = i & 1;
        if (i >= 2) hopper::mbar_wait(&empty[st], ((i >> 1) - 1) & 1);
        uint8_t* ks = kvs + st * 2 * C::KV_BYTES;
        uint8_t* vs = ks + C::KV_BYTES;
        const int k_lo = static_cast<int>((j0 + i) * BK);
        hopper::mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_3d(ks + p * BK * kPanel, &map_k, &full[st], 64 * p,
                              k_lo, static_cast<int>(kvh));
          hopper::tma_load_3d(vs + p * BK * kPanel, &map_v, &full[st], 64 * p,
                              k_lo, static_cast<int>(kvh));
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the block; this
  // thread holds rows `row` and `row + 8` of its warp's 16
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, tq = lane % 4;
  const int64_t row = qt * BQ + wg * 64 + wl * 16 + g;
  const int64_t qpos[2] = {q_offset + row, q_offset + row + 8};
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  hopper::mbar_wait(&q_full, 0);
  const uint32_t q_base = base + wg * 64 * kPanel;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    const int64_t k_lo = (j0 + i) * BK;
    const uint32_t k_base = base + C::Q_BYTES + st * 2 * C::KV_BYTES;
    const uint32_t v_base = k_base + C::KV_BYTES;
    hopper::mbar_wait(&full[st], (i >> 1) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // + 32 bytes a k16 step
      mma_qk<BK>(sc,
                 hopper::desc_b128(q_base + (kk / 4) * BQ * kPanel + off, 16,
                                   1024),
                 hopper::desc_b128(k_base + (kk / 4) * BK * kPanel + off, 16,
                                   1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale, mask (unless every pair of the block's tile is live), and the
    // running row max
    const bool all_live = k_lo + BK <= t && (!causal || k_lo + BK - 1 <= q_lo)
                          && (window < 0 || k_lo > q_hi - window);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int h = (j % 4) / 2;
      float v = sc[j] * scale;
      if (!all_live) {
        const int64_t kpos = k_lo + 8 * (j / 4) + 2 * tq + (j % 2);
        bool ok = kpos < t;
        if (causal) ok = ok && kpos <= qpos[h];
        if (window >= 0) ok = ok && kpos > qpos[h] - window;
        v = ok ? v : kNegInf;
      }
      sc[j] = v;
      mx[h] = fmaxf(mx[h], v);
    }
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
    }
    // p, its per-thread row sums, and P as bfloat16 A fragments
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 2; j += 2) {
      const int h = (j % 4) / 2;
      const float p0 = expf(sc[j] - m_run[h]);
      const float p1 = expf(sc[j + 1] - m_run[h]);
      psum[h] += p0;
      psum[h] += p1;
      pf[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = corr[h] * l_run[h] + psum[h];
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) acc[j] *= corr[(j % 4) / 2];

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // keys 16 kk .. 16 kk + 15; V's 64-wide panels BK rows apart
      mma_pv<DN>(acc, pf[kk],
                 hopper::desc_b128(v_base + kk * 16 * kPanel, BK * kPanel,
                                   1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[st]);
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[h] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DN / 2; j += 2) {
    const int h = (j % 4) / 2;
    const int64_t r = row + 8 * h;
    const int col = 8 * (j / 4) + 2 * tq;
    if (r < s && col < D) {
      *reinterpret_cast<__nv_bfloat162*>(o + (bh * s + r) * D + col) =
          __floats2bfloat162_rn(acc[j] / den[h], acc[j + 1] / den[h]);
    }
  }
}

template <int D>
int launch(void* o, const void* q, const void* k, const void* v, int64_t bhq,
           int64_t s, int64_t t, int64_t group, float scale, int causal,
           int64_t window, int64_t q_offset, cudaStream_t st) {
  using C = Cfg<D>;
  const int64_t blocks = (s + BQ - 1) / BQ * bhq;
  if (blocks > 0x7fffffffLL || s > 0x7fffffffLL || t > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuuint64_t row = D * 2;
  const cuuint64_t dims_q[3] = {D, static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(bhq)};
  const cuuint64_t strides_q[2] = {row, row * s};
  const cuuint64_t dims_kv[3] = {D, static_cast<cuuint64_t>(t),
                                 static_cast<cuuint64_t>(bhq / group)};
  const cuuint64_t strides_kv[2] = {row, row * t};
  const cuuint32_t box_q[3] = {64, BQ, 1}, box_kv[3] = {64, C::BK, 1};
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (!hopper::make_map(&map_q, q, 3, dims_q, strides_q, box_q)
      || !hopper::make_map(&map_k, k, 3, dims_kv, strides_kv, box_kv)
      || !hopper::make_map(&map_v, v, 3, dims_kv, strides_kv, box_kv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_kernel<D>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::SMEM, st>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), bhq, s, t, group, scale,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(void* o, const void* q, const void* k, const void* v,
             int64_t bhq, int64_t s, int64_t t, int64_t group, int64_t d,
             float scale, int causal, int64_t window, int64_t q_offset,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<16>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 64: return launch<64>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 80: return launch<80>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 96: return launch<96>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    case 128: return launch<128>(o, q, k, v, bhq, s, t, group, scale, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// o, q: (BHq, S, D); k, v: (BHkv, T, D), BHq = group * BHkv; all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1, each base 16-byte aligned for
// TMA); D in {16, 64, 80, 96, 128}; scale_bits: the scale's float32 bits;
// window < 0 for none.  float32: BHq < 2**31 and S < 2**16 * 128;
// bfloat16: BHq * ceil(S / 128) < 2**31.  Returns cudaGetLastError().
int flash_attention_3d(void* o, const void* q, const void* k, const void* v,
                       int64_t bhq, int64_t s, int64_t t, int64_t group,
                       int64_t d, int64_t scale_bits, int64_t causal,
                       int64_t window, int64_t q_offset, int64_t bf16,
                       void* stream) {
  if (bhq == 0 || s == 0 || t == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = repro::f32_from_bits(scale_bits);
  const int c = causal ? 1 : 0;
  if (bf16) {
    if (!hopper::aligned16(o) || !hopper::aligned16(q)
        || !hopper::aligned16(k) || !hopper::aligned16(v)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return wg::launch_d(o, q, k, v, bhq, s, t, group, d, scale, c, window,
                        q_offset, st);
  }
  if (bhq > 0x7fffffffLL || (s + simt::kBQ - 1) / simt::kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return simt::launch_d<float>(o, q, k, v, bhq, s, t, group, d, scale, c,
                               window, q_offset, st);
}

}  // extern "C"
