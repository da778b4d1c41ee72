// Matrix product C = X @ Y with a float32 accumulator:
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
//
// One C entry, three regimes, chosen by dtype and shape (each a kernel of
// its own, each launched and checked; none stands in for another):
//
//   1. skinny, K <= 8 and N <= 8, either dtype (the rotate primitive's
//      (2^20, 2) @ (2, 2)): a streaming kernel, up to eight rows a thread
//      (their loads issued before any product, so enough bytes are in
//      flight) and four blocks an SM, Y in registers in an instance sized by
//      max(K, N) <= 2, 4 or 8 (one sized for 8 took 90 registers and left
//      too few rows in flight), a row of X read as one 4-, 8- or 16-byte
//      vector where its width and alignment allow, and the row of C
//      written the same way.  Bound by bytes: at the rotate shape it runs
//      level with a device copy of the same bytes.
//   2. bfloat16 inputs otherwise: a wgmma GEMM.  A block of two consumer
//      warpgroups and one producer warp owns a 128 x BN output tile (BN =
//      128, or 64 when 128-wide tiles would leave SMs idle: 1024^3 gives
//      64 such tiles to 132 SMs, 128 of 128 x 64); the C entry's `bn`
//      knob picks 64 or 128 instead.  K advances in 64-deep panels (128
//      bytes of bfloat16) through a shared-memory ring of 4 stages (the
//      `stages` knob: 3, 4 or 6, each an instance of its own):
//      the producer warp fills a stage by TMA when X's and Y's rows are
//      16-byte multiples and their bases 16-byte aligned, else by per-thread
//      loads into the same 128-byte-swizzled layout (zeros past M, K, N);
//      a full barrier a stage says it has landed, an empty barrier that
//      both warpgroups are done with it.  Each warpgroup runs
//      wgmma.mma_async m64 nBN k16 on its 64 rows, X as the K-major A
//      operand and Y (K, N) row-major as an N-major B operand (the
//      transpose bit), keeps one panel's products in flight while it
//      waits for the next, and holds the fp32 accumulator in registers;
//      the epilogue rounds to the output type and stores with M/N masks.
//   3. float32 inputs otherwise: the CUDA-core tile kernel below, a 64 x 64
//      output tile a block of 16 x 16 threads, 16-deep K panels in shared
//      memory.  Its ceiling is half the float32 FMA rate: see the contract.
//
// Float contract.  Regimes 1 and 3 accumulate every output, from 0.0f,
// over k in ascending order, acc = __fadd_rn(acc, __fmul_rn(x_ik, y_kj)),
// never contracted into an FMA, then round once to the output type
// (__float2bfloat16_rn for bfloat16): the plain version
// (kernels/matmul/ref.py, matmul) runs the same rounded ops in the same
// order, so the two agree bit for bit.  Regime 2 sums on the tensor
// cores in their own order (within a k16 step and across steps), so it
// agrees with the plain version to a bound (tests/torch_bounds.py,
// matmul_bound: 2 K eps32 sum_k |x_ik y_kj|, plus one bfloat16 ulp for a
// bfloat16 output), not bit for bit.  bfloat16 inputs widen to float
// exactly and their products are exact in float32.
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// -- 1. skinny: K <= 8, N <= 8 -------------------------------------------------

constexpr int kSkinny = 8;
// rows a thread per step (their loads issued first) for an instance of
// K, N <= S: 8 for S = 2 (the rotate shape), fewer where a row is wider
__host__ __device__ constexpr int rows_for(int s) {
  return s <= 2 ? 8 : s <= 4 ? 4 : 2;
}

// the float value of element i of 32-bit words w (float32 or bfloat16)
template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int i);
template <>
__device__ __forceinline__ float word_elem<float>(const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ float word_elem<bf16>(const uint32_t* w, int i) {
  const uint32_t v = w[i / 2];
  return __uint_as_float((i % 2 ? v >> 16 : v & 0xffff) << 16);
}

// x[0..BYTES / sizeof(T)) from one vector load of BYTES bytes at p
template <typename T, int BYTES, int KM>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[KM]) {
  constexpr int W = BYTES / 4, E = BYTES / static_cast<int>(sizeof(T));
  static_assert(E <= KM, "a row wider than the instance");
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = word_elem<T>(w, i);
}

// y[0..BYTES / sizeof(O)) as one vector store of BYTES bytes at p
template <typename O, int BYTES, int NM>
__device__ __forceinline__ void store_vec(O* p, const float (&y)[NM]) {
  constexpr int W = BYTES / 4;
  static_assert(BYTES / static_cast<int>(sizeof(O)) <= NM,
                "a row wider than the instance");
  uint32_t w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(O) == 4) {
      w[i] = __float_as_uint(y[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// a row of X into x[KM]: one vector load where in_vec (its byte width,
// 4, 8 or 16, every row aligned to it) fits the instance, else element
// by element; zeros past k
template <typename T, int KM>
__device__ __forceinline__ void load_row(const T* xr, int k, int in_vec,
                                         float (&x)[KM]) {
  constexpr int B = static_cast<int>(sizeof(T)) * KM;
#pragma unroll
  for (int kk = 0; kk < KM; ++kk) x[kk] = 0.0f;
  if constexpr (B >= 16) {
    if (in_vec == 16) return load_vec<T, 16>(xr, x);
  }
  if constexpr (B >= 8) {
    if (in_vec == 8) return load_vec<T, 8>(xr, x);
  }
  if constexpr (B >= 4) {
    if (in_vec == 4) return load_vec<T, 4>(xr, x);
  }
#pragma unroll
  for (int kk = 0; kk < KM; ++kk)
    if (kk < k) x[kk] = widen(xr[kk]);
}

template <typename O, int NM>
__device__ __forceinline__ void store_row(O* cr, int n, int out_vec,
                                          const float (&out)[NM]) {
  constexpr int B = static_cast<int>(sizeof(O)) * NM;
  if constexpr (B >= 16) {
    if (out_vec == 16) return store_vec<O, 16>(cr, out);
  }
  if constexpr (B >= 8) {
    if (out_vec == 8) return store_vec<O, 8>(cr, out);
  }
  if constexpr (B >= 4) {
    if (out_vec == 4) return store_vec<O, 4>(cr, out);
  }
#pragma unroll
  for (int j = 0; j < NM; ++j)
    if (j < n) store(cr + j, out[j]);
}

// one instance for K, N <= S (S = 2, 4 or 8): Y's S x S values (zeros
// past k, n) in registers, rows_for(S) rows a thread a step, all their
// loads issued before any product; four blocks an SM where S <= 4
template <typename T, typename O, int S>
__global__ void __launch_bounds__(repro::kThreads, S <= 4 ? 4 : 1)
skinny_kernel(O* __restrict__ c, const T* __restrict__ a,
              const T* __restrict__ b, int64_t m, int k, int n, int in_vec,
              int out_vec) {
  float y[S][S];
#pragma unroll
  for (int kk = 0; kk < S; ++kk)
#pragma unroll
    for (int j = 0; j < S; ++j)
      y[kk][j] = (kk < k && j < n) ? widen(b[kk * n + j]) : 0.0f;
  constexpr int kRows = rows_for(S);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
       row0 < m; row0 += stride * kRows) {
    float x[kRows][S];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = row0 + r * stride;
      if (row < m) {
        load_row<T, S>(a + row * k, k, in_vec, x[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = row0 + r * stride;
      if (row >= m) continue;
      float out[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int kk = 0; kk < S; ++kk)
          if (kk < k) acc = __fadd_rn(acc, __fmul_rn(x[r][kk], y[kk][j]));
        out[j] = acc;
      }
      store_row<O, S>(c + row * n, n, out_vec, out);
    }
  }
}

// the vector width for rows of `row_bytes` bytes at base p, or 0
inline int vec_width(const void* p, int64_t row_bytes) {
  if (row_bytes != 4 && row_bytes != 8 && row_bytes != 16) return 0;
  return reinterpret_cast<uintptr_t>(p) % row_bytes == 0
             ? static_cast<int>(row_bytes) : 0;
}

template <typename T, typename O, int S>
int launch_skinny_s(void* c, const void* a, const void* b, int64_t m,
                    int64_t k, int64_t n, cudaStream_t st) {
  const int in_vec = vec_width(a, k * static_cast<int64_t>(sizeof(T)));
  const int out_vec = vec_width(c, n * static_cast<int64_t>(sizeof(O)));
  constexpr int kRows = rows_for(S);
  skinny_kernel<T, O, S><<<repro::blocks_for((m + kRows - 1) / kRows,
                                             repro::kMaxBlocksX),
                           repro::kThreads, 0, st>>>(
      static_cast<O*>(c), static_cast<const T*>(a), static_cast<const T*>(b),
      m, static_cast<int>(k), static_cast<int>(n), in_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch_skinny(void* c, const void* a, const void* b, int64_t m, int64_t k,
                  int64_t n, cudaStream_t st) {
  const int64_t s = k > n ? k : n;
  return s <= 2 ? launch_skinny_s<T, O, 2>(c, a, b, m, k, n, st)
       : s <= 4 ? launch_skinny_s<T, O, 4>(c, a, b, m, k, n, st)
                : launch_skinny_s<T, O, kSkinny>(c, a, b, m, k, n, st);
}

// -- 2. bfloat16: the wgmma GEMM ----------------------------------------------

namespace wg {

constexpr int BM = 128, BK = 64;
constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;    // + the producer warp
constexpr int kPanel = 128;                        // bytes a swizzled row
constexpr int A_BYTES = BM * kPanel;               // (BM, 64) of X

// BN the tile's width, S the ring's stages
template <int BN, int S>
struct Tile {
  static constexpr int B_BYTES = BK * kPanel * (BN / 64);   // (64, BN) of Y
  static constexpr int SMEM = S * (A_BYTES + B_BYTES) + 1024;
  static_assert(SMEM <= 232448, "the ring exceeds a block's shared memory");
};

// 8 bfloat16 values of a row from global memory, zeros past `valid`
__device__ __forceinline__ uint4 load8(const bf16* p, int valid) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < valid
        ? static_cast<uint32_t>(__bfloat16_as_ushort(p[2 * i])) : 0u;
    const uint32_t hi = 2 * i + 1 < valid
        ? static_cast<uint32_t>(__bfloat16_as_ushort(p[2 * i + 1])) : 0u;
    w[i] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one (rows, 64) box of a row-major (R, C) matrix at (r0, c0) into a
// 128-byte-swizzled panel, by the 32 lanes of a warp (zeros out of bounds)
__device__ __forceinline__ void stage_box(uint8_t* dst, const bf16* src,
                                          int64_t r_total, int64_t c_total,
                                          int64_t r0, int64_t c0, int rows,
                                          int lane) {
  for (int ch = lane; ch < rows * 8; ch += 32) {
    const int r = ch / 8, q = ch % 8;
    const int64_t gr = r0 + r, gc = c0 + 8 * q, rem = c_total - gc;
    const int valid = gr < r_total && rem > 0
        ? static_cast<int>(rem < 8 ? rem : 8) : 0;
    const uint4 v = valid > 0 ? load8(src + gr * c_total + gc, valid)
                              : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + r * kPanel + ((q ^ (r % 8)) * 16)) = v;
  }
}

template <int BN>
__device__ __forceinline__ void mma_panel(float (&acc)[BN / 2],
                                          uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // X: K-major, + 32 bytes a k16 step; Y: N-major, + 16 rows a step,
    // its 64-wide panels BK rows apart
    const uint64_t da = hopper::desc_b128(sa + kk * 32, 16, 1024);
    const uint64_t db = hopper::desc_b128(sb + kk * 16 * kPanel,
                                          BK * kPanel, 1024);
    if constexpr (BN == 128) {
      hopper::wgmma_ss_n128<1>(acc, da, db, 1);
    } else {
      hopper::wgmma_ss_n64<1>(acc, da, db, 1);
    }
  }
}

template <int BN, int kStages, typename O, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, O* __restrict__ c,
            const bf16* __restrict__ a, const bf16* __restrict__ b, int64_t m,
            int64_t k, int64_t n) {
  constexpr int B_BYTES = Tile<BN, kStages>::B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  // the ring, 1024-byte aligned: kStages A tiles, then kStages B tiles
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* ring = smem_raw + (base - raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int ktiles = static_cast<int>((k + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kTma ? 1 : 32);
      hopper::mbar_init(&empty[s], kConsumers * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {                  // the producer warp
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
      uint8_t* sa = ring + s * A_BYTES;
      uint8_t* sb = ring + kStages * A_BYTES + s * B_BYTES;
      if constexpr (kTma) {
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          hopper::tma_load_2d(sa, &map_a, &full[s], kt * BK,
                              static_cast<int>(row0));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(sb + j * BK * kPanel, &map_b, &full[s],
                                static_cast<int>(col0) + 64 * j, kt * BK);
        }
      } else {
        stage_box(sa, a, m, k, row0, static_cast<int64_t>(kt) * BK, BM, lane);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          stage_box(sb + j * BK * kPanel, b, k, n,
                    static_cast<int64_t>(kt) * BK, col0 + 64 * j, BK, lane);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  hopper::fence_regs(acc);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t sa = base + s * A_BYTES + wg * 64 * kPanel;
    const uint32_t sb = base + kStages * A_BYTES + s * B_BYTES;
    hopper::wgmma_fence();
    mma_panel<BN>(acc, sa, sb);
    hopper::wgmma_commit();
    // the previous panel's products are done: release its stage
    hopper::wgmma_wait<1>();
    if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int wl = warp % 4, g = lane / 4, t = lane % 4;
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int64_t row = row0 + wg * 64 + wl * 16 + g + 8 * ((i % 4) / 2);
    const int64_t col = col0 + 8 * (i / 4) + 2 * t;
    if (row >= m || col >= n) continue;
    O* p = c + row * n + col;
    if (pairs) {   // col is even, so col + 1 < n and the pair is aligned
      if constexpr (sizeof(O) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    } else {
      store(p, acc[i]);
      if (col + 1 < n) store(p + 1, acc[i + 1]);
    }
  }
}

template <int BN, int S, typename O, bool kTma>
int launch_tile(const CUtensorMap& map_a, const CUtensorMap& map_b, void* c,
                const void* a, const void* b, int64_t m, int64_t k, int64_t n,
                cudaStream_t st) {
  const int64_t gx = (n + BN - 1) / BN, gy = (m + BM - 1) / BM;
  if (gx > 0x7fffffff || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gemm_kernel<BN, S, O, kTma>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN, S>::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
           kThreads, Tile<BN, S>::SMEM, st>>>(
      map_a, map_b, static_cast<O*>(c), static_cast<const bf16*>(a),
      static_cast<const bf16*>(b), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int S, typename O>
int launch_bn(void* c, const void* a, const void* b, int64_t m, int64_t k,
              int64_t n, cudaStream_t st) {
  // TMA needs 16-byte aligned bases and row strides that are multiples
  // of 16 bytes (K and N multiples of 8 bfloat16 values)
  const bool tma = k > 0 && k % 8 == 0 && n % 8 == 0 && hopper::aligned16(a)
                   && hopper::aligned16(b);
  CUtensorMap map_a{}, map_b{};
  if (!tma) {
    return launch_tile<BN, S, O, false>(map_a, map_b, c, a, b, m, k, n, st);
  }
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t strides_a[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box_a[2] = {BK, BM};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k)};
  const cuuint64_t strides_b[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box_b[2] = {64, BK};
  if (!hopper::make_map(&map_a, a, 2, dims_a, strides_a, box_a)
      || !hopper::make_map(&map_b, b, 2, dims_b, strides_b, box_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tile<BN, S, O, true>(map_a, map_b, c, a, b, m, k, n, st);
}

template <int BN, typename O>
int launch_stages(void* c, const void* a, const void* b, int64_t m, int64_t k,
                  int64_t n, int64_t stages, cudaStream_t st) {
  switch (stages) {
    case 3: return launch_bn<BN, 3, O>(c, a, b, m, k, n, st);
    case 6: return launch_bn<BN, 6, O>(c, a, b, m, k, n, st);
    default: return launch_bn<BN, 4, O>(c, a, b, m, k, n, st);
  }
}

// bn, stages: the knobs (0 for the kernel's own choice: BN by SM fill,
// 4 stages); the C entry has checked them.
template <typename O>
int launch(void* c, const void* a, const void* b, int64_t m, int64_t k,
           int64_t n, int64_t bn, int64_t stages, cudaStream_t st) {
  if (bn == 64) return launch_stages<64, O>(c, a, b, m, k, n, stages, st);
  if (bn == 128) return launch_stages<128, O>(c, a, b, m, k, n, stages, st);
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // 128-wide tiles unless they would leave SMs without a tile
  const int64_t tiles128 = ((m + BM - 1) / BM) * ((n + 127) / 128);
  return tiles128 >= sms
             ? launch_stages<128, O>(c, a, b, m, k, n, stages, st)
             : launch_stages<64, O>(c, a, b, m, k, n, stages, st);
}

}  // namespace wg

// -- 3. float32: the CUDA-core tile kernel -------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kTileThreads = (BM / TM) * (BN / TN);   // 256

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
  // x walks the row tiles, y the column tiles
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
// 1 for bfloat16.  bn, stages: the wgmma regime's knobs, 0 for its own
// choice (BN by SM fill, 4 stages), else BN 64 or 128 and 3, 4 or 6
// stages; the other regimes read neither.  Returns cudaGetLastError().
int matmul_2d(void* c, const void* a, const void* b, int64_t m, int64_t k,
              int64_t n, int64_t in_bf16, int64_t out_bf16, int64_t bn,
              int64_t stages, void* stream) {
  if ((bn != 0 && bn != 64 && bn != 128) ||
      (stages != 0 && stages != 3 && stages != 4 && stages != 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kSkinny && n <= kSkinny) {
    if (in_bf16) {
      return out_bf16 ? launch_skinny<bf16, bf16>(c, a, b, m, k, n, st)
                      : launch_skinny<bf16, float>(c, a, b, m, k, n, st);
    }
    return out_bf16 ? launch_skinny<float, bf16>(c, a, b, m, k, n, st)
                    : launch_skinny<float, float>(c, a, b, m, k, n, st);
  }
  if (in_bf16) {
    return out_bf16 ? wg::launch<bf16>(c, a, b, m, k, n, bn, stages, st)
                    : wg::launch<float>(c, a, b, m, k, n, bn, stages, st);
  }
  return out_bf16 ? launch<float, bf16>(c, a, b, m, k, n, st)
                  : launch<float, float>(c, a, b, m, k, n, st);
}

}  // extern "C"
