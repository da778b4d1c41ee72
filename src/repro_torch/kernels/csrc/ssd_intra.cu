// The Mamba-2 SSD intra-chunk core, per (chunk c, head h):
//
//   G[i, j]  = C[i] . B[j]                                      (lc, lc)
//   att[i,j] = G[i, j] * exp(cum[i] - cum[j])  for j <= i, else 0
//   y[i]     = sum_j att[i, j] * xdt[j]                         (lc, p)
//   S_c      = sum_j (xdt[j] * exp(cum[lc-1] - cum[j]))^T B[j]  (p, n)
//
// with xdt (BC, lc, h, p), B, C (BC, lc, n), cum (BC, lc, h) float32, and
// y (BC, lc, h, p), S_c (BC, h, p, n) float32 out.
//
// Replaces the TPU kernel ssd_intra of src/repro/kernels/ssd/ssd.py (the
// _ssd_intra_kernel Pallas body over a (BC, h) grid, the whole (lc, lc)
// att resident in VMEM).
//
// Bound on an H100: memory.  On the serving path (hymba-1.5b prefill:
// BC = 32 chunks of lc = 256, h = 50 heads of p = 64, n = 16) the inputs
// and the float32 outputs are 166 MB, ~0.05 ms at 3.35 TB/s, most of it
// y's float32 store; the work, lc*(lc+1)/2*(2n + 2p + 2) + 2*lc*p*n flops
// a (chunk, head), 9.4 GFLOP a layer, takes ~0.01 ms on the bfloat16
// tensor cores but ~0.14 ms on the float32 CUDA cores.
//
// bfloat16: the wgmma kernel (namespace wg).  One consumer warpgroup and
// one producer warp a block.  A block owns one chunk, a group of up to
// kHeads heads, and a role: the y rows of one 64-row query tile, or the
// chunk states S_c of its heads.  The roles are launched heaviest first
// (the last query tile, the states, then the query tiles upwards), so the
// triangle leaves no tail.  The producer stages the chunk's B rows (up to
// the block's last query row; all of them for the states) and, for a y
// block, its tile of C rows, once, by TMA from 3-D tensor maps over (n,
// lc, BC); rows past lc and columns past n read TMA's zeros, so a B or C
// row of n = 16 values is a 64-wide panel in the 128-byte swizzle, zero
// past 16 (flash_attention.cu's D = 16), and n = 128 two panels.  B and C
// are then reused for every head of the group.  The producer then streams
// the xdt tiles (64 keys x p of one head, from a 4-D map over (p, h, lc,
// BC), so a ragged chunk reads zeros and never the next chunk's rows)
// through a ring in the order the warpgroup takes them.
//
// A y block, for each head and each key tile at or below its query tile:
//   * G = C B^T on wgmma m64n64k16 (C and B both K-major, n / 16 steps)
//     into fp32 registers.  G does not depend on the head; it is computed
//     again for each head, which costs n / 16 k16 steps against the four
//     of att @ xdt below and keeps the shared memory small enough for two
//     (n = 128) or three (n = 16) blocks an SM (see below).
//   * att = G o exp(cum_i - cum_j) on the accumulator fragments, the
//     exponent masked to -inf for j > i BEFORE exp on the diagonal tile
//     (for j > i it is positive and can overflow), rounded to bfloat16 in
//     registers -- the accumulator fragment of 16 keys is the A fragment
//     of a k16 step, as P in flash_attention.cu.
//   * y += att @ xdt_h on wgmma m64n64k16, A from registers, xdt N-major
//     (the transpose bit); p = 16 reads the tile's zero columns and stores
//     only its 16.
// y stays fp32 in registers until the head's last tile, then each thread
// stores its two rows as float2 pairs (a warp writes 8 whole 32-byte
// sectors an instruction).
//
// A states block, for each head: S_c = w^T B over all key tiles, w = xdt
// o exp(cum_last - cum) rounded to bfloat16, on wgmma m64 n(64|128) k16:
// the A fragments of xdt^T (rows p, columns keys) come from the swizzled
// xdt tile by one transposed ldmatrix a k16 step, are scaled by each
// key's decay and rounded in registers, and B is the staged B rows
// N-major.  On the CUDA cores S_c (2 p n lc flops a head) would take
// ~0.05 ms a layer at n = 128, past the whole kernel's bound.
//
// Measured on an H100 80GB HBM3 (PERF.md): builds with G's products left
// out ran barely faster at n = 128 and no faster at n = 16, so G is
// computed again for each head rather than kept in shared memory (64 KB
// at lc = 256, which would leave one block an SM); groups of 8 heads beat
// 2, 4 and 16; a ring of 3 xdt tiles and 3 blocks an SM beat deeper rings
// at 2 blocks; float4 stores of y built by lane-pair shuffles, and
// overlapping one tile's att @ xdt with the next tile's G and att, were
// both slower.
//
// Rounding: att and w are rounded to bfloat16 before the products they
// feed, as the JAX package's own bfloat16 path rounds them
// (src/repro/models/ssm.py, `att` and `w` .astype(cdtype)); the TPU
// kernel's float32 dot_generals take bfloat16 operands on its matrix unit
// at default precision.  The tensor cores sum in their own order.  So the
// kernel agrees with the plain version (kernels/ssd/ref.py) to
// tests/torch_bounds.py::ssd_bounds' bfloat16 branch.
//
// float32: the CUDA-core kernel (namespace simt), one block of 256
// threads per (chunk, head), one query row a thread, B and xdt staged in
// tiles of 32 rows, att formed on the fly and S_c in the same walk, the
// sums in another order than the plain version's einsums, so the two
// agree to the float32 branch of ssd_bounds.
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

constexpr int kRows = 256;   // the largest chunk

namespace simt {

constexpr int kTJ = 32;      // rows j a staged tile

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }

template <typename T, int P, int N>
__global__ void __launch_bounds__(kRows)
ssd_intra_kernel(float* __restrict__ y, float* __restrict__ s_out,
                 const T* __restrict__ xdt, const T* __restrict__ b,
                 const T* __restrict__ c, const float* __restrict__ cum,
                 int64_t lc, int64_t h) {
  constexpr int kS = (P * N + kRows - 1) / kRows;   // S_c elements a thread
  __shared__ float cums[kRows];
  __shared__ float bs[kTJ][N];
  __shared__ float xs[kTJ][P];
  __shared__ float sdec[kTJ];
  const int64_t chunk = blockIdx.x;
  const int64_t hh = blockIdx.y;
  const int i = threadIdx.x;
  const bool row = i < lc;

  for (int j = i; j < lc; j += kRows) cums[j] = cum[(chunk * lc + j) * h + hh];
  __syncthreads();
  const float cum_i = row ? cums[i] : 0.0f;
  const float cum_last = cums[lc - 1];
  float ci[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    ci[n] = row ? load(c, (chunk * lc + i) * N + n) : 0.0f;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
  float sacc[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) sacc[k] = 0.0f;

  for (int64_t j0 = 0; j0 < lc; j0 += kTJ) {
    const int jend = static_cast<int>(lc - j0 < kTJ ? lc - j0 : kTJ);
    __syncthreads();                               // the last tile is consumed
    for (int e = i; e < kTJ * N; e += kRows) {
      const int jr = e / N, nn = e - jr * N;
      bs[jr][nn] = jr < jend ? load(b, (chunk * lc + j0 + jr) * N + nn) : 0.0f;
    }
    for (int e = i; e < kTJ * P; e += kRows) {
      const int jr = e / P, pp = e - jr * P;
      xs[jr][pp] = jr < jend
          ? load(xdt, ((chunk * lc + j0 + jr) * h + hh) * P + pp) : 0.0f;
    }
    if (i < kTJ) sdec[i] = i < jend ? expf(cum_last - cums[j0 + i]) : 0.0f;
    __syncthreads();

    // y: rows i >= j0 meet this tile; j > i is masked before exp
    if (row && j0 <= i) {
      for (int jr = 0; jr < jend; ++jr) {
        float g = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) g = fmaf(ci[n], bs[jr][n], g);
        const int64_t j = j0 + jr;
        const float e = j <= i ? cum_i - cums[j] : -INFINITY;
        const float att = g * expf(e);
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(att, xs[jr][p], acc[p]);
      }
    }
    // S_c: this thread's elements (p, n) over the tile's rows
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int idx = i + k * kRows;
      if (idx < P * N) {
        const int p = idx / N, n = idx - p * N;
        for (int jr = 0; jr < jend; ++jr)
          sacc[k] = fmaf(xs[jr][p] * sdec[jr], bs[jr][n], sacc[k]);
      }
    }
  }
  if (row) {
#pragma unroll
    for (int p = 0; p < P; ++p) y[((chunk * lc + i) * h + hh) * P + p] = acc[p];
  }
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int idx = i + k * kRows;
    if (idx < P * N) s_out[(chunk * h + hh) * P * N + idx] = sacc[k];
  }
}

template <typename T, int P, int N>
int launch(void* y, void* s_c, const void* xdt, const void* b, const void* c,
           const void* cum, int64_t bc, int64_t lc, int64_t h,
           cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(bc), static_cast<unsigned>(h));
  ssd_intra_kernel<T, P, N><<<grid, kRows, 0, st>>>(
      static_cast<float*>(y), static_cast<float*>(s_c),
      static_cast<const T*>(xdt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(cum), lc, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace wg {

constexpr int BQ = 64;                  // query rows a y block
constexpr int BK = 64;                  // keys a tile
constexpr int kThreads = 128 + 32;      // the warpgroup + the producer warp
constexpr int kPanel = 128;             // bytes a swizzled row
constexpr int kHeads = 8;               // heads a block at most
constexpr int X_BYTES = BK * kPanel;    // an xdt tile: 64 keys x 64 (p <= 64)

template <int N>
struct Cfg {
  static constexpr int NP = (N + 63) / 64;         // 64-wide panels a row
  static constexpr int SN = 64 * NP;               // S_c's wgmma width
  static constexpr int STAGES = N <= 64 ? 3 : 2;   // the xdt ring
  static constexpr int BLOCKS = N <= 64 ? 3 : 2;   // blocks an SM holds
  static constexpr int B_BYTES = NP * kRows * kPanel;
  static constexpr int C_BYTES = NP * BQ * kPanel;
  static constexpr int SMEM = B_BYTES + C_BYTES + STAGES * X_BYTES + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S_c (64 x SN) += w^T (64 x 16, registers) . B (16 x SN, N-major)
template <int SN>
__device__ __forceinline__ void mma_state(float (&d)[SN / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (SN == 128) {
    hopper::wgmma_rs_n128<1>(d, a, db, 1);
  } else {
    hopper::wgmma_rs_n64<1>(d, a, db, 1);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, Cfg<N>::BLOCKS)
ssd_kernel(const __grid_constant__ CUtensorMap map_x,
           const __grid_constant__ CUtensorMap map_b,
           const __grid_constant__ CUtensorMap map_c, float* __restrict__ y,
           float* __restrict__ s_out, const float* __restrict__ cum, int bc,
           int lc, int h, int hg, int ngroups) {
  using C = Cfg<N>;
  constexpr int SN = C::SN, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bc_full, full[ST], empty[ST];
  __shared__ float cums[kRows * kHeads];      // cum of the staged rows, heads
  // B rows (NP panels of (kRows, 64)), the C tile (NP panels of (BQ, 64)),
  // then the xdt ring, 1024-byte aligned
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* bs = smem_raw + (base - raw);
  uint8_t* cs = bs + C::B_BYTES;
  uint8_t* xs = cs + C::C_BYTES;
  const uint32_t b_base = base, c_base = base + C::B_BYTES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the role, heaviest first: 0 the last query tile, 1 the states, r >= 2
  // query tile nqt - r
  const int nqt = (lc + BQ - 1) / BQ;
  const int per_role = bc * ngroups;
  const int role = blockIdx.x / per_role;
  const int chunk = (blockIdx.x % per_role) / ngroups;
  const int h0 = (blockIdx.x % ngroups) * hg;
  const int nh = min(hg, h - h0);
  const bool states = role == 1;
  const int qt = role == 0 ? nqt - 1 : nqt - role;
  const int ntiles = states ? nqt : qt + 1;   // key tiles a head
  const int rows = ntiles * BK;               // B rows staged

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bc_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                               // the producer warp
    if (lane == 0) {
      hopper::mbar_expect_tx(&bc_full,
                             C::NP * rows * kPanel + (states ? 0 : C::C_BYTES));
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn) {
        for (int t = 0; t < ntiles; ++t)
          hopper::tma_load_3d(bs + (pn * kRows + t * BK) * kPanel, &map_b,
                              &bc_full, 64 * pn, t * BK, chunk);
        if (!states)
          hopper::tma_load_3d(cs + pn * BQ * kPanel, &map_c, &bc_full,
                              64 * pn, qt * BQ, chunk);
      }
      int i = 0;
      for (int k = 0; k < nh; ++k) {
        for (int t = 0; t < ntiles; ++t, ++i) {
          const int s = i % ST;
          if (i >= ST) hopper::mbar_wait(&empty[s], ((i / ST) - 1) & 1);
          hopper::mbar_expect_tx(&full[s], X_BYTES);
          hopper::tma_load_4d(xs + s * X_BYTES, &map_x, &full[s], 0, h0 + k,
                              t * BK, chunk);
        }
      }
    }
    return;
  }

  // the warpgroup stages cum while the first loads are in flight; this
  // thread then holds accumulator rows r and r + 8 of its warp's 16,
  // columns 8 (j / 4) + 2 tq + j % 2 of register j
  for (int e = threadIdx.x; e < rows * kHeads; e += 128) {
    const int j = e / kHeads, k = e % kHeads;
    cums[e] = j < lc && k < nh
        ? cum[(static_cast<int64_t>(chunk) * lc + j) * h + h0 + k] : 0.0f;
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the warpgroup only
  const int g = lane / 4, tq = lane % 4;
  hopper::mbar_wait(&bc_full, 0);
  int i = 0;
  if (!states) {
    const int r0 = qt * BQ + warp * 16 + g;      // query rows r0, r0 + 8
    for (int k = 0; k < nh; ++k) {
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
      const float ci[2] = {cums[r0 * kHeads + k], cums[(r0 + 8) * kHeads + k]};
      for (int t = 0; t < ntiles; ++t, ++i) {
        const int s = i % ST;
        // G = C B^T for keys 64 t .. 64 t + 63
        float gs[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) gs[j] = 0.0f;
        hopper::fence_regs(gs);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // + 32 bytes a k16 step
          hopper::wgmma_ss_n64<0>(
              gs,
              hopper::desc_b128(c_base + (kk / 4) * BQ * kPanel + off, 16,
                                1024),
              hopper::desc_b128(
                  b_base + ((kk / 4) * kRows + t * BK) * kPanel + off, 16,
                  1024),
              1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(gs);

        // att = G o exp(cum_i - cum_j), j > i masked before exp on the
        // diagonal tile, as bfloat16 A fragments
        const bool diag = t == qt;
        uint32_t af[4][4];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int hr = (j % 4) / 2;
          const int row = r0 + 8 * hr;
          const int col = t * BK + 8 * (j / 4) + 2 * tq;
          float a2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = !diag || col + e <= row
                ? ci[hr] - cums[(col + e) * kHeads + k] : -INFINITY;
            a2[e] = gs[j + e] * expf(ex);
          }
          af[j / 8][(j % 8) / 2] = pack_bf16(a2[0], a2[1]);
        }

        // y += att @ xdt_h[keys of tile t]
        const uint32_t x_base = base + C::B_BYTES + C::C_BYTES + s * X_BYTES;
        hopper::mbar_wait(&full[s], (i / ST) & 1);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          hopper::wgmma_rs_n64<1>(
              acc, af[kk],
              hopper::desc_b128(x_base + kk * 16 * kPanel, BK * kPanel, 1024),
              1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int row = r0 + 8 * ((j % 4) / 2);
        const int col = 8 * (j / 4) + 2 * tq;
        if (row < lc && col < P) {
          *reinterpret_cast<float2*>(
              y + ((static_cast<int64_t>(chunk) * lc + row) * h + h0 + k) * P
              + col) = make_float2(acc[j], acc[j + 1]);
        }
      }
    }
    return;
  }

  const int p0 = warp * 16 + g;                  // S_c rows p0, p0 + 8
  for (int k = 0; k < nh; ++k) {
    float sacc[SN / 2];
#pragma unroll
    for (int j = 0; j < SN / 2; ++j) sacc[j] = 0.0f;
    const float c_last = cums[(lc - 1) * kHeads + k];
    for (int t = 0; t < ntiles; ++t, ++i) {
      const int s = i % ST;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      // w^T as A fragments: xdt^T by one transposed ldmatrix a k16 step
      // (lane l: key 16 kk + 8 ((l / 8) / 2) + l % 8, 16-byte chunk
      // 2 warp + (l / 8) % 2, swizzled), then each value times its key's
      // decay and rounded to bfloat16; w = 0 past lc (TMA's zeros times a
      // zero decay)
      uint32_t af[4][4];
      const uint32_t x_base = base + C::B_BYTES + C::C_BYTES + s * X_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int key = kk * 16 + 8 * (lane / 16) + lane % 8;
        const int chunk16 = 2 * warp + (lane / 8) % 2;
        uint32_t raw[4];
        hopper::ldmatrix_x4_trans(
            raw, x_base + key * kPanel + ((chunk16 ^ (key & 7)) << 4));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = t * BK + kk * 16 + 8 * half + 2 * tq;
          float sd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sd[e] = j + e < lc ? expf(c_last - cums[(j + e) * kHeads + k])
                               : 0.0f;
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 2 * half + hr;
            const float2 x2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
            af[kk][r] = pack_bf16(x2.x * sd[0], x2.y * sd[1]);
          }
        }
      }
      hopper::fence_regs(sacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 64 t + 16 kk ..; B's 64-wide panels kRows rows apart
        mma_state<SN>(sacc, af[kk],
                      hopper::desc_b128(b_base + (t * BK + kk * 16) * kPanel,
                                        kRows * kPanel, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int j = 0; j < SN / 2; j += 2) {
      const int pp = p0 + 8 * ((j % 4) / 2);
      const int col = 8 * (j / 4) + 2 * tq;
      if (pp < P && col < N) {
        *reinterpret_cast<float2*>(
            s_out + ((static_cast<int64_t>(chunk) * h + h0 + k) * P + pp) * N
            + col) = make_float2(sacc[j], sacc[j + 1]);
      }
    }
  }
}

template <int P, int N>
int launch(void* y, void* s_c, const void* xdt, const void* b, const void* c,
           const void* cum, int64_t bc, int64_t lc, int64_t h,
           cudaStream_t st) {
  using C = Cfg<N>;
  const int64_t ngroups = (h + kHeads - 1) / kHeads;
  const int64_t hg = (h + ngroups - 1) / ngroups;
  const int64_t blocks = bc * ngroups * ((lc + BQ - 1) / BQ + 1);
  if (blocks > 0x7fffffffLL || bc * lc > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuuint64_t dims_x[4] = {P, static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(lc),
                                static_cast<cuuint64_t>(bc)};
  const cuuint64_t strides_x[3] = {P * 2, static_cast<cuuint64_t>(h) * P * 2,
                                   static_cast<cuuint64_t>(lc * h) * P * 2};
  const cuuint32_t box_x[4] = {64, 1, BK, 1};
  const cuuint64_t dims_bc[3] = {N, static_cast<cuuint64_t>(lc),
                                 static_cast<cuuint64_t>(bc)};
  const cuuint64_t strides_bc[2] = {N * 2, static_cast<cuuint64_t>(lc) * N * 2};
  const cuuint32_t box_bc[3] = {64, BK, 1};
  CUtensorMap map_x{}, map_b{}, map_c{};
  if (!hopper::make_map(&map_x, xdt, 4, dims_x, strides_x, box_x)
      || !hopper::make_map(&map_b, b, 3, dims_bc, strides_bc, box_bc)
      || !hopper::make_map(&map_c, c, 3, dims_bc, strides_bc, box_bc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = ssd_kernel<P, N>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::SMEM, st>>>(
      map_x, map_b, map_c, static_cast<float*>(y), static_cast<float*>(s_c),
      static_cast<const float*>(cum), static_cast<int>(bc),
      static_cast<int>(lc), static_cast<int>(h), static_cast<int>(hg),
      static_cast<int>(ngroups));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

int launch_pn(bool bf16, void* y, void* s_c, const void* xdt, const void* b,
              const void* c, const void* cum, int64_t bc, int64_t lc,
              int64_t h, int64_t p, int64_t n, cudaStream_t st) {
  if (p == 16 && n == 16) {
    return bf16 ? wg::launch<16, 16>(y, s_c, xdt, b, c, cum, bc, lc, h, st)
                : simt::launch<float, 16, 16>(y, s_c, xdt, b, c, cum, bc, lc,
                                              h, st);
  }
  if (p == 64 && n == 16) {
    return bf16 ? wg::launch<64, 16>(y, s_c, xdt, b, c, cum, bc, lc, h, st)
                : simt::launch<float, 64, 16>(y, s_c, xdt, b, c, cum, bc, lc,
                                              h, st);
  }
  if (p == 64 && n == 128) {
    return bf16 ? wg::launch<64, 128>(y, s_c, xdt, b, c, cum, bc, lc, h, st)
                : simt::launch<float, 64, 128>(y, s_c, xdt, b, c, cum, bc,
                                               lc, h, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y: (BC, lc, h, p) and s_c: (BC, h, p, n) float32 out; xdt: (BC, lc, h, p),
// b, c: (BC, lc, n) all float32 (bf16 = 0) or all bfloat16 (bf16 = 1, the
// bases of xdt, b and c 16-byte aligned for TMA); cum: (BC, lc, h) float32.
// lc <= 256; (p, n) is (16, 16), (64, 16) or (64, 128); h < 65536.
// Returns cudaGetLastError().
int ssd_intra(void* y, void* s_c, const void* xdt, const void* b,
              const void* c, const void* cum, int64_t bc, int64_t lc,
              int64_t h, int64_t p, int64_t n, int64_t bf16, void* stream) {
  if (bc == 0 || lc == 0 || h == 0) return 0;
  if (lc > kRows || h > 65535 || bc > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && !repro::aligned16(xdt, b, c))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_pn(bf16 != 0, y, s_c, xdt, b, c, cum, bc, lc, h, p, n, st);
}

}  // extern "C"
