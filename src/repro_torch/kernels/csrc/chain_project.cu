// Folded projective transform chain: q = divide([p, 1] @ H) with an
// inclusive axis-aligned cull, for (N, d) points, H (d+1, d+1), lo/hi (d,),
// row-vector convention.  Emits the projected points and one mask byte per
// point (1 = inside).
//
// Replaces the TPU kernels chain_project_1d and chain_project_batch_2d of
// src/repro/kernels/projective/projective.py (the _chain_project_kernel and
// _chain_project_batch_kernel Pallas bodies).  Those hold one coordinate
// per lane, so they need 2*(2d-1) lane-rolled multiply-adds against
// d-periodic coefficient rows (_proj_rows) and a roll-AND reduction to
// spread a point's inside bit over its lanes.  Here one thread holds the
// whole point: it computes the point's d outputs, its w and its inside bit
// directly, and writes ONE mask byte -- no coefficient rows, no reduction.
//
// Bound on an H100: memory.  One pass reads the N*d float32 points once,
// writes them once and writes N mask bytes: (8d + 1)*N bytes plus the
// parameters ((d+1)^2 + 2d words per chain, per request for a batch), over
// 3.35 TB/s of HBM.  About 33 float operations per point at d = 3
// (2d(d+1) multiply/adds, d divides, 2d compares) stay far below the
// card's float32 rate.
//
// Operation order (the float contract): each homogeneous column c in
// 0..d (c = d is w) is
//
//   acc = p0 * H[0][c]; acc = acc + p1 * H[1][c]; ...; acc = acc + H[d][c]
//
// with every multiply, add and divide a separately rounded __fmul_rn /
// __fadd_rn / __fdiv_rn, never contracted into an FMA nor approximated.
// This is the order of the reference's plain oracle
// (src/repro/kernels/projective/ref.py: the products summed over m, the
// translation row added last), NOT that of the reference Pallas kernel,
// which starts its accumulators at the translation row.  Then
//
//   w_ok = w > 0  (false for NaN);  v[c] = acc[c] / (w_ok ? w : 1)
//   inside = w_ok && lo[c] <= v[c] <= hi[c] for every c
//
// lo/hi arrive as floats and may be +-inf (no cull): no clamp.  The plain
// PyTorch version (kernels/projective/ref.py) runs the same sequence of
// rounded ops, so kernel and plain version agree bit for bit, mask
// included.
//
// Design:
//   * chain_project_1d has two kernels.  chain_project_vec_kernel takes
//     a launch of 2**19 points or more whose x and y lie on 16-byte
//     boundaries and whose mask lies on a 4-byte one: a thread holds four
//     whole points (d float4 vectors, 48 bytes at d = 3, 32 at d = 2)
//     and stores their four mask bytes as one 32-bit word.  H ((d+1)^2
//     floats), lo and hi are loaded into registers once a thread.  Each
//     block walks contiguous chunks of kUnroll * kVecThreads groups of
//     four points over a grid of the blocks the card holds at once
//     (vecadd_vec_kernel's layout in affine_2d.cu), all loads of a thread
//     before its stores.  A warp's 32 groups are 32 d contiguous vectors:
//     the warp reads them lane by lane (each load instruction 512
//     contiguous bytes) into shared memory, each lane takes its group's d
//     vectors from there (a 48-byte stride that hits 8 distinct 16-byte
//     bank groups a quarter warp) and puts the results back, and the
//     warp writes them out lane by lane -- reading and writing a lane's
//     own d vectors straight from memory gave each warp instruction a
//     32- or 48-byte stride and ran well behind a device copy of the
//     same bytes on an H100 80GB HBM3 (PERF.md).  The last N mod 4
//     points go to the first block's first threads, one each.  Offsets
//     inside the buffer are 32-bit (the C entry sends buffers of 2**31
//     vectors and more to the scalar kernel).  A thread holds whole
//     points, so no column pattern is needed (chain_diag_vec_kernel's
//     v % 3).  chain_project_1d_kernel, one point a thread per int64
//     grid-stride step, takes every other launch: below 2**19 points --
//     the per-request calls of a served workload -- its many small
//     blocks beat the 16-byte kernel's few large ones on the same card,
//     and buffers off alignment.  Both run point_project, so the two
//     are bitwise equal to each other and to the plain version.
//   * chain_project_batch_2d, the server's bucket launch, has two
//     kernels.  chain_project_batch_kernel (one point a thread, 4-byte
//     accesses, one mask byte a thread, the request's parameters read
//     through pointers for every point, int64 indices) was the first
//     version: at the largest bucket of the mixed serve, (20, 65536, 2),
//     it took 0.01754 ms on an H100 80GB HBM3 (700 W), 38 % of its bound.
//     chain_project_batch_vec_kernel takes a launch whose rows hold whole
//     groups of four points (L a multiple of 4 -- always so under the
//     serving grid's default power-of-two lengths from 8) on 16-byte-
//     aligned x and y and a 4-byte-aligned mask, so no vector or mask
//     word straddles two requests.  A block serves one request
//     (blockIdx.y, striding over B past 1024), loads its (d+1)^2 + 2d
//     parameters once into registers and walks the row in contiguous
//     chunks over a grid of the blocks the card holds at once, all loads
//     of a thread before its stores (launch.cuh's walk_groups and
//     row_grid).  A group is chain_project_vec_kernel's: four whole
//     points in d float4 vectors and one 32-bit mask word; a warp's 32
//     groups are staged through shared memory at d = 2 and d = 3 alike,
//     so every load and store instruction covers 512 contiguous bytes
//     and a warp's 32 mask words 128.  Offsets inside a row are 32-bit
//     (the C entry sends rows of 2**31 vectors and more to the scalar
//     kernel); 64-bit arithmetic is the request's base alone.
//     chain_project_batch_kernel takes every other launch: a custom
//     grid's L of no multiple of 4, a base off alignment.
//   On an H100 80GB HBM3 (700 W) the vector kernel takes 0.0147 ms at
//   (20, 65536, 2), 0.88x a device copy of the same bytes, and
//   0.0447-0.0452 ms at the graphics phase's (64, 65536, 3), 70 % of its
//   bound and 1.48x faster than the scalar kernel (PERF.md).
#include "launch.cuh"

namespace {

template <int D>
__device__ __forceinline__ unsigned char point_project(
    float* __restrict__ q, const float* __restrict__ p,
    const float* __restrict__ h, const float* __restrict__ lo,
    const float* __restrict__ hi) {
  constexpr int W = D + 1;  // row length of H
  float x[D];
#pragma unroll
  for (int m = 0; m < D; ++m) x[m] = p[m];
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float a = __fmul_rn(x[0], h[c]);
#pragma unroll
    for (int m = 1; m < D; ++m) a = __fadd_rn(a, __fmul_rn(x[m], h[m * W + c]));
    acc[c] = __fadd_rn(a, h[D * W + c]);
  }
  const float w = acc[D];
  const bool w_ok = w > 0.0f;
  const float safe = w_ok ? w : 1.0f;
  bool inside = w_ok;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float v = __fdiv_rn(acc[c], safe);
    q[c] = v;
    inside = inside && (v >= lo[c]) && (v <= hi[c]);
  }
  return inside ? 1 : 0;
}

template <int D>
__global__ void chain_project_1d_kernel(float* __restrict__ y,
                                        unsigned char* __restrict__ mask,
                                        const float* __restrict__ x,
                                        const float* __restrict__ h,
                                        const float* __restrict__ lo,
                                        const float* __restrict__ hi,
                                        int64_t n_points) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_points; i += stride) {
    mask[i] = point_project<D>(y + i * D, x + i * D, h, lo, hi);
  }
}

// x, y: (B, L, D) packed; mask: (B, L); h: (B, D+1, D+1); lo, hi: (B, D).
template <int D>
__global__ void chain_project_batch_kernel(float* __restrict__ y,
                                           unsigned char* __restrict__ mask,
                                           const float* __restrict__ x,
                                           const float* __restrict__ h,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           int64_t bsz, int64_t len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    const float* hb = h + b * (D + 1) * (D + 1);
    const float* lob = lo + b * D;
    const float* hib = hi + b * D;
    const int64_t row = b * len;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < len; i += stride) {
      mask[row + i] = point_project<D>(y + (row + i) * D, x + (row + i) * D,
                                       hb, lob, hib);
    }
  }
}

constexpr int kUnroll = 4;
constexpr int kVecThreads = 128;
constexpr int kWarps = kVecThreads / 32;
// the points from which the 16-byte kernel runs; below, the scalar one
constexpr int64_t kVecPoints = int64_t{1} << 19;

// x, y: the flat (N * D,) float buffers of N = 4 nq + tail points (tail <
// 4), 16-byte aligned, nq * D < 2**31; mask: (N,) bytes, 4-byte aligned.
// Group q is points 4q .. 4q + 3: D float4 vectors from vector q * D, mask
// word q.
template <int D>
__global__ void __launch_bounds__(kVecThreads)
chain_project_vec_kernel(float* __restrict__ y,
                         unsigned char* __restrict__ mask,
                         const float* __restrict__ x,
                         const float* __restrict__ h,
                         const float* __restrict__ lo,
                         const float* __restrict__ hi, uint32_t nq,
                         int tail) {
  constexpr uint32_t kChunk = kUnroll * kVecThreads;   // groups a chunk
  __shared__ float4 stage[kWarps][kUnroll][32 * D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float hr[(D + 1) * (D + 1)], lor[D], hir[D];
#pragma unroll
  for (int k = 0; k < (D + 1) * (D + 1); ++k) hr[k] = h[k];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    lor[c] = lo[c];
    hir[c] = hi[c];
  }
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* yv = reinterpret_cast<float4*>(y);
  uint32_t* mask4 = reinterpret_cast<uint32_t*>(mask);
  const uint32_t nv = nq * D;
  for (uint32_t c = blockIdx.x * kChunk; c < nq; c += gridDim.x * kChunk) {
    // step u: this warp's 32 groups from g0 = c + 128 u + 32 warp, i.e.
    // 32 D vectors from g0 * D, read lane by lane (a warp instruction
    // reads 512 contiguous bytes) into shared memory
    float4 a[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v0 = (c + u * kVecThreads + warp * 32) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const uint32_t v = v0 + k * 32 + lane;
        if (v < nv) a[u][k] = xv[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < D; ++k) stage[warp][u][k * 32 + lane] = a[u][k];
    }
    __syncwarp();
    // lane l projects group g0 + l, its D vectors l * D .. l * D + D - 1
    // of the staged 32 D, and puts the results back in their place
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t q = c + u * kVecThreads + warp * 32 + lane;
      if (q < nq) {
        float p[4 * D], out[4 * D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float4 v = stage[warp][u][lane * D + k];
          p[4 * k] = v.x;
          p[4 * k + 1] = v.y;
          p[4 * k + 2] = v.z;
          p[4 * k + 3] = v.w;
        }
        uint32_t m = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          m |= static_cast<uint32_t>(
                   point_project<D>(out + e * D, p + e * D, hr, lor, hir))
               << (8 * e);
        }
#pragma unroll
        for (int k = 0; k < D; ++k) {
          stage[warp][u][lane * D + k] = make_float4(
              out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
        }
        mask4[q] = m;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v0 = (c + u * kVecThreads + warp * 32) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const uint32_t v = v0 + k * 32 + lane;
        if (v < nv) yv[v] = stage[warp][u][k * 32 + lane];
      }
    }
    __syncwarp();
  }
  // the last N mod 4 points, one a thread of the first block
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const int64_t i = 4 * static_cast<int64_t>(nq) + threadIdx.x;
    mask[i] = point_project<D>(y + i * D, x + i * D, hr, lor, hir);
  }
}

// the groups a thread of the batch kernel takes a chunk, at d = 2 and
// d = 3.  Builds of 1, 2 and 4 (58, 51, 72 registers at d = 2; 80, 72,
// 114 at d = 3; no spills) timed by tools/torch_kernel_ab.py on an H100
// 80GB HBM3 (700 W) at the mixed serve's smallest, median and largest
// projective buckets and the graphics one: 1 took 0.0064, 0.0085,
// 0.0147, 0.0449 ms; 2 0.0075, 0.0094, 0.0148, 0.0452; 4 0.0088,
// 0.0106, 0.0143, 0.0447.  With 2 or 4 the kernel lost to the scalar
// one (0.0066 ms) at the smallest bucket, (1, 4096, 3); with 1 it
// loses at none of the four, so the C entry needs no size threshold.
// Capping the registers at 64 (8 blocks an SM) spilled 40 bytes at d =
// 3 and took 0.0526 ms at the graphics bucket.
constexpr int kBatchUnroll = 1;

// The four points held in D float4 vectors, in place, through
// point_project on register copies (H, lo, hi in registers): returns the
// group's mask word, byte e for point e.
template <int D>
__device__ __forceinline__ uint32_t project_group(float4* v, const float* h,
                                                  const float* lo,
                                                  const float* hi) {
  float p[4 * D], out[4 * D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    p[4 * k] = v[k].x;
    p[4 * k + 1] = v[k].y;
    p[4 * k + 2] = v[k].z;
    p[4 * k + 3] = v[k].w;
  }
  uint32_t m = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m |= static_cast<uint32_t>(point_project<D>(out + e * D, p + e * D, h,
                                                lo, hi))
         << (8 * e);
  }
#pragma unroll
  for (int k = 0; k < D; ++k)
    v[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                       out[4 * k + 3]);
  return m;
}

// x, y: (B, L, D) packed floats, L a multiple of 4, L D / 4 < 2**31
// vectors a row, 16-byte-aligned bases; mask: (B, L) bytes, 4-byte
// aligned; h: (B, D+1, D+1); lo, hi: (B, D).  ng = L / 4 groups a row,
// group g of request b its D vectors from (b ng + g) D and mask word
// b ng + g.
template <int D>
__global__ void __launch_bounds__(repro::kVecThreads)
chain_project_batch_vec_kernel(float* __restrict__ y,
                               unsigned char* __restrict__ mask,
                               const float* __restrict__ x,
                               const float* __restrict__ h,
                               const float* __restrict__ lo,
                               const float* __restrict__ hi, int64_t bsz,
                               uint32_t ng) {
  constexpr int W = D + 1;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    float hr[W * W], lor[D], hir[D];
#pragma unroll
    for (int k = 0; k < W * W; ++k) hr[k] = h[b * W * W + k];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      lor[c] = lo[b * D + c];
      hir[c] = hi[b * D + c];
    }
    const int64_t base = b * ng;                   // in groups
    uint32_t* words = reinterpret_cast<uint32_t*>(mask) + base;
    repro::walk_groups<D, kBatchUnroll>(
        reinterpret_cast<float4*>(y) + base * D,
        reinterpret_cast<const float4*>(x) + base * D, ng,
        [&](float4* v, uint32_t g) {
          words[g] = project_group<D>(v, hr, lor, hir);
        });
  }
}

template <int D>
void launch_project_batch_vec(float* y, unsigned char* mask, const float* x,
                              const float* h, const float* lo,
                              const float* hi, int64_t bsz, int64_t ng,
                              int64_t waves, cudaStream_t st) {
  static const int64_t resident = repro::resident_blocks(
      chain_project_batch_vec_kernel<D>, repro::kVecThreads);
  chain_project_batch_vec_kernel<D><<<
      repro::row_grid(resident, bsz, ng,
                      kBatchUnroll * repro::kVecThreads, waves),
      repro::kVecThreads, 0, st>>>(y, mask, x, h, lo, hi, bsz,
                                   static_cast<uint32_t>(ng));
}

template <int D>
void launch_project_batch(float* y, unsigned char* mask, const float* x,
                          const float* h, const float* lo, const float* hi,
                          int64_t bsz, int64_t len, int threads,
                          int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_project_batch_kernel<D>);
  chain_project_batch_kernel<D><<<res.grid(len, bsz, threads, waves),
                                  threads, 0, st>>>(y, mask, x, h, lo, hi,
                                                    bsz, len);
}

// The 16-byte kernel's grid is capped at `waves` (one when 0) waves of
// resident blocks; the scalar kernel's per launch.cuh's knobs.
template <int D>
void launch_project_1d(float* y, unsigned char* mask, const float* x,
                       const float* h, const float* lo, const float* hi,
                       int64_t n_points, int threads, int64_t waves,
                       cudaStream_t st) {
  const int64_t nq = n_points / 4;
  if (n_points >= kVecPoints && nq * D < (int64_t{1} << 31)
      && repro::aligned16(y, x)
      && reinterpret_cast<uintptr_t>(mask) % 4 == 0) {
    static const int64_t resident =
        repro::resident_blocks(chain_project_vec_kernel<D>, kVecThreads);
    int64_t grid = (nq + kUnroll * kVecThreads - 1) / (kUnroll * kVecThreads);
    const int64_t cap = (waves > 0 ? waves : 1) * resident;
    if (grid > cap) grid = cap;
    chain_project_vec_kernel<D><<<static_cast<unsigned>(grid), kVecThreads,
                                  0, st>>>(
        y, mask, x, h, lo, hi, static_cast<uint32_t>(nq),
        static_cast<int>(n_points - 4 * nq));
    return;
  }
  static repro::Residency res(chain_project_1d_kernel<D>);
  chain_project_1d_kernel<D><<<res.grid(n_points, 1, threads, waves),
                               threads, 0, st>>>(y, mask, x, h, lo, hi,
                                                 n_points);
}

}  // namespace

extern "C" {

// flat: (N*d,) points; mask: (N,) bytes; h: (d+1, d+1); lo, hi: (d,);
// threads, waves: the launch knobs (launch.cuh, 0 for the kernel's own
// choice).  N of 2**19 or more on 16-byte-aligned x and y and a
// 4-byte-aligned mask takes the 16-byte kernel (which reads `waves`
// only), any other launch the scalar one.  Returns cudaGetLastError().
int chain_project_1d(void* y, void* mask, const void* x, const void* h,
                     const void* lo, const void* hi, int64_t n_points,
                     int64_t d, int64_t threads, int64_t waves,
                     void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_points == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* mo = static_cast<unsigned char*>(mask);
  auto* xi = static_cast<const float*>(x);
  auto* hm = static_cast<const float*>(h);
  auto* l = static_cast<const float*>(lo);
  auto* u = static_cast<const float*>(hi);
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_project_1d<2>(yo, mo, xi, hm, l, u, n_points, bt, waves, st);
  } else {
    launch_project_1d<3>(yo, mo, xi, hm, l, u, n_points, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); mask: (B, L) bytes; h: (B, d+1, d+1); lo, hi: (B, d).
// Rows of whole groups (L a multiple of 4) on 16-byte-aligned x and y
// and a 4-byte-aligned mask take the vector kernel (which reads `waves`
// only), any other launch the scalar one.  Returns cudaGetLastError().
int chain_project_batch_2d(void* y, void* mask, const void* x, const void* h,
                           const void* lo, const void* hi, int64_t bsz,
                           int64_t len, int64_t d, int64_t threads,
                           int64_t waves, void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0 || len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* mo = static_cast<unsigned char*>(mask);
  auto* xi = static_cast<const float*>(x);
  auto* hm = static_cast<const float*>(h);
  auto* l = static_cast<const float*>(lo);
  auto* u = static_cast<const float*>(hi);
  if (len % 4 == 0 && len * d / 4 < (int64_t{1} << 31) &&
      repro::aligned16(y, x) && reinterpret_cast<uintptr_t>(mask) % 4 == 0) {
    if (d == 2) {
      launch_project_batch_vec<2>(yo, mo, xi, hm, l, u, bsz, len / 4, waves,
                                  st);
    } else {
      launch_project_batch_vec<3>(yo, mo, xi, hm, l, u, bsz, len / 4, waves,
                                  st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_project_batch<2>(yo, mo, xi, hm, l, u, bsz, len, bt, waves, st);
  } else {
    launch_project_batch<3>(yo, mo, xi, hm, l, u, bsz, len, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
