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
// Design: the first version is one simple pass, one point per thread per
// grid-stride step, D templated so the loops unroll; a batch uses a 2D
// grid (y = request).  wgmma, TMA and vectorised loads are later work.
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

}  // namespace

extern "C" {

// flat: (N*d,) points; mask: (N,) bytes; h: (d+1, d+1); lo, hi: (d,).
// Returns cudaGetLastError().
int chain_project_1d(void* y, void* mask, const void* x, const void* h,
                     const void* lo, const void* hi, int64_t n_points,
                     int64_t d, void* stream) {
  if (n_points == 0) return 0;
  const unsigned grid = repro::blocks_for(n_points, repro::kMaxBlocksX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* mo = static_cast<unsigned char*>(mask);
  auto* xi = static_cast<const float*>(x);
  auto* hm = static_cast<const float*>(h);
  auto* l = static_cast<const float*>(lo);
  auto* u = static_cast<const float*>(hi);
  if (d == 2) {
    chain_project_1d_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, mo, xi, hm, l, u, n_points);
  } else if (d == 3) {
    chain_project_1d_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, mo, xi, hm, l, u, n_points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); mask: (B, L) bytes; h: (B, d+1, d+1); lo, hi: (B, d).
// Returns cudaGetLastError().
int chain_project_batch_2d(void* y, void* mask, const void* x, const void* h,
                           const void* lo, const void* hi, int64_t bsz,
                           int64_t len, int64_t d, void* stream) {
  if (bsz == 0 || len == 0) return 0;
  const dim3 grid(repro::blocks_for(len, repro::kMaxBlocksX),
                  repro::rows_for(bsz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* mo = static_cast<unsigned char*>(mask);
  auto* xi = static_cast<const float*>(x);
  auto* hm = static_cast<const float*>(h);
  auto* l = static_cast<const float*>(lo);
  auto* u = static_cast<const float*>(hi);
  if (d == 2) {
    chain_project_batch_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, mo, xi, hm, l, u, bsz, len);
  } else if (d == 3) {
    chain_project_batch_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, mo, xi, hm, l, u, bsz, len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
