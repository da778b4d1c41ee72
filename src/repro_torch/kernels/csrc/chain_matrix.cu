// Folded general transform chain: q = p @ A + t for (N, d) points,
// A (d, d), t (d,), row-vector convention.
//
// Replaces the TPU kernels chain_matrix_1d and chain_matrix_batch_2d of
// src/repro/kernels/matmul/matmul.py (the _chain_matrix_kernel and
// _chain_matrix_batch_kernel Pallas bodies, 2d-1 lane-rolled multiply-adds).
//
// Bound on an H100: memory.  One pass reads the N*d float32 points once and
// writes them once: 2*N*d*4 bytes plus the parameters (d*d + d words per
// chain, per request for a batch), over 3.35 TB/s of HBM.  2*d*d float
// operations per point stay far below the card's float32 rate.
//
// Operation order (the float contract): each output coordinate c is
//
//   acc = p0 * A[0][c]; acc = acc + p1 * A[1][c]; ...; q[c] = acc + t[c]
//
// with every multiply and add a separately rounded __fmul_rn / __fadd_rn,
// never contracted into an FMA.  This is the order of the reference's
// plain oracle (src/repro/kernels/matmul/ref.py, chain_matrix: the
// products summed over m, then t added last), NOT that of the reference
// Pallas kernel, which starts its accumulator at t.  The plain PyTorch
// version (kernels/matmul/ref.py) runs the same sequence of rounded ops,
// so kernel and plain version agree bit for bit.
//
// Design: this first version is one simple pass, one point per thread per
// grid-stride step, D templated so the d*d loop unrolls; a warp's loads of
// 32 consecutive points cover one contiguous span.  Vectorised 16-byte
// loads (a d = 3 point straddles them) are later work.
#include "launch.cuh"

namespace {

template <int D>
__device__ __forceinline__ void point_apply(float* __restrict__ q,
                                            const float* __restrict__ p,
                                            const float* __restrict__ a,
                                            const float* __restrict__ t) {
  float v[D];
#pragma unroll
  for (int m = 0; m < D; ++m) v[m] = p[m];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float acc = __fmul_rn(v[0], a[c]);
#pragma unroll
    for (int m = 1; m < D; ++m) acc = __fadd_rn(acc, __fmul_rn(v[m], a[m * D + c]));
    q[c] = __fadd_rn(acc, t[c]);
  }
}

template <int D>
__global__ void chain_matrix_1d_kernel(float* __restrict__ y,
                                       const float* __restrict__ x,
                                       const float* __restrict__ a,
                                       const float* __restrict__ t,
                                       int64_t n_points) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_points; i += stride) {
    point_apply<D>(y + i * D, x + i * D, a, t);
  }
}

// x, y: (B, L, D) packed; a: (B, D, D); t: (B, D).
template <int D>
__global__ void chain_matrix_batch_kernel(float* __restrict__ y,
                                          const float* __restrict__ x,
                                          const float* __restrict__ a,
                                          const float* __restrict__ t,
                                          int64_t bsz, int64_t len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    const float* ab = a + b * D * D;
    const float* tb = t + b * D;
    const int64_t base = b * len * D;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < len; i += stride) {
      point_apply<D>(y + base + i * D, x + base + i * D, ab, tb);
    }
  }
}

}  // namespace

extern "C" {

// flat: (N*d,) points; a: (d, d); t: (d,).  Returns cudaGetLastError().
int chain_matrix_1d(void* y, const void* x, const void* a, const void* t,
                    int64_t n_points, int64_t d, void* stream) {
  if (n_points == 0) return 0;
  const unsigned grid = repro::blocks_for(n_points, repro::kMaxBlocksX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* ai = static_cast<const float*>(a);
  auto* ti = static_cast<const float*>(t);
  if (d == 2) {
    chain_matrix_1d_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, n_points);
  } else if (d == 3) {
    chain_matrix_1d_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, n_points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); a: (B, d, d); t: (B, d).  Returns cudaGetLastError().
int chain_matrix_batch_2d(void* y, const void* x, const void* a, const void* t,
                          int64_t bsz, int64_t len, int64_t d, void* stream) {
  if (bsz == 0 || len == 0) return 0;
  const dim3 grid(repro::blocks_for(len, repro::kMaxBlocksX),
                  repro::rows_for(bsz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* ai = static_cast<const float*>(a);
  auto* ti = static_cast<const float*>(t);
  if (d == 2) {
    chain_matrix_batch_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, bsz, len);
  } else if (d == 3) {
    chain_matrix_batch_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, bsz, len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
