// Folded diagonal transform chain: y[j] = s[c] * x[j] + t[c], c = j mod d.
//
// Replaces the TPU kernels chain_diag_1d and chain_diag_batch_2d of
// src/repro/kernels/affine/affine.py (the _chain_diag_kernel and
// _chain_diag_batch_kernel Pallas bodies).
//
// Bound on an H100: memory.  One pass reads the N*d float32 points once and
// writes them once: 2*N*d*4 bytes plus the parameters (2*d words for a
// single chain, 2*d per request for a batch), over 3.35 TB/s of HBM.  Two
// float operations per element are nothing next to that.
//
// Float contract: every element is __fadd_rn(__fmul_rn(x, s), t) -- a
// rounded multiply, then a rounded add, never contracted into an FMA.
// The plain PyTorch version (kernels/affine/ref.py) does the same two
// separately rounded ops, so kernel and plain version agree bit for bit,
// on the card and against the CPU.
//
// Design: this first version is one simple pass, one element per thread
// per grid-stride step, D templated so that j % D is a constant modulo.
// Vectorised 16-byte loads (awkward for d = 3, where a point straddles
// them) are later work.
#include "launch.cuh"

namespace {

template <int D>
__global__ void chain_diag_1d_kernel(float* __restrict__ y,
                                     const float* __restrict__ x,
                                     const float* __restrict__ s,
                                     const float* __restrict__ t,
                                     int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const int c = static_cast<int>(j % D);
    y[j] = __fadd_rn(__fmul_rn(x[j], s[c]), t[c]);
  }
}

// x, y: (B, L, D) packed; s, t: (B, D), row b meets request b's params.
template <int D>
__global__ void chain_diag_batch_kernel(float* __restrict__ y,
                                        const float* __restrict__ x,
                                        const float* __restrict__ s,
                                        const float* __restrict__ t,
                                        int64_t bsz, int64_t row) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    const float* sb = s + b * D;
    const float* tb = t + b * D;
    const int64_t base = b * row;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < row; i += stride) {
      const int c = static_cast<int>(i % D);
      y[base + i] = __fadd_rn(__fmul_rn(x[base + i], sb[c]), tb[c]);
    }
  }
}

}  // namespace

extern "C" {

// flat: (N*d,) points; s, t: (d,).  Returns cudaGetLastError().
int chain_diag_1d(void* y, const void* x, const void* s, const void* t,
                  int64_t n, int64_t d, void* stream) {
  if (n == 0) return 0;
  const unsigned grid = repro::blocks_for(n, repro::kMaxBlocksX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* si = static_cast<const float*>(s);
  auto* ti = static_cast<const float*>(t);
  if (d == 2) {
    chain_diag_1d_kernel<2><<<grid, repro::kThreads, 0, st>>>(yo, xi, si, ti, n);
  } else if (d == 3) {
    chain_diag_1d_kernel<3><<<grid, repro::kThreads, 0, st>>>(yo, xi, si, ti, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); s, t: (B, d).  Returns cudaGetLastError().
int chain_diag_batch_2d(void* y, const void* x, const void* s, const void* t,
                        int64_t bsz, int64_t len, int64_t d, void* stream) {
  if (bsz == 0 || len == 0) return 0;
  const int64_t row = len * d;
  const dim3 grid(repro::blocks_for(row, repro::kMaxBlocksX),
                  repro::rows_for(bsz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* si = static_cast<const float*>(s);
  auto* ti = static_cast<const float*>(t);
  if (d == 2) {
    chain_diag_batch_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, bsz, row);
  } else if (d == 3) {
    chain_diag_batch_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, bsz, row);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
