// Folded transform chains in the int16 Qm.n fixed-point lane:
//
//   diag:    q[j] = requant(x[j] * s[c] + (t[c] << n)),  c = j mod d
//   matrix:  q[c] = requant(sum_m p[m] * A[m][c] + (t[c] << n))
//   requant(acc) = wrap16((acc + 2^(n-1)) >> n)   (no add, no shift at n = 0)
//
// over int16 words, with a 32-bit accumulator that wraps and a store that
// wraps to 16 bits: the M1 RC array's integer datapath, never saturating.
//
// Replaces the TPU kernels chain_diag_1d_q, chain_matrix_1d_q,
// chain_diag_batch_2d_q and chain_matrix_batch_2d_q of
// src/repro/kernels/fixedpoint/fixedpoint.py (the _chain_diag_q_kernel,
// _chain_matrix_q_kernel, _chain_diag_batch_q_kernel and
// _chain_matrix_batch_q_kernel Pallas bodies).  The TPU kernels stage
// coefficient rows (_coef_rows) and roll lanes 2d-1 times because a TPU
// lane holds one coordinate; here one thread holds one element (diag) or
// one point (matrix), so there is nothing to stage or roll.
//
// Bound on an H100: memory.  One pass reads the int16 points once and
// writes them once, 2 bytes a coordinate: at 2^24 points that is 201.3 MB
// at d = 3 and 134.2 MB at d = 2, so 0.0601 ms and 0.0401 ms at 3.35 TB/s,
// half the float32 kernels' 0.1202 / 0.0801 ms.  A few integer operations
// a coordinate (at most 3 multiply-adds, a shift, an add) stay far below
// the card's int32 rate.
//
// Design: the float kernels' simple pass (one element or one point per
// thread per grid-stride step, D templated, a 2D grid with y = request
// for a batch), on half the bytes.  A warp's 2-byte accesses still cover
// one contiguous span, so every sector fetched is used; fewer bytes are
// in flight per thread than in the float kernels, which vectorised loads
// would fix in later work.
//
// Integer contract: signed overflow and left shifts of negative values are
// undefined in C++17, and the reference wraps by design.  So every
// multiply, add and shift here runs in uint32_t, where wrapping mod 2^32
// is defined and gives the bits of the wrapping int32 arithmetic.  The
// final shift is a logical one: for n <= 15 the sign bits that an
// arithmetic shift would fill in land in bits 32-n.. 31 >= 17, and the
// store keeps bits 0..15 only (uint16_t, defined modulo 2^16), which are
// bits n..n+15 of the sum either way.  The result is the reference's int16
// word, bit for bit, with no undefined or implementation-defined step.
#include "launch.cuh"

namespace {

// an int16 word sign-extended and reinterpreted as its 32-bit pattern
__device__ __forceinline__ uint32_t widen(int16_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

// (acc + round) >> n, the low 16 bits
__device__ __forceinline__ uint16_t requant(uint32_t acc, uint32_t round,
                                            int n) {
  return static_cast<uint16_t>((acc + round) >> n);
}

__device__ __forceinline__ uint32_t round_of(int n) {
  return n > 0 ? (1u << (n - 1)) : 0u;
}

template <int D>
__global__ void chain_diag_1d_q_kernel(uint16_t* __restrict__ y,
                                       const int16_t* __restrict__ x,
                                       const int16_t* __restrict__ s,
                                       const int16_t* __restrict__ t,
                                       int64_t n_elems, int n) {
  const uint32_t round = round_of(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n_elems; j += stride) {
    const int c = static_cast<int>(j % D);
    const uint32_t acc = widen(x[j]) * widen(s[c]) + (widen(t[c]) << n);
    y[j] = requant(acc, round, n);
  }
}

// x, y: (B, L, D) packed; s, t: (B, D), row b meets request b's words.
template <int D>
__global__ void chain_diag_batch_q_kernel(uint16_t* __restrict__ y,
                                          const int16_t* __restrict__ x,
                                          const int16_t* __restrict__ s,
                                          const int16_t* __restrict__ t,
                                          int64_t bsz, int64_t row, int n) {
  const uint32_t round = round_of(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    const int16_t* sb = s + b * D;
    const int16_t* tb = t + b * D;
    const int64_t base = b * row;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < row; i += stride) {
      const int c = static_cast<int>(i % D);
      const uint32_t acc = widen(x[base + i]) * widen(sb[c])
                           + (widen(tb[c]) << n);
      y[base + i] = requant(acc, round, n);
    }
  }
}

template <int D>
__device__ __forceinline__ void point_apply_q(uint16_t* __restrict__ q,
                                              const int16_t* __restrict__ p,
                                              const int16_t* __restrict__ a,
                                              const int16_t* __restrict__ t,
                                              uint32_t round, int n) {
  uint32_t v[D];
#pragma unroll
  for (int m = 0; m < D; ++m) v[m] = widen(p[m]);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    uint32_t acc = widen(t[c]) << n;
#pragma unroll
    for (int m = 0; m < D; ++m) acc += v[m] * widen(a[m * D + c]);
    q[c] = requant(acc, round, n);
  }
}

template <int D>
__global__ void chain_matrix_1d_q_kernel(uint16_t* __restrict__ y,
                                         const int16_t* __restrict__ x,
                                         const int16_t* __restrict__ a,
                                         const int16_t* __restrict__ t,
                                         int64_t n_points, int n) {
  const uint32_t round = round_of(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_points; i += stride) {
    point_apply_q<D>(y + i * D, x + i * D, a, t, round, n);
  }
}

// x, y: (B, L, D) packed; a: (B, D, D); t: (B, D).
template <int D>
__global__ void chain_matrix_batch_q_kernel(uint16_t* __restrict__ y,
                                            const int16_t* __restrict__ x,
                                            const int16_t* __restrict__ a,
                                            const int16_t* __restrict__ t,
                                            int64_t bsz, int64_t len, int n) {
  const uint32_t round = round_of(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    const int16_t* ab = a + b * D * D;
    const int16_t* tb = t + b * D;
    const int64_t base = b * len * D;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < len; i += stride) {
      point_apply_q<D>(y + base + i * D, x + base + i * D, ab, tb, round, n);
    }
  }
}

bool bad_frac(int64_t n_frac) { return n_frac < 0 || n_frac > 15; }

}  // namespace

extern "C" {

// flat: (N*d,) int16 words; s, t: (d,).  Returns cudaGetLastError().
int chain_diag_1d_q(void* y, const void* x, const void* s, const void* t,
                    int64_t n_elems, int64_t d, int64_t n_frac, void* stream) {
  if (bad_frac(n_frac)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_elems == 0) return 0;
  const unsigned grid = repro::blocks_for(n_elems, repro::kMaxBlocksX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* si = static_cast<const int16_t*>(s);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  if (d == 2) {
    chain_diag_1d_q_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, n_elems, n);
  } else if (d == 3) {
    chain_diag_1d_q_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, n_elems, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d) int16 words; s, t: (B, d).  Returns cudaGetLastError().
int chain_diag_batch_2d_q(void* y, const void* x, const void* s, const void* t,
                          int64_t bsz, int64_t len, int64_t d, int64_t n_frac,
                          void* stream) {
  if (bad_frac(n_frac)) return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0 || len == 0) return 0;
  const int64_t row = len * d;
  const dim3 grid(repro::blocks_for(row, repro::kMaxBlocksX),
                  repro::rows_for(bsz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* si = static_cast<const int16_t*>(s);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  if (d == 2) {
    chain_diag_batch_q_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, bsz, row, n);
  } else if (d == 3) {
    chain_diag_batch_q_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, si, ti, bsz, row, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// flat: (N*d,) int16 words; a: (d, d); t: (d,).  Returns cudaGetLastError().
int chain_matrix_1d_q(void* y, const void* x, const void* a, const void* t,
                      int64_t n_points, int64_t d, int64_t n_frac,
                      void* stream) {
  if (bad_frac(n_frac)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  const unsigned grid = repro::blocks_for(n_points, repro::kMaxBlocksX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* ai = static_cast<const int16_t*>(a);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  if (d == 2) {
    chain_matrix_1d_q_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, n_points, n);
  } else if (d == 3) {
    chain_matrix_1d_q_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, n_points, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d) int16 words; a: (B, d, d); t: (B, d).
// Returns cudaGetLastError().
int chain_matrix_batch_2d_q(void* y, const void* x, const void* a,
                            const void* t, int64_t bsz, int64_t len, int64_t d,
                            int64_t n_frac, void* stream) {
  if (bad_frac(n_frac)) return static_cast<int>(cudaErrorInvalidValue);
  if (bsz == 0 || len == 0) return 0;
  const dim3 grid(repro::blocks_for(len, repro::kMaxBlocksX),
                  repro::rows_for(bsz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* ai = static_cast<const int16_t*>(a);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  if (d == 2) {
    chain_matrix_batch_q_kernel<2><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, bsz, len, n);
  } else if (d == 3) {
    chain_matrix_batch_q_kernel<3><<<grid, repro::kThreads, 0, st>>>(
        yo, xi, ai, ti, bsz, len, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
