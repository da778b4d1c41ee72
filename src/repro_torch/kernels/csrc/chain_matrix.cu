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
// Design:
//   * chain_matrix_1d: one point per thread per int64 grid-stride step, D
//     templated so the d*d loop unrolls; a warp's loads of 32 consecutive
//     points cover one contiguous span.
//   * chain_matrix_batch_2d, the server's bucket launch, has two kernels.
//     chain_matrix_batch_kernel (one point a thread, 4-byte accesses, the
//     request's A and t read through pointers for every point) was the
//     first version: at the largest served bucket, (47, 32768, 2), it
//     took 0.01520 ms on an H100 80GB HBM3 (700 W), 48 % of its bound.
//     chain_matrix_batch_vec_kernel takes a launch whose row holds whole
//     groups (L even at d = 2, a multiple of 4 at d = 3) on 16-byte-
//     aligned x and y -- always so under the serving grid's default
//     power-of-two lengths from 8 -- so no 16-byte vector straddles two
//     requests and no point two vectors of a thread.  A block serves one
//     request (blockIdx.y, striding over B past 1024), loads its d*d + d
//     parameters once into registers and walks the row in contiguous
//     chunks of kUnroll * kVecThreads groups over a grid of the blocks
//     the card holds at once, all loads of a thread before its stores
//     (launch.cuh's walk_groups and row_grid).  A group is whole points:
//     for d = 2 one float4, 2 points, read and written straight; for d =
//     3 three float4, 12 floats, 4 points, and a warp's 32 groups go
//     through shared memory: the warp reads its 96 vectors lane by lane
//     (each load instruction 512 contiguous bytes, where a lane's own
//     three vectors would give a 48-byte stride), lane l computes its 4
//     points with point_apply's arithmetic on registers and puts them
//     back, and the warp writes them out lane by lane.  Offsets inside a
//     row are 32-bit (the C entry sends rows of 2**31 vectors and more to
//     the scalar kernel); 64-bit arithmetic is the request's base alone.
//     chain_matrix_batch_kernel takes every other launch: a custom
//     grid's odd length, a base off 16 bytes.
//   On an H100 80GB HBM3 (700 W) the vector kernel takes 0.0139-0.0140
//   ms at (47, 32768, 2), 0.80-0.82x a device copy of the same bytes,
//   and 0.0116-0.0118 ms at the largest d = 3 bucket, (20, 32768, 3),
//   0.86-0.88x (PERF.md).
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

// the groups a thread takes a chunk: 4 vectors at d = 2; at d = 3 one
// group of 3 vectors, as chain_matrix_batch_q_vec_kernel's d = 3 groups
// (2 and 4 took the same time on an H100, 4 at 101 registers)
template <int D>
constexpr int kUnroll = D == 2 ? 4 : 1;

// The 4V / D whole points held in V float4 vectors, in place: a (D*D)
// and t (D) in registers, point_apply's order of rounded ops.
template <int D, int V>
__device__ __forceinline__ void matrix_vecs(float4* v, const float* a,
                                            const float* t) {
  float in[4 * V], out[4 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    in[4 * k] = v[k].x;
    in[4 * k + 1] = v[k].y;
    in[4 * k + 2] = v[k].z;
    in[4 * k + 3] = v[k].w;
  }
#pragma unroll
  for (int p = 0; p < 4 * V; p += D) point_apply<D>(out + p, in + p, a, t);
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                       out[4 * k + 3]);
}

// x, y: (B, L, D) packed floats, L even (D = 2) or a multiple of 4 (D =
// 3), row / 4 < 2**31 vectors, 16-byte-aligned bases; a: (B, D, D); t:
// (B, D).  ng = groups a row, a group V float4 vectors of whole points.
template <int D>
__global__ void __launch_bounds__(repro::kVecThreads)
chain_matrix_batch_vec_kernel(float* __restrict__ y,
                              const float* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ t, int64_t bsz,
                              uint32_t ng) {
  constexpr int V = D == 2 ? 1 : 3;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    float ab[D * D], tb[D];
#pragma unroll
    for (int k = 0; k < D * D; ++k) ab[k] = a[b * D * D + k];
#pragma unroll
    for (int c = 0; c < D; ++c) tb[c] = t[b * D + c];
    const int64_t base = b * ng * V;               // in vectors
    repro::walk_groups<V, kUnroll<D>>(
        reinterpret_cast<float4*>(y) + base,
        reinterpret_cast<const float4*>(x) + base, ng,
        [&](float4* p, uint32_t) { matrix_vecs<D, V>(p, ab, tb); });
  }
}

template <int D>
void launch_matrix_vec(float* y, const float* x, const float* a,
                       const float* t, int64_t bsz, int64_t ng, int64_t waves,
                       cudaStream_t st) {
  static const int64_t resident = repro::resident_blocks(
      chain_matrix_batch_vec_kernel<D>, repro::kVecThreads);
  chain_matrix_batch_vec_kernel<D><<<
      repro::row_grid(resident, bsz, ng, kUnroll<D> * repro::kVecThreads,
                      waves),
      repro::kVecThreads, 0, st>>>(y, x, a, t, bsz,
                                   static_cast<uint32_t>(ng));
}

template <int D>
void launch_matrix_1d(float* y, const float* x, const float* a,
                      const float* t, int64_t n_points, int threads,
                      int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_matrix_1d_kernel<D>);
  chain_matrix_1d_kernel<D><<<res.grid(n_points, 1, threads, waves), threads,
                              0, st>>>(y, x, a, t, n_points);
}

template <int D>
void launch_matrix_batch(float* y, const float* x, const float* a,
                         const float* t, int64_t bsz, int64_t len,
                         int threads, int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_matrix_batch_kernel<D>);
  chain_matrix_batch_kernel<D><<<res.grid(len, bsz, threads, waves), threads,
                                 0, st>>>(y, x, a, t, bsz, len);
}

}  // namespace

extern "C" {

// flat: (N*d,) points; a: (d, d); t: (d,); threads, waves: the launch
// knobs (launch.cuh, 0 for the kernel's own choice).  Returns
// cudaGetLastError().
int chain_matrix_1d(void* y, const void* x, const void* a, const void* t,
                    int64_t n_points, int64_t d, int64_t threads,
                    int64_t waves, void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_points == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* ai = static_cast<const float*>(a);
  auto* ti = static_cast<const float*>(t);
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_matrix_1d<2>(yo, xi, ai, ti, n_points, bt, waves, st);
  } else {
    launch_matrix_1d<3>(yo, xi, ai, ti, n_points, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); a: (B, d, d); t: (B, d).  A row of whole groups (L
// even at d = 2, a multiple of 4 at d = 3) on 16-byte-aligned x and y
// takes the vector kernel (which reads `waves` only), any other launch
// the scalar one.  Returns cudaGetLastError().
int chain_matrix_batch_2d(void* y, const void* x, const void* a, const void* t,
                          int64_t bsz, int64_t len, int64_t d,
                          int64_t threads, int64_t waves, void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0 || len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* ai = static_cast<const float*>(a);
  auto* ti = static_cast<const float*>(t);
  const int64_t row = len * d;
  if (len % (d == 2 ? 2 : 4) == 0 && row / 4 < (int64_t{1} << 31) &&
      repro::aligned16(y, x)) {
    if (d == 2) {
      launch_matrix_vec<2>(yo, xi, ai, ti, bsz, row / 4, waves, st);
    } else {
      launch_matrix_vec<3>(yo, xi, ai, ti, bsz, row / 12, waves, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_matrix_batch<2>(yo, xi, ai, ti, bsz, len, bt, waves, st);
  } else {
    launch_matrix_batch<3>(yo, xi, ai, ti, bsz, len, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
