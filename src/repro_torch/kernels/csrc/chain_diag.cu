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
// Design:
//   * chain_diag_1d: one element a thread per int64 grid-stride step, D
//     templated so that j % D is a constant modulo.
//   * chain_diag_batch_2d, the server's bucket launch, has two kernels.
//     chain_diag_vec_kernel takes a launch whose row (L*d floats a
//     request) is a multiple of 4 and whose x and y lie on 16-byte
//     boundaries -- always so under the serving grid's default power-of-
//     two lengths -- so no 16-byte vector straddles two requests.  A
//     block serves one request (blockIdx.y, striding over B past 1024),
//     loads its d scales and shifts once into registers, and walks the
//     row as float4 vectors in chunks of kUnroll * kVecThreads vectors
//     (8 KB), neighbouring threads on neighbouring vectors, all loads of
//     a thread before its stores, over a grid of the blocks the card
//     holds at once (vecadd_vec_kernel's layout, the best of the layouts
//     measured for it; launch.cuh's walk_groups and row_grid).  Vector
//     v of a row starts at column 4v mod d: for d = 2 every vector is
//     two whole points, pattern (s0, s1, s0, s1); for d = 3 it starts at
//     column v mod 3 (4 = 1 mod 3), so the pattern is one of three,
//     picked by a 32-bit v % 3 (a multiply-high, no division) with
//     selects.  Three vectors a thread (four whole
//     points, a pattern fixed at compile time) was the other choice; it
//     gives each warp instruction a 48-byte stride and so sectors half
//     used, where the select costs a few integer instructions against a
//     budget of hundreds a vector at HBM's rate.  Offsets inside a row
//     are 32-bit (the C entry sends rows of 2**31 vectors and more to the
//     scalar kernel); 64-bit arithmetic is the request's base alone.
//     chain_diag_batch_kernel, one element a thread, takes every other
//     launch: a row of no multiple of 4 (a custom serving grid) or a base
//     off 16 bytes.
//   On an H100 (80GB HBM3, 700 W) at the largest served bucket, (48,
//   32768, 2), the scalar kernel's 12 288 blocks of one element a thread
//   took 0.0221 ms, 1.29x torch.addcmul; the vector kernel's 1 536
//   blocks take 0.0143 ms against addcmul's 0.0174 (1.76 TB/s), and at
//   the largest d = 3 bucket, (44, 32768, 3), 0.0190 against 0.0217:
//   the phase select costs no time there.  chip_smoke.py times both.
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

// the vectors a thread takes a chunk
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 diag4(const float4& x, float s0, float s1,
                                        float s2, float s3, float t0,
                                        float t1, float t2, float t3) {
  return make_float4(__fadd_rn(__fmul_rn(x.x, s0), t0),
                     __fadd_rn(__fmul_rn(x.y, s1), t1),
                     __fadd_rn(__fmul_rn(x.z, s2), t2),
                     __fadd_rn(__fmul_rn(x.w, s3), t3));
}

__device__ __forceinline__ float pick3(uint32_t c, const float* p) {
  return c == 0 ? p[0] : (c == 1 ? p[1] : p[2]);
}

// y = s (.) x + t on vector v of a request's row, s and t the request's
// D parameters in registers: lane k of the vector is column (4v + k) mod D.
template <int D>
__device__ __forceinline__ float4 diag_vec(const float4& x, uint32_t v,
                                           const float* s, const float* t) {
  if constexpr (D == 2) {
    return diag4(x, s[0], s[1], s[0], s[1], t[0], t[1], t[0], t[1]);
  } else {
    const uint32_t c0 = v % 3u;                    // 4v = v (mod 3)
    const uint32_t c1 = c0 == 2 ? 0 : c0 + 1;
    const uint32_t c2 = c0 == 0 ? 2 : c0 - 1;
    return diag4(x, pick3(c0, s), pick3(c1, s), pick3(c2, s), pick3(c0, s),
                 pick3(c0, t), pick3(c1, t), pick3(c2, t), pick3(c0, t));
  }
}

// x, y: (B, L, D) packed, row = L*D a multiple of 4 and nv = row / 4 < 2**31
// vectors a request, 16-byte-aligned bases; s, t: (B, D).
template <int D>
__global__ void __launch_bounds__(repro::kVecThreads)
chain_diag_vec_kernel(float* __restrict__ y, const float* __restrict__ x,
                      const float* __restrict__ s, const float* __restrict__ t,
                      int64_t bsz, uint32_t nv) {
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    float sb[D], tb[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      sb[c] = s[b * D + c];
      tb[c] = t[b * D + c];
    }
    const int64_t base = b * nv;                   // in vectors
    repro::walk_groups<1, kUnroll>(
        reinterpret_cast<float4*>(y) + base,
        reinterpret_cast<const float4*>(x) + base, nv,
        [&](float4* v, uint32_t i) { *v = diag_vec<D>(*v, i, sb, tb); });
  }
}

template <int D>
void launch_diag_vec(float* y, const float* x, const float* s, const float* t,
                     int64_t bsz, int64_t nv, int64_t waves,
                     cudaStream_t st) {
  static const int64_t resident =
      repro::resident_blocks(chain_diag_vec_kernel<D>, repro::kVecThreads);
  chain_diag_vec_kernel<D><<<
      repro::row_grid(resident, bsz, nv, kUnroll * repro::kVecThreads, waves),
      repro::kVecThreads, 0, st>>>(y, x, s, t, bsz,
                                   static_cast<uint32_t>(nv));
}

template <int D>
void launch_diag_1d(float* y, const float* x, const float* s, const float* t,
                    int64_t n, int threads, int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_diag_1d_kernel<D>);
  chain_diag_1d_kernel<D><<<res.grid(n, 1, threads, waves), threads, 0, st>>>(
      y, x, s, t, n);
}

template <int D>
void launch_diag_batch(float* y, const float* x, const float* s,
                       const float* t, int64_t bsz, int64_t row, int threads,
                       int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_diag_batch_kernel<D>);
  chain_diag_batch_kernel<D><<<res.grid(row, bsz, threads, waves), threads, 0,
                               st>>>(y, x, s, t, bsz, row);
}

}  // namespace

extern "C" {

// flat: (N*d,) points; s, t: (d,); threads, waves: the launch knobs
// (launch.cuh, 0 for the kernel's own choice).  Returns cudaGetLastError().
int chain_diag_1d(void* y, const void* x, const void* s, const void* t,
                  int64_t n, int64_t d, int64_t threads, int64_t waves,
                  void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* si = static_cast<const float*>(s);
  auto* ti = static_cast<const float*>(t);
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_diag_1d<2>(yo, xi, si, ti, n, bt, waves, st);
  } else {
    launch_diag_1d<3>(yo, xi, si, ti, n, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d); s, t: (B, d).  A row of L*d floats that is a multiple
// of 4 on 16-byte-aligned x and y takes the vector kernel (which reads
// `waves` only), any other launch the scalar one.  Returns
// cudaGetLastError().
int chain_diag_batch_2d(void* y, const void* x, const void* s, const void* t,
                        int64_t bsz, int64_t len, int64_t d, int64_t threads,
                        int64_t waves, void* stream) {
  if (!repro::knobs_ok(threads, waves) || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0 || len == 0) return 0;
  const int64_t row = len * d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<float*>(y);
  auto* xi = static_cast<const float*>(x);
  auto* si = static_cast<const float*>(s);
  auto* ti = static_cast<const float*>(t);
  if (row % 4 == 0 && row / 4 < (int64_t{1} << 31) &&
      repro::aligned16(y, x)) {
    if (d == 2) {
      launch_diag_vec<2>(yo, xi, si, ti, bsz, row / 4, waves, st);
    } else {
      launch_diag_vec<3>(yo, xi, si, ti, bsz, row / 4, waves, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_diag_batch<2>(yo, xi, si, ti, bsz, row, bt, waves, st);
  } else {
    launch_diag_batch<3>(yo, xi, si, ti, bsz, row, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
