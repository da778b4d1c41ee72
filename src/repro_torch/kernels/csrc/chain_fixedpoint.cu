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
// whole points (matrix), so there are no coefficient rows and no rolls.
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
// one contiguous span, so every sector fetched is used, but few bytes
// are in flight per thread: at the largest q bucket, (15, 65536, 2), the
// matrix batch kernel moved 7.87 MB in 0.01030 ms on an H100 80GB HBM3
// (700 W), 0.76 TB/s, and the diag batch kernel, an int64 i % D an
// element, 0.01869 ms at (36, 32768, 2), 1.56x a device copy of the
// same bytes (PERF.md).  So both batch kernels have a second kernel.
//
// chain_matrix_batch_2d_q's, chain_matrix_batch_q_vec_kernel, is for a
// launch whose row (L*d words a request) is a multiple of 8 on
// 16-byte-aligned x and y -- always so under the serving grid's
// default power-of-two lengths -- so no 16-byte vector straddles two
// requests.  A block serves one request (blockIdx.y, striding over B
// past 1024), loads its d*d matrix words (widened) and its d shifts
// (already shifted by n) once into registers, and walks the row in
// contiguous chunks of kUnroll * kVecThreads groups (4 groups a thread
// at d = 2, 1 at d = 3) over a grid of the blocks the card holds at once
// (launch.cuh's row_grid).  A group is whole points: for d = 2 one
// vector of 8 words, 4 points, read and written straight; for d = 3
// three vectors, 24 words, 8 points (3 L a multiple of 8 makes L one),
// and a warp's 32 groups go through shared memory: the warp reads its 96
// vectors lane by lane (each load instruction 512 contiguous bytes),
// lane l takes slots 3l .. 3l + 2, computes its 8 points and puts them
// back, and the warp writes them out lane by lane.  No point is split
// between threads, so no column pattern is needed.  Offsets inside a row
// are 32-bit (the C entry sends rows of 2**31 vectors and more to the
// scalar kernel).  On an H100 80GB HBM3
// (700 W) the d = 2 bucket above takes 0.78-0.79x a device copy of the
// same bytes (PERF.md).
//
// chain_diag_batch_2d_q's, chain_diag_batch_q_vec_kernel, takes the same
// launches (rows of a multiple of 8 words on 16-byte-aligned x and y)
// with chain_diag_vec_kernel's layout (chain_diag.cu): a block a request,
// its d widened scales and d shifts -- each t << n with the rounding
// constant already added, the same bits mod 2**32 as adding them apart --
// once in registers, contiguous chunks of kDiagUnroll * kVecThreads
// vectors of 8 words, all loads of a thread before its stores, a
// one-wave grid.
// Word k of vector v is on column (8v + k) mod d: for d = 2 every vector
// has the pattern (s0, s1) x 4; for d = 3 vector v starts at column
// 8v mod 3 = 2v mod 3, one of three patterns, picked by a 32-bit v % 3
// (a multiply-high, no division) and selects.  No int64 division or
// modulo is left on the element path.  On an H100 80GB HBM3 (700 W) it
// takes 0.0094-0.0096 ms at (36, 32768, 2), 0.83-0.85x a device copy of
// the same bytes, where the scalar kernel took 0.0187 (PERF.md).
//
// Both int16 kernels write out the chunked walk that launch.cuh's
// walk_groups holds for the float kernels: through walk_groups they took
// 3-4 % longer on an H100 80GB HBM3 (700 W) -- the same instructions but
// for their address arithmetic and order (PERF.md).
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

using repro::kVecThreads;
constexpr int kWarps = kVecThreads / 32;
// the groups a thread takes a chunk: 4 vectors at d = 2; at d = 3 one
// group of 3, the fastest of 1, 2 and 4 on an H100 (and 40 registers
// where 4 took 80 with a spill)
template <int D>
constexpr int kUnroll = D == 2 ? 4 : 1;

// a 16-bit pattern h < 2^16 sign-extended to 32 bits, in uint32_t (no
// narrowing conversion of an out-of-range value)
__device__ __forceinline__ uint32_t sext16(uint32_t h) {
  return (h ^ 0x8000u) - 0x8000u;
}

// Word i of V 16-byte vectors held as their 4 V 32-bit parts (word 0 at
// the lowest address), sign-extended to its 32-bit pattern.
__device__ __forceinline__ uint32_t word_of(const uint32_t* u, int i) {
  return sext16((u[i >> 1] >> (16 * (i & 1))) & 0xffffu);
}

// The 8V / D whole points held in V vectors, in place: a (D*D words,
// widened) and tn (the D shifts, widened and shifted by n) in registers.
// Each result goes straight into its half of an output part.
template <int D, int V>
__device__ __forceinline__ void matrix_q_vecs(uint4* v, const uint32_t* a,
                                              const uint32_t* tn,
                                              uint32_t round, int n) {
  constexpr int kW = 8 * V;
  uint32_t in[4 * V], out[4 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    in[4 * k] = v[k].x;
    in[4 * k + 1] = v[k].y;
    in[4 * k + 2] = v[k].z;
    in[4 * k + 3] = v[k].w;
    out[4 * k] = out[4 * k + 1] = out[4 * k + 2] = out[4 * k + 3] = 0u;
  }
#pragma unroll
  for (int p = 0; p < kW; p += D) {
    uint32_t w[D];
#pragma unroll
    for (int m = 0; m < D; ++m) w[m] = word_of(in, p + m);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      uint32_t acc = tn[c];
#pragma unroll
      for (int m = 0; m < D; ++m) acc += w[m] * a[m * D + c];
      const int i = p + c;
      out[i >> 1] |= static_cast<uint32_t>(requant(acc, round, n))
                     << (16 * (i & 1));
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = make_uint4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                      out[4 * k + 3]);
}

// x, y: (B, L, D) packed int16 words, row = L*D a multiple of 8 (D = 3: of
// 24) under 2**31 vectors, 16-byte-aligned bases; a: (B, D, D); t: (B, D).
// ng = groups a row, a group V 16-byte vectors of whole points.
template <int D>
__global__ void __launch_bounds__(kVecThreads)
chain_matrix_batch_q_vec_kernel(uint16_t* __restrict__ y,
                                const int16_t* __restrict__ x,
                                const int16_t* __restrict__ a,
                                const int16_t* __restrict__ t, int64_t bsz,
                                uint32_t ng, int n) {
  constexpr int V = D == 2 ? 1 : 3;
  constexpr int kU = kUnroll<D>;
  constexpr uint32_t kChunk = kU * kVecThreads;   // groups a chunk
  __shared__ uint4 stage[V == 1 ? 1 : kWarps][kU][V == 1 ? 1 : 32 * V];
  const uint32_t round = round_of(n);
  const uint32_t nv = ng * V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    uint32_t ab[D * D], tn[D];
#pragma unroll
    for (int k = 0; k < D * D; ++k) ab[k] = widen(a[b * D * D + k]);
#pragma unroll
    for (int c = 0; c < D; ++c) tn[c] = widen(t[b * D + c]) << n;
    const uint4* xv = reinterpret_cast<const uint4*>(x) + b * nv;
    uint4* yv = reinterpret_cast<uint4*>(y) + b * nv;
    if constexpr (V == 1) {
      for (uint32_t c = blockIdx.x * kChunk + threadIdx.x; c < ng;
           c += gridDim.x * kChunk) {
        uint4 r[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint32_t g = c + u * kVecThreads;
          if (g < ng) r[u] = xv[g];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint32_t g = c + u * kVecThreads;
          if (g < ng) {
            matrix_q_vecs<D, 1>(&r[u], ab, tn, round, n);
            yv[g] = r[u];
          }
        }
      }
    } else {
      for (uint32_t c = blockIdx.x * kChunk; c < ng; c += gridDim.x * kChunk) {
        // step u: this warp's 32 groups from g0 = c + 128 u + 32 warp, i.e.
        // 32 V vectors from g0 * V, read lane by lane into shared memory
        uint4 r[kU][V];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint32_t v0 = (c + u * kVecThreads + warp * 32) * V;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const uint32_t v = v0 + k * 32 + lane;
            if (v < nv) r[u][k] = xv[v];
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int k = 0; k < V; ++k) stage[warp][u][k * 32 + lane] = r[u][k];
        }
        __syncwarp();
        // lane l takes group g0 + l, slots l V .. l V + V - 1, and puts its
        // points back in their place
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint32_t g = c + u * kVecThreads + warp * 32 + lane;
          if (g < ng) {
            uint4 p[V];
#pragma unroll
            for (int k = 0; k < V; ++k) p[k] = stage[warp][u][lane * V + k];
            matrix_q_vecs<D, V>(p, ab, tn, round, n);
#pragma unroll
            for (int k = 0; k < V; ++k) stage[warp][u][lane * V + k] = p[k];
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint32_t v0 = (c + u * kVecThreads + warp * 32) * V;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const uint32_t v = v0 + k * 32 + lane;
            if (v < nv) yv[v] = stage[warp][u][k * 32 + lane];
          }
        }
        __syncwarp();
      }
    }
  }
}

template <int D>
void launch_matrix_q_vec(uint16_t* y, const int16_t* x, const int16_t* a,
                         const int16_t* t, int64_t bsz, int64_t ng, int n,
                         int64_t waves, cudaStream_t st) {
  static const int64_t resident = repro::resident_blocks(
      chain_matrix_batch_q_vec_kernel<D>, kVecThreads);
  chain_matrix_batch_q_vec_kernel<D><<<
      repro::row_grid(resident, bsz, ng, kUnroll<D> * kVecThreads, waves),
      kVecThreads, 0, st>>>(y, x, a, t, bsz, static_cast<uint32_t>(ng), n);
}

// the vectors a thread of chain_diag_batch_q_vec_kernel takes a chunk
constexpr int kDiagUnroll = 4;

// requant(x * s + tr) for the int16 word x held in the low 16 bits of h
// (the rest 0), tr = (t << n) + round: the low 16 bits of the result
__device__ __forceinline__ uint32_t diag_word(uint32_t h, uint32_t s,
                                              uint32_t tr, int n) {
  return ((sext16(h) * s + tr) >> n) & 0xffffu;
}

__device__ __forceinline__ uint32_t pick3(uint32_t c, const uint32_t* p) {
  return c == 0 ? p[0] : (c == 1 ? p[1] : p[2]);
}

// The 8 words of vector v of a request's row: word k on column
// (8v + k) mod D, s (widened) and tr (t << n, plus the rounding constant)
// the request's D words in registers.
template <int D>
__device__ __forceinline__ uint4 diag_q_vec(const uint4& x, uint32_t v,
                                            const uint32_t* s,
                                            const uint32_t* tr, int n) {
  // the columns of words 0, 1, 2 of the vector; word k is on word k mod D's
  uint32_t sc[3], tc[3];
  if constexpr (D == 2) {
    sc[0] = sc[2] = s[0];
    sc[1] = s[1];
    tc[0] = tc[2] = tr[0];
    tc[1] = tr[1];
  } else {
    const uint32_t r = v % 3u;
    const uint32_t c0 = r == 0 ? 0 : 3 - r;         // 8v = 2v (mod 3)
    const uint32_t c1 = c0 == 2 ? 0 : c0 + 1;
    const uint32_t c2 = c0 == 0 ? 2 : c0 - 1;
    sc[0] = pick3(c0, s);
    sc[1] = pick3(c1, s);
    sc[2] = pick3(c2, s);
    tc[0] = pick3(c0, tr);
    tc[1] = pick3(c1, tr);
    tc[2] = pick3(c2, tr);
  }
  const uint32_t in[4] = {x.x, x.y, x.z, x.w};
  uint32_t out[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int lo = (2 * h) % D, hi = (2 * h + 1) % D;
    out[h] = diag_word(in[h] & 0xffffu, sc[lo], tc[lo], n)
             | (diag_word(in[h] >> 16, sc[hi], tc[hi], n) << 16);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// x, y: (B, L, D) packed int16 words, row = L*D a multiple of 8 and nv =
// row / 8 < 2**31 vectors a request, 16-byte-aligned bases; s, t: (B, D).
template <int D>
__global__ void __launch_bounds__(kVecThreads)
chain_diag_batch_q_vec_kernel(uint16_t* __restrict__ y,
                              const int16_t* __restrict__ x,
                              const int16_t* __restrict__ s,
                              const int16_t* __restrict__ t, int64_t bsz,
                              uint32_t nv, int n) {
  constexpr uint32_t kChunk = kDiagUnroll * kVecThreads;
  const uint32_t round = round_of(n);
  for (int64_t b = blockIdx.y; b < bsz; b += gridDim.y) {
    uint32_t sb[D], tr[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      sb[c] = widen(s[b * D + c]);
      tr[c] = (widen(t[b * D + c]) << n) + round;
    }
    const uint4* xv = reinterpret_cast<const uint4*>(x) + b * nv;
    uint4* yv = reinterpret_cast<uint4*>(y) + b * nv;
    for (uint32_t c = blockIdx.x * kChunk + threadIdx.x; c < nv;
         c += gridDim.x * kChunk) {
      uint4 r[kDiagUnroll];
#pragma unroll
      for (int u = 0; u < kDiagUnroll; ++u) {
        const uint32_t v = c + u * kVecThreads;
        if (v < nv) r[u] = xv[v];
      }
#pragma unroll
      for (int u = 0; u < kDiagUnroll; ++u) {
        const uint32_t v = c + u * kVecThreads;
        if (v < nv) yv[v] = diag_q_vec<D>(r[u], v, sb, tr, n);
      }
    }
  }
}

template <int D>
void launch_diag_q_vec(uint16_t* y, const int16_t* x, const int16_t* s,
                       const int16_t* t, int64_t bsz, int64_t nv, int n,
                       int64_t waves, cudaStream_t st) {
  static const int64_t resident = repro::resident_blocks(
      chain_diag_batch_q_vec_kernel<D>, kVecThreads);
  chain_diag_batch_q_vec_kernel<D><<<
      repro::row_grid(resident, bsz, nv, kDiagUnroll * kVecThreads, waves),
      kVecThreads, 0, st>>>(y, x, s, t, bsz, static_cast<uint32_t>(nv), n);
}

// The scalar kernels' launches over their Residency (launch.cuh's knobs).
template <int D>
void launch_diag_1d_q(uint16_t* y, const int16_t* x, const int16_t* s,
                      const int16_t* t, int64_t n_elems, int n, int threads,
                      int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_diag_1d_q_kernel<D>);
  chain_diag_1d_q_kernel<D><<<res.grid(n_elems, 1, threads, waves), threads,
                              0, st>>>(y, x, s, t, n_elems, n);
}

template <int D>
void launch_diag_batch_q(uint16_t* y, const int16_t* x, const int16_t* s,
                         const int16_t* t, int64_t bsz, int64_t row, int n,
                         int threads, int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_diag_batch_q_kernel<D>);
  chain_diag_batch_q_kernel<D><<<res.grid(row, bsz, threads, waves), threads,
                                 0, st>>>(y, x, s, t, bsz, row, n);
}

template <int D>
void launch_matrix_1d_q(uint16_t* y, const int16_t* x, const int16_t* a,
                        const int16_t* t, int64_t n_points, int n,
                        int threads, int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_matrix_1d_q_kernel<D>);
  chain_matrix_1d_q_kernel<D><<<res.grid(n_points, 1, threads, waves),
                                threads, 0, st>>>(y, x, a, t, n_points, n);
}

template <int D>
void launch_matrix_batch_q(uint16_t* y, const int16_t* x, const int16_t* a,
                           const int16_t* t, int64_t bsz, int64_t len, int n,
                           int threads, int64_t waves, cudaStream_t st) {
  static repro::Residency res(chain_matrix_batch_q_kernel<D>);
  chain_matrix_batch_q_kernel<D><<<res.grid(len, bsz, threads, waves),
                                   threads, 0, st>>>(y, x, a, t, bsz, len, n);
}

// A C entry's arguments it cannot take: a fraction count outside 0..15,
// launch knobs launch.cuh refuses, d other than 2 or 3.
bool bad_args(int64_t n_frac, int64_t d, int64_t threads, int64_t waves) {
  return n_frac < 0 || n_frac > 15 || !repro::knobs_ok(threads, waves) ||
         (d != 2 && d != 3);
}

}  // namespace

extern "C" {

// flat: (N*d,) int16 words; s, t: (d,); threads, waves: the launch knobs
// (launch.cuh, 0 for the kernel's own choice).  Returns
// cudaGetLastError().
int chain_diag_1d_q(void* y, const void* x, const void* s, const void* t,
                    int64_t n_elems, int64_t d, int64_t n_frac,
                    int64_t threads, int64_t waves, void* stream) {
  if (bad_args(n_frac, d, threads, waves)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_elems == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* si = static_cast<const int16_t*>(s);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac), bt = repro::threads_of(threads);
  if (d == 2) {
    launch_diag_1d_q<2>(yo, xi, si, ti, n_elems, n, bt, waves, st);
  } else {
    launch_diag_1d_q<3>(yo, xi, si, ti, n_elems, n, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d) int16 words; s, t: (B, d).  A row of L*d words that
// is a multiple of 8 on 16-byte-aligned x and y takes the vector kernel
// (which reads `waves` only), any other launch the scalar one.  Returns
// cudaGetLastError().
int chain_diag_batch_2d_q(void* y, const void* x, const void* s, const void* t,
                          int64_t bsz, int64_t len, int64_t d, int64_t n_frac,
                          int64_t threads, int64_t waves, void* stream) {
  if (bad_args(n_frac, d, threads, waves)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0 || len == 0) return 0;
  const int64_t row = len * d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* si = static_cast<const int16_t*>(s);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  if (row % 8 == 0 && row / 8 < (int64_t{1} << 31) &&
      repro::aligned16(y, x)) {
    if (d == 2) {
      launch_diag_q_vec<2>(yo, xi, si, ti, bsz, row / 8, n, waves, st);
    } else {
      launch_diag_q_vec<3>(yo, xi, si, ti, bsz, row / 8, n, waves, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_diag_batch_q<2>(yo, xi, si, ti, bsz, row, n, bt, waves, st);
  } else {
    launch_diag_batch_q<3>(yo, xi, si, ti, bsz, row, n, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// flat: (N*d,) int16 words; a: (d, d); t: (d,); threads, waves: the
// launch knobs.  Returns cudaGetLastError().
int chain_matrix_1d_q(void* y, const void* x, const void* a, const void* t,
                      int64_t n_points, int64_t d, int64_t n_frac,
                      int64_t threads, int64_t waves, void* stream) {
  if (bad_args(n_frac, d, threads, waves)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_points == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* ai = static_cast<const int16_t*>(a);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac), bt = repro::threads_of(threads);
  if (d == 2) {
    launch_matrix_1d_q<2>(yo, xi, ai, ti, n_points, n, bt, waves, st);
  } else {
    launch_matrix_1d_q<3>(yo, xi, ai, ti, n_points, n, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (B, L, d) int16 words; a: (B, d, d); t: (B, d).  A row of L*d
// words that is a multiple of 8 on 16-byte-aligned x and y takes the
// vector kernel (which reads `waves` only), any other launch the scalar
// one.  Returns cudaGetLastError().
int chain_matrix_batch_2d_q(void* y, const void* x, const void* a,
                            const void* t, int64_t bsz, int64_t len, int64_t d,
                            int64_t n_frac, int64_t threads, int64_t waves,
                            void* stream) {
  if (bad_args(n_frac, d, threads, waves)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0 || len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yo = static_cast<uint16_t*>(y);
  auto* xi = static_cast<const int16_t*>(x);
  auto* ai = static_cast<const int16_t*>(a);
  auto* ti = static_cast<const int16_t*>(t);
  const int n = static_cast<int>(n_frac);
  const int64_t row = len * d;
  if (row % 8 == 0 && row / 8 < (int64_t{1} << 31) &&
      repro::aligned16(y, x)) {
    // d = 3: 3 L = 0 mod 8 makes L a multiple of 8, the row one of 24
    if (d == 2) {
      launch_matrix_q_vec<2>(yo, xi, ai, ti, bsz, row / 8, n, waves, st);
    } else {
      launch_matrix_q_vec<3>(yo, xi, ai, ti, bsz, row / 24, n, waves, st);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bt = repro::threads_of(threads);
  if (d == 2) {
    launch_matrix_batch_q<2>(yo, xi, ai, ti, bsz, len, n, bt, waves, st);
  } else {
    launch_matrix_batch_q<3>(yo, xi, ai, ti, bsz, len, n, bt, waves, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
