// Shared launch geometry for the chain kernels.
//
// Every kernel is a grid-stride loop with int64 offsets, so any grid
// covers any size; the grid is capped so that a huge buffer does not
// launch millions of blocks that each do one element.  Batched kernels
// use a 2D grid: y walks the requests of a packed (B, L, d) batch, x walks
// the elements of one request's row, so no thread ever divides by the row
// length to find its request.
//
// The 16-byte batch kernels of chain_diag.cu, chain_matrix.cu and
// chain_fixedpoint.cu share one layout: a block row a request, whose row
// of 16-byte vectors a block of kVecThreads threads walks in contiguous
// chunks over a one-wave grid (row_grid).  The float kernels take the
// walk from walk_groups; the int16 ones write it out (chain_fixedpoint.cu
// says why).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 4096;
constexpr int64_t kMaxBlocksY = 1024;

inline unsigned blocks_for(int64_t work, int64_t cap) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < cap ? b : cap);
}

// A float handed over as the int64 of its float32 bits (the C entries
// take pointers and int64 sizes only).
inline float f32_from_bits(int64_t bits) {
  const uint32_t u = static_cast<uint32_t>(bits);
  float f;
  __builtin_memcpy(&f, &u, sizeof f);
  return f;
}

inline unsigned rows_for(int64_t rows) {
  return static_cast<unsigned>(rows < kMaxBlocksY ? rows : kMaxBlocksY);
}

// Whether every pointer lies on a 16-byte boundary: the condition of the
// kernels that load and store 16-byte vectors.
template <typename... P>
inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) % 16) == 0;
}

// The blocks of `threads` threads of `kernel` that the card holds at once
// (its SMs times the blocks an SM takes at the kernel's registers): a
// grid of that size runs in one wave.  Callers keep it in a static.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// The block of the 16-byte batch kernels.
constexpr int kVecThreads = 128;

// The grid of a 16-byte batch kernel over B requests of `units` each,
// walked in chunks of `chunk`: x the chunks of a row, capped so that the
// whole grid is one wave of `resident` blocks; y the requests, striding
// over B past kMaxBlocksY.
inline dim3 row_grid(int64_t resident, int64_t bsz, int64_t units,
                     int64_t chunk) {
  const unsigned gy = rows_for(bsz);
  int64_t gx = (units + chunk - 1) / chunk;
  const int64_t cap = resident / gy > 1 ? resident / gy : 1;
  if (gx > cap) gx = cap;
  return dim3(static_cast<unsigned>(gx), gy);
}

// One request's row of ng groups, a group V 16-byte vectors (Vec: float4
// or uint4), walked by a block of kVecThreads threads in contiguous
// chunks of kU * kVecThreads groups, block x taking chunks x, x +
// gridDim.x, ...; every load of a thread comes before its stores.
// fn(group, g) turns group g's V vectors into its results in place.
//   * V = 1: thread t takes groups c + t + u * kVecThreads, u < kU,
//     read and written straight.
//   * V > 1 (groups of whole points that straddle vectors): step u's 32
//     groups of a warp, from g0 = c + u * kVecThreads + 32 * warp, are
//     its 32 V vectors from g0 V, read lane by lane into shared memory
//     (each load instruction 512 contiguous bytes, where a lane's own
//     vectors would give a stride of 16 V bytes); lane l takes slots
//     l V .. l V + V - 1, its group, and puts the results back; the warp
//     writes them out lane by lane.
// Offsets are 32-bit: the caller holds ng * V under 2**31.
template <int V, int kU, typename Vec, typename Fn>
__device__ __forceinline__ void walk_groups(Vec* __restrict__ y,
                                            const Vec* __restrict__ x,
                                            uint32_t ng, Fn fn) {
  constexpr uint32_t kChunk = kU * kVecThreads;   // groups a chunk
  if constexpr (V == 1) {
    for (uint32_t c = blockIdx.x * kChunk + threadIdx.x; c < ng;
         c += gridDim.x * kChunk) {
      Vec r[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t g = c + u * kVecThreads;
        if (g < ng) r[u] = x[g];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t g = c + u * kVecThreads;
        if (g < ng) {
          fn(&r[u], g);
          y[g] = r[u];
        }
      }
    }
  } else {
    __shared__ Vec stage[kVecThreads / 32][kU][32 * V];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t nv = ng * V;
    for (uint32_t c = blockIdx.x * kChunk; c < ng; c += gridDim.x * kChunk) {
      Vec r[kU][V];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t v0 = (c + u * kVecThreads + warp * 32) * V;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const uint32_t v = v0 + k * 32 + lane;
          if (v < nv) r[u][k] = x[v];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) stage[warp][u][k * 32 + lane] = r[u][k];
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t g = c + u * kVecThreads + warp * 32 + lane;
        if (g < ng) fn(&stage[warp][u][lane * V], g);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t v0 = (c + u * kVecThreads + warp * 32) * V;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const uint32_t v = v0 + k * 32 + lane;
          if (v < nv) y[v] = stage[warp][u][k * 32 + lane];
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace repro
