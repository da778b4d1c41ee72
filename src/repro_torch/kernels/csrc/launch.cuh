// Shared launch geometry for the chain kernels.
//
// Every kernel is a grid-stride loop with int64 offsets, so any grid
// covers any size; the grid is capped so that a huge buffer does not
// launch millions of blocks that each do one element.  Batched kernels
// use a 2D grid: y walks the requests of a packed (B, L, d) batch, x walks
// the elements of one request's row, so no thread ever divides by the row
// length to find its request.
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

}  // namespace repro
