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

inline unsigned rows_for(int64_t rows) {
  return static_cast<unsigned>(rows < kMaxBlocksY ? rows : kMaxBlocksY);
}

}  // namespace repro
