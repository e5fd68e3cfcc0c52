// Shared pieces of the four budget kernels (budget_adc*.cu, budget_exact*.cu).
//
// A budget probe scans, per query, P tiles of block_t rows of a cell-aligned
// table (rows of one cell padded to whole tiles, one trailing all-padding
// "inf tile"). The tile ids are an int32 (B, P) tensor on the device that the
// kernels read directly. An id outside [0, n_tiles) is treated as the inf
// tile: its rows come out +inf and nothing outside the table is read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BUDGET_THREADS 256
// Blocks a per-query launch aims for: a block owns one query and up to
// BUDGET_MAX_SPB of its slots, so its staged LUT or query is reused across
// that many tiles, and small batches still spread over the card's 132 SMs.
#define BUDGET_TARGET_BLOCKS 2048
#define BUDGET_MAX_SPB 8

__device__ __forceinline__ float budget_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool budget_tile_ok(int tile, int n_tiles) {
  return tile >= 0 && tile < n_tiles;
}

// Slots per block of a per-query launch over B queries x P slots.
static inline int budget_slots_per_block(int B, int P) {
  long long spb = ((long long)B * P + BUDGET_TARGET_BLOCKS - 1) /
                  BUDGET_TARGET_BLOCKS;
  if (spb < 1) spb = 1;
  if (spb > BUDGET_MAX_SPB) spb = BUDGET_MAX_SPB;
  return (int)spb;
}

// Shape checks common to every budget entry point.
static inline bool budget_shape_ok(long long na, int block_t) {
  return block_t >= 1 && na >= block_t && na % block_t == 0 &&
         na / block_t <= 0x7fffffffLL;
}
