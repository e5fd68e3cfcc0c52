// Shared pieces of the five budget kernels (budget_adc*.cu, budget_exact*.cu).
//
// A budget probe scans, per query, P tiles of block_t rows of a cell-aligned
// table (rows of one cell padded to whole tiles, one trailing all-padding
// "inf tile"). The tile ids are an int32 (B, P) tensor on the device that the
// kernels read directly. An id outside [0, n_tiles) is treated as the inf
// tile: its rows come out +inf and nothing outside the table is read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define BUDGET_THREADS 256
// Blocks a per-query launch of K9 aims for: a block owns one query and up to
// BUDGET_MAX_SPB of its slots, so its staged query is reused across that
// many tiles, and small batches still spread over the card's 132 SMs.
#define BUDGET_TARGET_BLOCKS 2048
#define BUDGET_MAX_SPB 8

__device__ __forceinline__ float budget_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool budget_tile_ok(int tile, int n_tiles) {
  return tile >= 0 && tile < n_tiles;
}

// Slots per block of a per-query launch over B queries x P slots that aims
// for target_blocks blocks of at most max_spb slots.
static inline int budget_slots_per_block(int B, int P, int target_blocks,
                                         int max_spb) {
  long long spb = ((long long)B * P + target_blocks - 1) / target_blocks;
  if (spb < 1) spb = 1;
  if (spb > max_spb) spb = max_spb;
  return (int)spb;
}

// Shape checks common to every budget entry point.
static inline bool budget_shape_ok(long long na, int block_t) {
  return block_t >= 1 && na >= block_t && na % block_t == 0 &&
         na / block_t <= 0x7fffffffLL;
}

// ----------------------------------------------------------- the inf tile
//
// Plans are padded with the table's last tile, the inf tile. True if that
// tile's row terms are all +inf, so that a probe of it gives +inf whatever
// the LUT (whose sums are finite) and needs no copy and no sums. The loads
// go through L1, so an SM reads the tile from L2 once. Call with every thread
// of the block; the answer is the same for all of them.
__device__ __forceinline__ bool budget_last_tile_is_inf(
    const float* __restrict__ rowterm, int n_tiles, int block_t) {
  const float* term = rowterm + (long long)(n_tiles - 1) * block_t;
  int finite = 0;
  for (int r = threadIdx.x; r < block_t; r += blockDim.x)
    finite |= __ldg(term + r) != budget_inf();
  return !__syncthreads_or(finite);
}

// ------------------------------------------------- grouped kernels: slots
//
// A group's real slots come first (the layout fills a group from its first
// slot). → the index of its last real slot plus one, 0 for a padding group.
// Every warp reads the group's rows ids, 32 a load, and takes the answer from
// one ballot, so no thread loops over the slots and no barrier is needed.
// Call with every thread of the block.
__device__ __forceinline__ int budget_used_slots(const int* __restrict__ q_of,
                                                 int rows, int B) {
  const int lane = threadIdx.x & 31;
  int used = 0;
  for (int c0 = 0; c0 < rows; c0 += 32) {
    const int qi = c0 + lane < rows ? q_of[c0 + lane] : -1;
    const unsigned real = __ballot_sync(0xffffffffu, qi >= 0 && qi < B);
    if (real) used = c0 + 32 - __clz(real);
  }
  return used;
}

// ------------------------------------------------ code tiles by bulk copy
//
// A tile's codes are m runs of block_t codes, one per subspace, and block_t
// floats of the row term. They go to shared memory by bulk copies (TMA)
// when every run of `rows` codes (a whole tile, or the part of one that a
// kernel copies at a time) starts 16-byte aligned and is a multiple of 16
// bytes, else by plain copies.
static inline int budget_bulk_tiles(const void* codes_t, const void* rowterm,
                                    long long na, int block_t, int rows,
                                    int cb) {
  return reinterpret_cast<uintptr_t>(codes_t) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(rowterm) % 16 == 0 &&
         (na * cb) % 16 == 0 && ((long long)block_t * cb) % 16 == 0 &&
         (rows * cb) % 16 == 0 && block_t % 4 == 0 && rows % 4 == 0;
}

// Copy rows [row0, row0 + rows) of the table to shared memory: the m code
// runs to code_s (run j at code_s + j*stride, stride >= rows and a multiple
// of 16 bytes) and, where term_s is not null, the row terms to term_s. Call
// with every one of the `threads` threads that share the copy (whole warps:
// a block, or a group of one), thread `tid` of them. With `bulk` their first
// warp asks for the runs, one lane a run, and the bytes count down the
// mbarrier `bar`: mbar_wait(bar, phase) says when they are there. Without,
// every thread copies its share, which is there once their barrier has
// passed.
template <typename CodeT>
__device__ __forceinline__ void budget_copy_rows(
    CodeT* code_s, float* term_s, const CodeT* __restrict__ codes_t,
    const float* __restrict__ rowterm, long long na, int m, long long row0,
    int rows, int stride, int bulk, uint32_t bar, int tid, int threads) {
  if (bulk) {
    if (tid >= 32) return;
    const uint32_t run = rows * (uint32_t)sizeof(CodeT);
    const uint32_t term = term_s != nullptr ? rows * (uint32_t)sizeof(float)
                                            : 0u;
    if (tid == 0) mbar_expect_tx(bar, m * run + term);
    __syncwarp();
    for (int j = tid; j < m; j += 32)
      bulk_copy(adc_smem_addr(code_s + (size_t)j * stride),
                codes_t + (long long)j * na + row0, run, bar);
    if (tid == 0 && term_s != nullptr)
      bulk_copy(adc_smem_addr(term_s), rowterm + row0, term, bar);
  } else {
    for (int i = tid; i < m * rows; i += threads) {
      const int j = i / rows;
      const int r = i - j * rows;
      code_s[(size_t)j * stride + r] = codes_t[(long long)j * na + row0 + r];
    }
    if (term_s != nullptr)
      for (int i = tid; i < rows; i += threads) term_s[i] = rowterm[row0 + i];
  }
}

__host__ __device__ inline size_t budget_round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Bytes of one ring unit: `rows` row terms, then the m code runs, `stride`
// codes apart.
__host__ __device__ inline size_t budget_unit_bytes(int m, int rows,
                                                    int stride, int cb) {
  return budget_round16((size_t)rows * sizeof(float)) +
         budget_round16((size_t)m * stride * cb);
}
