// The pair layout of K7 (budget_adc_grouped.cu), built on the card in two
// launches.
//
// A budget probe's (query, slot) pairs, flat and query-major (pair i = b*P +
// p probes tile tiles[i]), are grouped by tile: group g holds up to `rows`
// pairs, pairs[g, :] (-1 on an unused slot), that all probe tile tog[g]. Ids
// outside the table [0, n_tiles) share one bucket, whose groups get tile id
// n_tiles (outside the table: K7 writes +inf for them). Each bucket takes
// ceil(count / rows) consecutive groups, in bucket order, and fills them from
// their first slot, so a group's real slots come first; the groups after the
// last bucket's are padding (tile n_tiles - 1, every slot -1). With nb
// nonempty buckets that is at most ceil(bp / rows) + nb - 1 <= ceil(bp /
// rows) + n_tiles groups, the count the wrapper allocates.
//
// Counterpart of _group_probe_layout (postgres_word2vec_tpu/ops/
// pallas_kernels.py), which sorts the pairs by tile and scatters them into
// the groups. Nothing is sorted here:
// 1. count (budget_pair_count_kernel): block k takes a chunk of the pairs,
//    counts them by bucket in shared memory and writes its counts to row k
//    of `hist`; each pair keeps its rank among its block's pairs of its
//    bucket, from the atomic add that counted it. All blocks together also
//    set every slot of `pairs` to -1, in coalesced stores;
// 2. place (budget_pair_place_kernel): every block sums the columns of
//    `hist` (a bucket a thread, all rows' loads in flight at once), scans
//    the buckets' group counts, and writes each of its pairs to slot (first
//    group of its bucket) * rows + (its bucket's pairs in earlier blocks) +
//    rank; block 0 also writes tog.
// Which pairs share a group, and in which order, depends on the order of the
// atomics; no value does, since K7 sums each pair alone.
//
// What bounds it: short chains of dependent loads over a few thousand pairs,
// not bytes. On an H100 at the 100k join's plan, a single block that did
// all three steps took 0.036 ms, and a place step whose block 0 also wrote
// -1 into every unused slot, each thread its buckets' runs one store after
// another (scattered stores, a sector each, from one SM), 0.025-0.028. Here
// each block counts one chunk, a pair a thread, a warp's pairs of one bucket
// meeting in one atomic (match.any), every load of a step is issued before
// any is used, and the unused slots are cleared by the whole grid in
// coalesced stores before any pair is placed: 0.0026 ms to count, 0.0076 to
// place, on the same card and plan. The counts stay in shared memory where
// n_tiles + 1 of them fit, else in the block's own rows of device memory.
#include "adc_common.cuh"
#include "budget_common.cuh"

#define LAYOUT_THREADS 1024
#define LAYOUT_MAX_BLOCKS 32
// The most buckets whose counts (two ints each when placing) a block keeps
// in shared memory.
#define LAYOUT_SMEM_BUCKETS (160 * 1024 / 8)

// Pairs a block takes: whole multiples of its threads, at most
// LAYOUT_MAX_BLOCKS blocks.
static inline int layout_chunk(int bp) {
  const int per = (bp + LAYOUT_MAX_BLOCKS - 1) / LAYOUT_MAX_BLOCKS;
  return (per + LAYOUT_THREADS - 1) / LAYOUT_THREADS * LAYOUT_THREADS;
}

__device__ __forceinline__ int layout_bucket(const int* __restrict__ tiles,
                                             int i, int n_tiles) {
  const int t = tiles[i];
  return budget_tile_ok(t, n_tiles) ? t : n_tiles;
}

__global__ void __launch_bounds__(LAYOUT_THREADS)
budget_pair_count_kernel(const int* __restrict__ tiles, int* hist,
                         int* __restrict__ rank, int* __restrict__ pairs,
                         int bp, int n_tiles, int chunk, int slots) {
  extern __shared__ int cnt_s[];
  const unsigned full = 0xffffffffu;
  const int nb = n_tiles + 1;
  const bool in_smem = nb <= LAYOUT_SMEM_BUCKETS;
  int* row = hist + (long long)blockIdx.x * nb;
  int* cnt = in_smem ? cnt_s : row;
  const int lane = threadIdx.x & 31;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < slots;
       s += gridDim.x * blockDim.x)
    pairs[s] = -1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const int i0 = blockIdx.x * chunk;
  const int i1 = min(bp, i0 + chunk);
  for (int w0 = i0 + (threadIdx.x & ~31); w0 < i1; w0 += blockDim.x) {
    const int i = w0 + lane;
    const int b = i < i1 ? layout_bucket(tiles, i, n_tiles) : -1;
    const unsigned same = __match_any_sync(full, b);
    const int leader = __ffs(same) - 1;
    int base = 0;
    if (b >= 0 && lane == leader) base = atomicAdd(cnt + b, __popc(same));
    base = __shfl_sync(full, base, leader);
    if (b >= 0) rank[i] = base + __popc(same & ((1u << lane) - 1u));
  }
  if (in_smem) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) row[b] = cnt_s[b];
  }
}

__global__ void __launch_bounds__(LAYOUT_THREADS)
budget_pair_place_kernel(const int* __restrict__ tiles,
                         const int* __restrict__ hist,
                         const int* __restrict__ rank,
                         int* __restrict__ pairs, int* __restrict__ tog,
                         int* spill, int bp, int n_tiles, int groups,
                         int rows, int chunk) {
  extern __shared__ int sums_s[];
  __shared__ int warp_s[LAYOUT_THREADS / 32];
  __shared__ int total_s;
  const unsigned full = 0xffffffffu;
  const int nb = n_tiles + 1;
  const int nblk = gridDim.x;
  const int blk = blockIdx.x;
  // each bucket's pairs, and the first slot of this block's share of it
  int* tot = nb <= LAYOUT_SMEM_BUCKETS ? sums_s
                                       : spill + (long long)blk * 2 * nb;
  int* base = tot + nb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // The column sums of hist, a bucket a thread, every row's load in flight
  // at once.
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int t = 0, pre = 0;
#pragma unroll
    for (int k = 0; k < LAYOUT_MAX_BLOCKS; ++k) {
      if (k < nblk) {
        const int c = hist[(long long)k * nb + b];
        t += c;
        if (k < blk) pre += c;
      }
    }
    tot[b] = t;
    base[b] = pre;
  }
  __syncthreads();
  // Scan: thread t takes buckets [b0, b1); its groups start at g.
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int b0 = min(nb, (int)threadIdx.x * per);
  const int b1 = min(nb, b0 + per);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += (tot[b] + rows - 1) / rows;
  int incl = mine;
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(full, incl, s);
    if (lane >= s) incl += v;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? warp_s[lane] : 0;
    int wi = w;
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(full, wi, s);
      if (lane >= s) wi += v;
    }
    if (lane < nwarps) warp_s[lane] = wi - w;
  }
  __syncthreads();
  int g = warp_s[warp] + incl - mine;
  for (int b = b0; b < b1; ++b) {
    const int ng = (tot[b] + rows - 1) / rows;
    base[b] += g * rows;
    if (blk == 0)
      for (int q = 0; q < ng; ++q) tog[g + q] = b;  // n_tiles: outside
    g += ng;
  }
  if (threadIdx.x == blockDim.x - 1) total_s = g;
  __syncthreads();
  if (blk == 0)  // the padding groups (their slots are -1 already)
    for (int q = total_s + threadIdx.x; q < groups; q += blockDim.x)
      tog[q] = n_tiles - 1;
  const int i1 = min(bp, blk * chunk + chunk);
  for (int i = blk * chunk + threadIdx.x; i < i1; i += blockDim.x)
    pairs[base[layout_bucket(tiles, i, n_tiles)] + rank[i]] = i;
}

// Scratch the layout needs, in ints of device memory.
extern "C" int pw2v_budget_pair_layout_scratch(int bp, int n_tiles) {
  if (bp < 1 || n_tiles < 1) return -1;
  const long long nb = n_tiles + 1;
  const long long nblk = (bp + layout_chunk(bp) - 1) / layout_chunk(bp);
  const long long n = nblk * nb * (nb <= LAYOUT_SMEM_BUCKETS ? 1 : 3) + bp;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// tiles: bp int32 tile ids; pairs (groups * rows) and tog (groups) int32
// out; scratch: pw2v_budget_pair_layout_scratch(bp, n_tiles) ints of device
// memory. groups must be at least ceil(bp / rows) + n_tiles.
extern "C" int pw2v_budget_pair_layout(const void* tiles, void* pairs,
                                       void* tog, void* scratch, int bp,
                                       int n_tiles, int groups, int rows,
                                       void* stream) {
  if (bp < 1 || n_tiles < 1 || rows < 1 ||
      groups < (bp + rows - 1) / rows + n_tiles ||
      (long long)groups * rows > 0x7fffffffLL ||
      pw2v_budget_pair_layout_scratch(bp, n_tiles) < 0)
    return cudaErrorInvalidValue;
  const int nb = n_tiles + 1;
  const int chunk = layout_chunk(bp);
  const int nblk = (bp + chunk - 1) / chunk;
  const bool in_smem = nb <= LAYOUT_SMEM_BUCKETS;
  const size_t smem = in_smem ? (size_t)nb * sizeof(int) : 0;
  int* hist = static_cast<int*>(scratch);
  int* rank = hist + (long long)nblk * nb;
  int* spill = rank + bp;  // used only where the sums leave shared memory
  cudaError_t err = adc_allow_smem(budget_pair_count_kernel, smem);
  if (err == cudaSuccess)
    err = adc_allow_smem(budget_pair_place_kernel, 2 * smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tiles);
  budget_pair_count_kernel<<<nblk, LAYOUT_THREADS, smem, s>>>(
      t, hist, rank, static_cast<int*>(pairs), bp, n_tiles, chunk,
      groups * rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  budget_pair_place_kernel<<<nblk, LAYOUT_THREADS, 2 * smem, s>>>(
      t, hist, rank, static_cast<int*>(pairs), static_cast<int*>(tog),
      spill, bp, n_tiles, groups, rows, chunk);
  return cudaGetLastError();
}
