// Shared pieces of the ADC kernels.
//
// - The query-major layout (K6 budget_adc.cu, K7 budget_adc_grouped.cu):
//   the LUTs of up to ADC_MAX_QB queries, one thread per code row, one
//   accumulator per staged query (adc_stage_luts, adc_row).
// - The query-minor walk (K2 adc_scan.cu, K3 adc_scan_int8.cu, K4
//   adc_scan_binned.cu, K5 adc_scan_binned_int8.cu): adc_walk with a lookup
//   policy (AdcF32, AdcU8) and an epilogue (AdcDense here, K4's and K5's
//   bin mins in their own files).
// - int8 LUTs query-minor, one thread per row (K8): adc_i8_*.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ADC_THREADS 256
#define ADC_MAX_QB 8
// Shared memory a block may take for staged LUTs. Two such blocks fit on
// one SM (227 KB); one query's LUT alone may use up to ADC_SMEM_MAX.
#define ADC_SMEM_TARGET (96 * 1024)
#define ADC_SMEM_MAX (227 * 1024)

// Queries staged per block for an (m, k) codebook: as many as fit in
// ADC_SMEM_TARGET, at least one and at most ADC_MAX_QB. 0 when one query's
// LUT does not fit in a block's shared memory at all.
static inline int adc_query_block(int m, int k) {
  const long long per_query = (long long)m * k * (long long)sizeof(float);
  if (per_query > ADC_SMEM_MAX) return 0;
  long long qb = ADC_SMEM_TARGET / per_query;
  if (qb < 1) qb = 1;
  if (qb > ADC_MAX_QB) qb = ADC_MAX_QB;
  return (int)qb;
}

// Copy the (nq, m, k) LUT block of queries [b0, b0 + nq) into shared memory.
__device__ __forceinline__ void adc_stage_luts(float* lut_s,
                                               const float* __restrict__ luts,
                                               int b0, int nq, int mk) {
  const float* src = luts + (long long)b0 * mk;
  for (int i = threadIdx.x; i < nq * mk; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();
}

// ADC sums of code row n for the nq staged queries, summed over subspaces
// j = 0 .. m-1 in order (the order of the plain version, so float32 results
// agree bit for bit).
template <typename CodeT>
__device__ __forceinline__ void adc_row(float (&acc)[ADC_MAX_QB],
                                        const float* lut_s,
                                        const CodeT* __restrict__ codes,
                                        long long n, long long N, int m,
                                        int k, int nq) {
  const int mk = m * k;
#pragma unroll
  for (int q = 0; q < ADC_MAX_QB; ++q) acc[q] = 0.f;
  for (int j = 0; j < m; ++j) {
    const int c = (int)codes[(long long)j * N + n];
    const float* e = lut_s + j * k + c;
#pragma unroll
    for (int q = 0; q < ADC_MAX_QB; ++q)
      if (q < nq) acc[q] += e[q * mk];
  }
}

// Raise the block's dynamic shared-memory limit where a launch needs more
// than the default 48 KB; without it the launch is refused and never runs.
template <typename Kernel>
static inline cudaError_t adc_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ------------------------------------------------------ the query-minor walk
//
// A block stages the LUTs of QB queries query-minor: entry r = j*k + c of
// the QB queries is one contiguous run (QB floats, or QB biased bytes), so
// one 16-, 8- or 4-byte shared load fetches one lookup for F queries. L =
// QB/F neighbouring threads (a thread group) share one code row and read one
// entry together, each its own F queries; a quarter-warp's 16-byte loads
// then touch two 64-byte entries, at most a two-way bank conflict.
//
// Rows come in slabs of `slab` steps of ADC_ROWS rows: group j owns rows
// j + s*ADC_ROWS of a slab. A block walks whole tiles of block_n rows (K4's
// bins; the dense kernels take one slab per tile), tile blockIdx.x, then +
// gridDim.x, ...; the query block is blockIdx.y. The slabs' codes reach
// shared memory by cp.async, double-buffered, so the copy of the next slab
// overlaps the lookups of this one. Each row's sum runs over subspaces
// j = 0..m-1 in order (the plain version's order, so float32 sums agree bit
// for bit). The epilogue decides what a finished row becomes.

#define ADC_ROWS 128  // rows per slab step: one per thread group
#define ADC_WAVES 4   // blocks launched per SM slot, for balance

__device__ __forceinline__ uint32_t adc_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bytes of QB staged LUTs, rounded up so what follows is 16-byte aligned.
__host__ __device__ inline size_t adc_lut_bytes(int qb, int mk, int elem) {
  return ((size_t)qb * mk * elem + 15) / 16 * 16;
}

// Shared memory of a walk block: the staged LUTs (lut_bytes) and two code
// slabs.
static inline size_t adc_walk_smem(size_t lut_bytes, int m, int cb,
                                   int slab) {
  return (lut_bytes + 15) / 16 * 16 + 2 * (size_t)m * slab * ADC_ROWS * cb;
}

// Steps per slab: the largest of 8, 4, 2 and 1 that divides `steps` and
// fits; 0 if none does.
static inline int adc_walk_slab(size_t lut_bytes, int m, int cb, int steps) {
  for (int slab = 8; slab >= 1; slab /= 2)
    if (steps % slab == 0 &&
        adc_walk_smem(lut_bytes, m, cb, slab) <= ADC_SMEM_MAX)
      return slab;
  return 0;
}

// Queries per block: the largest of qb_max, qb_max/2, ..., qb_min whose
// LUTs (lut_per_query bytes each) fit beside two one-step code slabs; 0 if
// none does.
static inline int adc_walk_query_block(int qb_max, int qb_min,
                                       size_t lut_per_query, int m, int cb) {
  for (int qb = qb_max; qb >= qb_min; qb /= 2)
    if (adc_walk_smem(qb * lut_per_query, m, cb, 1) <= ADC_SMEM_MAX)
      return qb;
  return 0;
}

// Blocks along the rows: ADC_WAVES per SM slot over the gy query blocks,
// at most one per tile.
static inline cudaError_t adc_walk_blocks(size_t smem, int threads,
                                          long long gy, long long n_tiles,
                                          unsigned* gx) {
  if (gy > 65535) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long per_sm = (long long)(ADC_SMEM_MAX / smem);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  if (per_sm < 1) per_sm = 1;
  long long x = ((long long)sms * per_sm * ADC_WAVES + gy - 1) / gy;
  if (x > n_tiles) x = n_tiles;  // n_tiles < 2^31: N is a long long of rows
  *gx = (unsigned)x;
  return cudaSuccess;
}

// Codes go by cp.async when every subspace run starts 16-byte aligned.
static inline int adc_async_codes(const void* codes, long long N, int cb) {
  return reinterpret_cast<uintptr_t>(codes) % 16 == 0 && (N * cb) % 16 == 0;
}

// Walk this block's tiles; for every row of group j (threadIdx.x / L) sum
// the lookups into `look` and hand it to epi.row(look, s), s the row's step
// within its tile. epi.tile_begin(tile) comes before a tile's first slab,
// epi.tile_end(tile) after its last, behind a __syncthreads.
template <int L, typename CodeT, typename Look, typename Epi>
__device__ __forceinline__ void adc_walk(Look& look, Epi& epi,
                                         const CodeT* __restrict__ codes,
                                         CodeT* code_s, int m, int k,
                                         long long N, int block_n,
                                         long long n_tiles, int slab,
                                         int async_codes) {
  const int rows = slab * ADC_ROWS;  // rows of one slab
  const size_t slab_elems = (size_t)m * rows;
  const int slabs = block_n / rows;  // slabs of one tile
  const int j = threadIdx.x / L;     // this thread's group
  // This block's tiles: blockIdx.x, + gridDim.x, ... (gridDim.x <= n_tiles)
  const long long n_slabs =
      ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * slabs;
  auto tile_of = [&](long long p) {
    return (long long)blockIdx.x + (p / slabs) * gridDim.x;
  };

  // Copy slab p (m subspace runs of `rows` codes) into buffer p % 2. Rows
  // past N are never read, so they are not copied.
  auto stage = [&](long long p) {
    CodeT* dst = code_s + (p & 1) * slab_elems;
    const long long row0 = tile_of(p) * block_n + (p % slabs) * rows;
    if (async_codes) {
      const int per = rows * (int)sizeof(CodeT) / 16;
      const long long left = (N - row0) * (long long)sizeof(CodeT);
      for (int i = threadIdx.x; i < m * per; i += blockDim.x) {
        const int jj = i / per;
        const long long off = (long long)(i - jj * per) * 16;
        if (off >= left) continue;
        cp_async16(adc_smem_addr(reinterpret_cast<char*>(dst + (size_t)jj *
                                                               rows) + off),
                   reinterpret_cast<const char*>(codes + (long long)jj * N +
                                                 row0) + off,
                   (int)min(16LL, left - off));
      }
    } else {  // codes not 16-byte aligned per subspace: plain copies
      for (int i = threadIdx.x; i < m * rows; i += blockDim.x) {
        const int jj = i / rows;
        const long long n = row0 + (i - jj * rows);
        if (n < N) dst[i] = codes[(long long)jj * N + n];
      }
    }
    cp_async_commit();
  };

  if (n_slabs > 0) stage(0);
  for (long long p = 0; p < n_slabs; ++p) {
    if (p + 1 < n_slabs) {
      stage(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long tile = tile_of(p);
    const int sl = (int)(p % slabs);
    if (sl == 0) epi.tile_begin(tile);
    const CodeT* cs = code_s + (p & 1) * slab_elems + j;
    const long long row0 = tile * block_n + (long long)sl * rows + j;
    for (int ss = 0; ss < slab; ++ss) {
      if (row0 + ss * ADC_ROWS >= N) break;  // rows grow: the rest is padding
      look.clear();
      const CodeT* cr = cs + ss * ADC_ROWS;
#pragma unroll 4
      for (int jj = 0; jj < m; ++jj)
        look.add(jj * k + (int)cr[(size_t)jj * rows]);
      epi.row(look, sl * slab + ss);
    }
    __syncthreads();  // every thread is done with buffer p % 2
    if (sl == slabs - 1) epi.tile_end(tile);
  }
}

// ------------------------------------------------- float32 lookups (K2, K4)
//
// A thread keeps F of the QB queries (four when QB >= 4), and L = QB / F
// neighbouring threads share one code row.
template <int QB>
struct AdcF32 {
  static constexpr int F = QB >= 4 ? 4 : QB;  // queries a thread keeps
  static constexpr int L = QB / F;            // threads that share a row
  const float* lut_s;
  int v;  // this thread's queries: v*F .. v*F + F-1
  float acc[F];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = 0.f;
  }

  // acc[i] += staged lookup of entry r for query v*F + i: one 16-byte
  // (F = 4), 8-byte or 4-byte shared load.
  __device__ __forceinline__ void add(int r) {
    const float* e = lut_s + r * QB + v * F;
    if constexpr (F == 4) {
      const float4 x = *reinterpret_cast<const float4*>(e);
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
    } else if constexpr (F == 2) {
      const float2 x = *reinterpret_cast<const float2*>(e);
      acc[0] += x.x;
      acc[1] += x.y;
    } else {
      acc[0] += e[0];
    }
  }

  __device__ __forceinline__ float value(int i) const { return acc[i]; }
};

// Stage the float32 LUTs of queries [b0, b0 + nq) into lut_s, query-minor:
// lut_s[r*QB + q] = luts[b0 + q, r]; slots q >= nq are zero. Writes run
// along lut_s, so they meet no bank conflict.
template <int QB>
__device__ __forceinline__ void adc_f32_stage(float* lut_s,
                                              const float* __restrict__ luts,
                                              int b0, int nq, int mk) {
  for (int i = threadIdx.x; i < QB * mk; i += blockDim.x) {
    const int q = i % QB;
    const int r = i / QB;
    lut_s[i] = q < nq ? luts[(long long)(b0 + q) * mk + r] : 0.f;
  }
  __syncthreads();
}

// ------------------------------------------------ int8 lookups (K3, K5)
//
// The int8 LUT is staged biased to uint8, l + 127 in [0, 254], so the sum of
// m lookups is a nonnegative integer below m*255. Packed (m <= ADC_U8_MAX_M):
// two 16-bit lanes per 32-bit accumulator, lo += w & 0x00FF00FF and hi +=
// (w >> 8) & 0x00FF00FF, four lookups in four integer operations; a lane
// holds at most m*254 < 65536, so nothing carries between lanes. Unpacked
// (a larger m): one int32 accumulator per query. Either way the exact sum is
// the lane minus 127*m, and the one rescale rounds as the plain version's.
#define ADC_U8_MAX_M 258

template <int QB, bool Packed>
struct AdcU8 {
  static constexpr int L = QB >= 16 ? 4 : QB / 4;  // threads that share a row
  static constexpr int F = QB / L;  // queries a thread keeps: 16, 8 or 4
  static constexpr int W = F / 4;   // 32-bit words of one lookup
  const uint8_t* lut_s;
  int v;     // this thread's queries: v*F .. v*F + F-1
  int bias;  // 127 * m
  float sc[F];
  uint32_t acc[Packed ? 2 * W : F];

  __device__ __forceinline__ AdcU8(const uint8_t* lut_s_, int v_, int m,
                                   const float* __restrict__ scale, int b0,
                                   int nq)
      : lut_s(lut_s_), v(v_), bias(127 * m) {
#pragma unroll
    for (int i = 0; i < F; ++i)
      sc[i] = v * F + i < nq ? scale[b0 + v * F + i] : 0.f;
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (Packed ? 2 * W : F); ++i) acc[i] = 0u;
  }

  __device__ __forceinline__ void add(int r) {
    const uint8_t* e = lut_s + r * QB + v * F;
    uint32_t w[W];
    if constexpr (W == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(e);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else if constexpr (W == 2) {
      const uint2 x = *reinterpret_cast<const uint2*>(e);
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(e);
    }
#pragma unroll
    for (int t = 0; t < W; ++t) {
      if constexpr (Packed) {
        acc[2 * t] += w[t] & 0x00FF00FFu;
        acc[2 * t + 1] += (w[t] >> 8) & 0x00FF00FFu;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[4 * t + b] += (w[t] >> (8 * b)) & 0xFFu;
      }
    }
  }

  // float(sum) * scale of query v*F + i; query 4t + b sits in lane b & 2 of
  // acc[2t + (b & 1)] when packed.
  __device__ __forceinline__ float value(int i) const {
    uint32_t s;
    if constexpr (Packed) {
      const uint32_t lanes = acc[2 * (i / 4) + (i & 1)];
      s = (i & 2 ? lanes >> 16 : lanes) & 0xFFFFu;
    } else {
      s = acc[i];
    }
    return __fmul_rn((float)((int)s - bias), sc[i]);
  }
};

// Stage the int8 LUTs of queries [b0, b0 + nq) into lut_s biased to uint8,
// query-minor: byte r*QB + q is luts[b0 + q, r] + 127; slots q >= nq are
// zero. A thread writes one 32-bit word (four queries of one entry); a warp
// takes 8 entries x 4 words, so its byte reads run along r and its writes
// meet at most a four-way bank conflict.
template <int QB>
__device__ __forceinline__ void adc_u8_stage(uint8_t* lut_s,
                                             const int8_t* __restrict__ luts,
                                             int b0, int nq, int mk) {
  constexpr int WQ = QB / 4;  // words per entry
  const int total = WQ * ((mk + 7) / 8 * 8);
  uint32_t* dst = reinterpret_cast<uint32_t*>(lut_s);
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int qq = (i / 8) % WQ;
    const int r = (i / (8 * WQ)) * 8 + i % 8;
    if (r >= mk) continue;
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int q = 4 * qq + t;
      if (q < nq)
        word |= (uint32_t)(uint8_t)(luts[(long long)(b0 + q) * mk + r] + 127)
                << (8 * t);
    }
    dst[r * WQ + qq] = word;
  }
  __syncthreads();
}

// ------------------------------------------- the dense epilogue (K2, K3)
//
// Thread (j, v) stores the F results of its row straight to their F query
// rows of the (B, N) output. A warp holds 32/L consecutive rows of L query
// groups, so each of its F stores writes 32/L x 4 contiguous bytes (a whole
// 32-byte sector at L = 4) in each of L query rows: every sector is written
// whole, and the output costs neither shared memory nor a barrier. The
// stores issue and the thread walks on, so they overlap the next rows'
// lookups. The dense kernels take one slab per tile.
template <int F>
struct AdcDense {
  float* out;
  long long N;
  int b0, nq;  // this block's first query and its number of queries
  int rows;    // rows of a tile (one slab)
  int j, v;    // this thread's group and queries
  long long row0 = 0;  // first row of the current tile

  __device__ __forceinline__ void tile_begin(long long tile) {
    row0 = tile * rows;
  }

  template <typename Look>
  __device__ __forceinline__ void row(const Look& look, int s) {
    const long long n = row0 + s * ADC_ROWS + j;
#pragma unroll
    for (int i = 0; i < F; ++i)
      if (v * F + i < nq)
        out[(long long)(b0 + v * F + i) * N + n] = look.value(i);
  }

  __device__ __forceinline__ void tile_end(long long) {}
};

// ---------------------------------------------------------------- int8 LUTs
//
// K8 (budget_adc_grouped_int8.cu) takes per-query int8 LUTs with one
// float32 scale per query, one thread per code row. A query's int8 LUT is
// a quarter of its float32 one (3 KB at 12x256),
// so a block stages up to ADC_I8_MAX_QB = 32 queries. The staged LUTs are
// query-minor: entry (j, c) of the QB staged
// queries is QB consecutive bytes, so a thread fetches the lookups of all its
// queries for one code with QB/16 16-byte shared-memory loads, and sums them
// into QB int32 accumulators. The sums are exact (|sum| <= m*127).
#define ADC_I8_MAX_QB 32

// Queries staged per int8 block for an (m, k) codebook: the largest of 32,
// 16, 8 and 4 whose LUTs fit in ADC_SMEM_TARGET, else 4 if four fit in a
// block's shared memory at all, else 0.
static inline int adc_i8_query_block(int m, int k) {
  const long long per_query = (long long)m * k;
  for (int qb = ADC_I8_MAX_QB; qb >= 4; qb /= 2)
    if (qb * per_query <= ADC_SMEM_TARGET) return qb;
  return 4 * per_query <= ADC_SMEM_MAX ? 4 : 0;
}

// Stage the int8 LUTs of nq queries into lut_s, query-minor: lut_s[r*QB + q]
// = luts[qid[q], r] for r = j*k + c. Slots q >= nq (and queries whose id is
// negative) are zero. Reads run along r, so they coalesce.
template <int QB>
__device__ __forceinline__ void adc_i8_stage(int8_t* lut_s,
                                             const int8_t* __restrict__ luts,
                                             const int* qid, int nq, int mk) {
  for (int i = threadIdx.x; i < QB * mk; i += blockDim.x) {
    const int q = i / mk;
    const int r = i - q * mk;
    const int id = q < nq ? qid[q] : -1;
    lut_s[r * QB + q] = id >= 0 ? luts[(long long)id * mk + r] : (int8_t)0;
  }
  __syncthreads();
}

// acc[q] += staged int8 lookup of entry r = j*k + c, for all QB queries.
template <int QB>
__device__ __forceinline__ void adc_i8_add(int (&acc)[QB],
                                           const int8_t* lut_s, int r) {
  const int8_t* e = lut_s + r * QB;
  uint32_t w[QB / 4];
  if constexpr (QB % 16 == 0) {
#pragma unroll
    for (int v = 0; v < QB / 16; ++v) {
      const uint4 x = reinterpret_cast<const uint4*>(e)[v];
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
  } else if constexpr (QB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(e);
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_assert(QB == 4, "QB must be 4, 8, 16 or 32");
    w[0] = *reinterpret_cast<const uint32_t*>(e);
  }
#pragma unroll
  for (int t = 0; t < QB / 4; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[4 * t + i] += (int)(int8_t)(uint8_t)(w[t] >> (8 * i));
  }
}

// Int8 ADC sums of code row n for all QB staged queries, over subspaces
// j = 0 .. m-1 (integer sums: the order does not matter).
template <int QB, typename CodeT>
__device__ __forceinline__ void adc_i8_row(int (&acc)[QB], const int8_t* lut_s,
                                           const CodeT* __restrict__ codes,
                                           long long n, long long N, int m,
                                           int k) {
#pragma unroll
  for (int q = 0; q < QB; ++q) acc[q] = 0;
  for (int j = 0; j < m; ++j)
    adc_i8_add<QB>(acc, lut_s, j * k + (int)codes[(long long)j * N + n]);
}
