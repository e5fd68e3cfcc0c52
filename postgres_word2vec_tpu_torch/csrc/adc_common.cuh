// Shared pieces of the two ADC scan kernels (adc_scan.cu, adc_scan_binned.cu).
//
// Both kernels stage the lookup tables of up to ADC_MAX_QB queries in shared
// memory and give each thread one code row (or one strided bin of rows), so
// a thread reads its m codes once and looks them up for every staged query.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ADC_THREADS 256
#define ADC_MAX_QB 8
// Shared memory a block may take for staged LUTs. Two such blocks fit on
// one SM (227 KB); one query's LUT alone may use up to ADC_SMEM_MAX.
#define ADC_SMEM_TARGET (96 * 1024)
#define ADC_SMEM_MAX (227 * 1024)
// Blocks launched in all: about eight per SM of a 132-SM card. Each block
// walks its share of rows in a grid-stride loop, so the LUT staging cost is
// paid once per block rather than once per 256 rows.
#define ADC_TARGET_BLOCKS 1056

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

static inline unsigned adc_grid_x(long long units, unsigned grid_y) {
  long long gx = (units + ADC_THREADS - 1) / ADC_THREADS;
  const long long cap = (ADC_TARGET_BLOCKS + grid_y - 1) / grid_y;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  return (unsigned)gx;
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

// --------------------------------------------- query-minor float32 LUTs
//
// K4 (adc_scan_binned.cu) stages the float32 LUTs of QB queries query-minor:
// entry r = j*k + c of the QB queries is QB consecutive floats, so one
// 16-byte shared load fetches one lookup for four queries. A thread keeps F
// of the QB queries (four when QB >= 4), and L = QB / F neighbouring threads
// share one code row, so together they read all QB floats of an entry.
template <int QB>
struct AdcF32 {
  static constexpr int F = QB >= 4 ? 4 : QB;  // queries a thread keeps
  static constexpr int L = QB / F;            // threads that share a row
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

// acc[i] += staged lookup of entry r for query v*F + i, i < F: one 16-byte
// (F = 4), 8-byte or 4-byte shared load.
template <int QB>
__device__ __forceinline__ void adc_f32_add(float (&acc)[AdcF32<QB>::F],
                                            const float* lut_s, int r,
                                            int v) {
  constexpr int F = AdcF32<QB>::F;
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

// Raise the block's dynamic shared-memory limit where a launch needs more
// than the default 48 KB; without it the launch is refused and never runs.
template <typename Kernel>
static inline cudaError_t adc_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------- int8 LUTs
//
// The int8 kernels (adc_scan_int8.cu, adc_scan_binned_int8.cu,
// budget_adc_grouped_int8.cu) take per-query int8 LUTs with one float32
// scale per query. A query's int8 LUT is a quarter of its float32 one (3 KB
// at 12x256), so a block stages up to ADC_I8_MAX_QB = 32 queries, four times
// K2's 8. The staged LUTs are query-minor: entry (j, c) of the QB staged
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
