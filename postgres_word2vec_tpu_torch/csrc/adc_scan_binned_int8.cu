// K5: ADC scan over int8 LUTs fused with a strided-bin min/argmin.
//
// Bins follow K4 (adc_scan_binned.cu): bin j of a block_n-row tile holds rows
// {tile*block_n + j + s*bins : s < sub}, sub = block_n/bins. Per query and
// bin the kernel takes the minimum of the exact packed int32 key
//
//   key = sum * 2^shift + s,   sum = sum_j luts[b, j, codes[j, row]],
//   shift = log2(pow2ceil(sub)),
//
// so one integer min gives the bin minimum and, on a tie, the lowest
// sub-index (the lowest row id). The outputs are
//
//   mins[b, tile*bins + j] = float(key >> shift) * scale[b]
//   ids[b, tile*bins + j]  = tile*block_n + (key & (2^shift - 1))*bins + j
//
// Rows at or past N are masked in the kernel: a bin with no valid row keeps
// the key INT32_MAX and comes out as +inf with id -1.
//
// Replaces the TPU kernel _adc_binned_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_binned_pallas with
// lut_dtype="int8"), which packs the same key after an int8 one-hot matmul
// and applies the scale in its wrapper; here the scale is applied to the
// binned output in the kernel. The lookups are K3's (adc_scan_int8.cu): up
// to 32 queries' int8 LUTs staged query-minor in shared memory.
//
// Bound on the H100: shared-memory lookups, as K4; the output is
// block_n/bins times smaller than the dense scan's.
#include <limits.h>

#include "adc_common.cuh"

template <int QB, typename CodeT>
__global__ void __launch_bounds__(ADC_THREADS)
adc_scan_binned_int8_kernel(const int8_t* __restrict__ luts,
                            const float* __restrict__ scale,
                            const CodeT* __restrict__ codes,
                            float* __restrict__ mins, int* __restrict__ ids,
                            int B, int m, int k, long long N, int block_n,
                            int bins, long long n_units, int shift) {
  extern __shared__ __align__(16) int8_t lut_s[];
  __shared__ int qid_s[QB];
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  if (threadIdx.x < QB) qid_s[threadIdx.x] = b0 + threadIdx.x;
  __syncthreads();
  adc_i8_stage<QB>(lut_s, luts, qid_s, nq, m * k);
  const int sub = block_n / bins;
  const int field = 1 << shift;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < n_units; u += stride) {
    const long long tile = u / bins;
    const int j = (int)(u - tile * bins);
    const long long first = tile * block_n + j;
    int best[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) best[q] = INT_MAX;
    for (int s = 0; s < sub; ++s) {
      const long long n = first + (long long)s * bins;
      if (n >= N) break;  // rows grow with s: the rest of the bin is padding
      int acc[QB];
      adc_i8_row<QB, CodeT>(acc, lut_s, codes, n, N, m, k);
#pragma unroll
      for (int q = 0; q < QB; ++q) best[q] = min(best[q], acc[q] * field + s);
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q < nq) {
        const long long o = (long long)(b0 + q) * n_units + u;
        if (best[q] == INT_MAX) {
          mins[o] = __int_as_float(0x7f800000);  // +inf
          ids[o] = -1;
        } else {
          mins[o] = __fmul_rn((float)(best[q] >> shift), scale[b0 + q]);
          ids[o] = (int)(first + (long long)(best[q] & (field - 1)) * bins);
        }
      }
    }
  }
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const int8_t* luts, const float* scale,
                             const void* codes, float* mins, int* ids, int B,
                             int m, int k, long long N, int block_n, int bins,
                             int shift, cudaStream_t stream) {
  const size_t smem = (size_t)QB * m * k;
  cudaError_t err =
      adc_allow_smem(adc_scan_binned_int8_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long n_units = (N + block_n - 1) / block_n * bins;
  const unsigned gy = (unsigned)((B + QB - 1) / QB);
  const dim3 grid(adc_grid_x(n_units, gy), gy);
  adc_scan_binned_int8_kernel<QB, CodeT><<<grid, ADC_THREADS, smem, stream>>>(
      luts, scale, static_cast<const CodeT*>(codes), mins, ids, B, m, k, N,
      block_n, bins, n_units, shift);
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes, float* mins, int* ids, int B,
                          int m, int k, long long N, int block_n, int bins,
                          cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || k < 1 || bins < 1 || block_n % bins != 0)
    return cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < block_n / bins) ++shift;
  // the packed key of a real row must stay below INT32_MAX
  if (((long long)m * 127 + 1) << shift >= (long long)INT_MAX)
    return cudaErrorInvalidValue;
#define PW2V_K5(qb)                                                          \
  launch_qb<qb, CodeT>(luts, scale, codes, mins, ids, B, m, k, N, block_n,   \
                       bins, shift, stream)
  switch (adc_i8_query_block(m, k)) {
    case 32: return PW2V_K5(32);
    case 16: return PW2V_K5(16);
    case 8: return PW2V_K5(8);
    case 4: return PW2V_K5(4);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K5
}

extern "C" int pw2v_adc_scan_binned_int8(const void* luts, const void* scale,
                                         const void* codes, int code_bytes,
                                         void* mins, void* ids, int B, int m,
                                         int k, long long N, int block_n,
                                         int bins, void* stream) {
  const int8_t* l = static_cast<const int8_t*>(luts);
  const float* sc = static_cast<const float*>(scale);
  float* mn = static_cast<float*>(mins);
  int* id = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, sc, codes, mn, id, B, m, k, N, block_n, bins, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, sc, codes, mn, id, B, m, k, N, block_n, bins, s);
  return cudaErrorInvalidValue;
}
