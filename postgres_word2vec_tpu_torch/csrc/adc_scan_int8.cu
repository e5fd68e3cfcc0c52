// K3: dense ADC scan over int8 LUTs, (B, m, k) int8 LUTs + (B,) float32
// scales x (m, N) codes -> (B, N) float32.
//
//   out[b, n] = float(sum_j luts[b, j, codes[j, n]]) * scale[b]
//
// The sum is exact int32; the one multiply is rounded as the plain version
// rounds it, so the two agree bit for bit.
//
// Replaces the TPU kernel _adc_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_pallas with
// lut_dtype="int8"), which runs an int8 one-hot matmul on the TPU's matrix
// unit. Here the lookup is a shared-memory read, as in K2 (adc_scan.cu), but
// a query's int8 LUT is a quarter of its float32 one: a block stages up to 32
// queries (96 KB at 12x256), query-minor, so each code row read from device
// memory serves four times as many queries as in K2, and the lookups of all
// staged queries for one code come in two 16-byte shared loads. The
// per-query scale comes from the torch glue (ops/kernels.py
// quantize_luts_int8); the kernel does not recompute it.
//
// Bound on the H100: as K2, the B*N*4-byte output and the shared-memory
// lookups; the lookups are m per (row, 32 queries) 16-byte loads instead of
// m per (row, query) 4-byte loads.
#include "adc_common.cuh"

template <int QB, typename CodeT>
__global__ void __launch_bounds__(ADC_THREADS)
adc_scan_int8_kernel(const int8_t* __restrict__ luts,
                     const float* __restrict__ scale,
                     const CodeT* __restrict__ codes, float* __restrict__ out,
                     int B, int m, int k, long long N) {
  extern __shared__ __align__(16) int8_t lut_s[];
  __shared__ int qid_s[QB];
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  if (threadIdx.x < QB) qid_s[threadIdx.x] = b0 + threadIdx.x;
  __syncthreads();
  adc_i8_stage<QB>(lut_s, luts, qid_s, nq, m * k);
  float sc[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) sc[q] = q < nq ? scale[b0 + q] : 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    int acc[QB];
    adc_i8_row<QB, CodeT>(acc, lut_s, codes, n, N, m, k);
#pragma unroll
    for (int q = 0; q < QB; ++q)
      if (q < nq)
        out[(long long)(b0 + q) * N + n] = __fmul_rn((float)acc[q], sc[q]);
  }
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const int8_t* luts, const float* scale,
                             const void* codes, float* out, int B, int m,
                             int k, long long N, cudaStream_t stream) {
  const size_t smem = (size_t)QB * m * k;
  cudaError_t err = adc_allow_smem(adc_scan_int8_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const unsigned gy = (unsigned)((B + QB - 1) / QB);
  const dim3 grid(adc_grid_x(N, gy), gy);
  adc_scan_int8_kernel<QB, CodeT><<<grid, ADC_THREADS, smem, stream>>>(
      luts, scale, static_cast<const CodeT*>(codes), out, B, m, k, N);
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes, float* out, int B, int m, int k,
                          long long N, cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
#define PW2V_K3(qb) \
  launch_qb<qb, CodeT>(luts, scale, codes, out, B, m, k, N, stream)
  switch (adc_i8_query_block(m, k)) {
    case 32: return PW2V_K3(32);
    case 16: return PW2V_K3(16);
    case 8: return PW2V_K3(8);
    case 4: return PW2V_K3(4);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K3
}

extern "C" int pw2v_adc_scan_int8(const void* luts, const void* scale,
                                  const void* codes, int code_bytes,
                                  void* out, int B, int m, int k,
                                  long long N, void* stream) {
  const int8_t* l = static_cast<const int8_t*>(luts);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1) return launch<uint8_t>(l, sc, codes, o, B, m, k, N, s);
  if (code_bytes == 2) return launch<int16_t>(l, sc, codes, o, B, m, k, N, s);
  return cudaErrorInvalidValue;
}
