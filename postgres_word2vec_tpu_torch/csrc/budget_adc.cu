// K6: budgeted tile-gather ADC, one query per block.
//
//   out[b, p*block_t + r] = sum_j luts[b, j, codes_t[j, t*block_t + r]]
//                           + rowterm[t*block_t + r],   t = tiles[b, p]
//
// luts (B, m, k) float32, codes_t (m, NA) uint8/int16 cell-aligned codes
// (subspace-major), rowterm (NA,) float32 with +inf on pad rows and the inf
// tile, tiles (B, P) int32 -> out (B, P*block_t) float32.
//
// Replaces the TPU kernel _budget_adc_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_pallas). There the
// tile ids arrive by scalar prefetch, each (query, slot) is one grid step and
// the lookup is a one-hot matmul with bf16 LUTs. Here a block owns one query
// and up to 8 of its slots: it stages the query's float32 LUT in shared
// memory once (61 KB at the fused-pair 15x1024 LUTs, above the 48 KB default,
// hence the opt-in), then walks each slot's tile with one thread per row, so
// the code reads along NA coalesce. Sums run over subspaces in order, then
// the row term is added, as in the plain version; +inf + finite stays +inf.
//
// Bound on the H100: shared-memory lookups (m per output, at random banks)
// and the code bytes of the probed tiles; each output is written once.
#include "adc_common.cuh"
#include "budget_common.cuh"

template <typename CodeT>
__global__ void __launch_bounds__(ADC_THREADS)
budget_adc_kernel(const float* __restrict__ luts,
                  const CodeT* __restrict__ codes_t,
                  const float* __restrict__ rowterm,
                  const int* __restrict__ tiles, float* __restrict__ out,
                  int m, int k, long long na, int P, int block_t, int n_tiles,
                  int spb) {
  extern __shared__ float lut_s[];
  const int b = blockIdx.x;
  adc_stage_luts(lut_s, luts, b, 1, m * k);
  const int p1 = min(P, (int)(blockIdx.y + 1) * spb);
  for (int p = blockIdx.y * spb; p < p1; ++p) {
    const long long slot = (long long)b * P + p;
    const int tile = tiles[slot];
    float* o = out + slot * block_t;
    if (!budget_tile_ok(tile, n_tiles)) {
      for (int r = threadIdx.x; r < block_t; r += blockDim.x)
        o[r] = budget_inf();
      continue;
    }
    const long long row0 = (long long)tile * block_t;
    for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
      float acc[ADC_MAX_QB];
      adc_row<CodeT>(acc, lut_s, codes_t, row0 + r, na, m, k, 1);
      o[r] = acc[0] + rowterm[row0 + r];
    }
  }
}

template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes_t,
                          const float* rowterm, const int* tiles, float* out,
                          int B, int m, int k, long long na, int P,
                          int block_t, cudaStream_t stream) {
  const size_t smem = (size_t)m * k * sizeof(float);
  if (B < 1 || P < 1 || m < 1 || k < 1 || smem > ADC_SMEM_MAX ||
      !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const int spb = budget_slots_per_block(B, P);
  const long long gy = (P + spb - 1) / spb;
  if (gy > 65535) return cudaErrorInvalidValue;
  cudaError_t err = adc_allow_smem(budget_adc_kernel<CodeT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)gy);
  budget_adc_kernel<CodeT><<<grid, ADC_THREADS, smem, stream>>>(
      luts, static_cast<const CodeT*>(codes_t), rowterm, tiles, out, m, k, na,
      P, block_t, (int)(na / block_t), spb);
  return cudaGetLastError();
}

extern "C" int pw2v_budget_adc(const void* luts, const void* codes_t,
                               int code_bytes, const void* rowterm,
                               const void* tiles, void* out, int B, int m,
                               int k, long long na, int P, int block_t,
                               void* stream) {
  const float* l = static_cast<const float*>(luts);
  const float* rt = static_cast<const float*>(rowterm);
  const int* t = static_cast<const int*>(tiles);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes_t, rt, t, o, B, m, k, na, P, block_t, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes_t, rt, t, o, B, m, k, na, P, block_t, s);
  return cudaErrorInvalidValue;
}
