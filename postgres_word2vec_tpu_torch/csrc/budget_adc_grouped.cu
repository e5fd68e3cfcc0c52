// K7: tile-grouped budgeted ADC, `rows` queries per block sharing one tile.
//
// The (query, slot) pairs of a budget probe are sorted by tile (torch glue,
// ops/kernels.py _group_probe_layout): group g holds up to `rows` queries
// qidx[g, :] (B marks an unused slot) that all probe tile tog[g].
//
//   out[g*rows + s, r] = sum_j luts[q, j, codes_t[j, t*block_t + r]]
//                        + rowterm[t*block_t + r],   q = qidx[g, s], t = tog[g]
//
// out is (G*rows, block_t) float32; the wrapper reassembles the (B, P*block_t)
// result of K6's contract with one row gather. Rows of unused slots are
// never read back, so a block computes only up to its last real slot.
//
// Replaces the TPU kernel _budget_adc_grouped_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_grouped_pallas),
// which gathers an expanded (G*rows, m, k) LUT copy in device memory and runs
// the lookup as a one-hot matmul. Here the block reads each query's float32
// LUT straight from the (B, m, k) tensor by qidx into shared memory, in
// passes of up to 8 queries (all 32 LUTs of a group at 12x256 would take
// 384 KB, over the 227 KB a block can have); each thread owns one tile row,
// reads its m codes once per pass and sums them for every staged query, in
// subspace order as the plain version does.
//
// Bound on the H100: shared-memory lookups; the tile's codes are read from
// device memory once per group and from L1/L2 on the later passes.
#include "adc_common.cuh"
#include "budget_common.cuh"

template <typename CodeT>
__global__ void __launch_bounds__(ADC_THREADS)
budget_adc_grouped_kernel(const float* __restrict__ luts,
                          const CodeT* __restrict__ codes_t,
                          const float* __restrict__ rowterm,
                          const int* __restrict__ qidx,
                          const int* __restrict__ tog,
                          float* __restrict__ out, int B, int m, int k,
                          long long na, int block_t, int n_tiles, int rows,
                          int qb) {
  extern __shared__ float lut_s[];
  const int g = blockIdx.x;
  const int* q_of = qidx + (long long)g * rows;
  int used = 0;
  for (int s = 0; s < rows; ++s)
    if (q_of[s] >= 0 && q_of[s] < B) used = s + 1;
  if (used == 0) return;  // a padding group: nothing reads its rows
  const int tile = tog[g];
  const bool ok = budget_tile_ok(tile, n_tiles);
  const long long row0 = (long long)tile * block_t;
  const int mk = m * k;
  for (int s0 = 0; s0 < used; s0 += qb) {
    const int nq = min(qb, used - s0);
    __syncthreads();  // the previous pass has finished reading lut_s
    for (int q = 0; q < nq; ++q) {
      const int qi = q_of[s0 + q];
      const bool real = qi >= 0 && qi < B;
      const float* src = luts + (long long)(real ? qi : 0) * mk;
      for (int i = threadIdx.x; i < mk; i += blockDim.x)
        lut_s[q * mk + i] = real ? src[i] : 0.f;
    }
    __syncthreads();
    float* o = out + ((long long)g * rows + s0) * block_t;
    for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
      if (!ok) {
        for (int q = 0; q < nq; ++q) o[(long long)q * block_t + r] = budget_inf();
        continue;
      }
      float acc[ADC_MAX_QB];
      adc_row<CodeT>(acc, lut_s, codes_t, row0 + r, na, m, k, nq);
      const float rt = rowterm[row0 + r];
#pragma unroll
      for (int q = 0; q < ADC_MAX_QB; ++q)
        if (q < nq) o[(long long)q * block_t + r] = acc[q] + rt;
    }
  }
}

template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes_t,
                          const float* rowterm, const int* qidx,
                          const int* tog, float* out, int B, int m, int k,
                          long long na, int groups, int rows, int block_t,
                          cudaStream_t stream) {
  const int qb = adc_query_block(m, k);
  if (qb == 0 || B < 1 || groups < 1 || rows < 1 ||
      !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)qb * m * k * sizeof(float);
  cudaError_t err = adc_allow_smem(budget_adc_grouped_kernel<CodeT>, smem);
  if (err != cudaSuccess) return err;
  budget_adc_grouped_kernel<CodeT><<<groups, ADC_THREADS, smem, stream>>>(
      luts, static_cast<const CodeT*>(codes_t), rowterm, qidx, tog, out, B, m,
      k, na, block_t, (int)(na / block_t), rows, qb);
  return cudaGetLastError();
}

extern "C" int pw2v_budget_adc_grouped(const void* luts, const void* codes_t,
                                       int code_bytes, const void* rowterm,
                                       const void* qidx, const void* tog,
                                       void* out, int B, int m, int k,
                                       long long na, int groups, int rows,
                                       int block_t, void* stream) {
  const float* l = static_cast<const float*>(luts);
  const float* rt = static_cast<const float*>(rowterm);
  const int* qi = static_cast<const int*>(qidx);
  const int* tg = static_cast<const int*>(tog);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes_t, rt, qi, tg, o, B, m, k, na, groups,
                           rows, block_t, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes_t, rt, qi, tg, o, B, m, k, na, groups,
                           rows, block_t, s);
  return cudaErrorInvalidValue;
}
