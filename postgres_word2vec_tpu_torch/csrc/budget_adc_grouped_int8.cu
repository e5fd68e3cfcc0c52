// K8: tile-grouped budgeted ADC over int8 LUTs, `rows` queries per block
// sharing one tile. K7's contract (budget_adc_grouped.cu) with int8 LUTs:
//
//   out[g*rows + s, r] = float(sum_j luts[q, j, codes_t[j, t*block_t + r]])
//                        * scale[q] + rowterm[t*block_t + r],
//   q = qidx[g, s], t = tog[g]
//
// The sum is exact int32; the multiply and the add are rounded one at a time
// (__fmul_rn, then __fadd_rn), as the plain version rounds them, so no fused
// multiply-add makes the two differ. +inf in rowterm stays +inf, and a tile
// id outside the table reads as the inf tile.
//
// Replaces the TPU kernel _budget_adc_grouped_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_grouped_pallas
// with lut_dtype="int8"), which gathers an expanded (G*rows, m, k) int8 LUT
// copy and a per-slot scale in device memory and runs an int8 one-hot matmul.
// Here the block reads each slot's int8 LUT straight from the (B, m, k)
// tensor by qidx into shared memory, query-minor as in K3: a 32-query group
// at 12x256 needs 96 KB and at the join's 30x32 30 KB, so it is staged in one
// pass where K7 needs four passes of 8 float32 LUTs; only very large LUTs
// (the fused-pair 15x1024) take several passes of fewer queries. Slots past a
// group's last query and whole padding groups are skipped: the reassembly
// (torch glue shared with K7) never reads them.
//
// Bound on the H100: shared-memory lookups (one 16-byte load per 16 queries
// per subspace and row) and the tile's code bytes, read once per group.
#include "adc_common.cuh"
#include "budget_common.cuh"

template <int QB, typename CodeT>
__global__ void __launch_bounds__(ADC_THREADS)
budget_adc_grouped_int8_kernel(const int8_t* __restrict__ luts,
                               const float* __restrict__ scale,
                               const CodeT* __restrict__ codes_t,
                               const float* __restrict__ rowterm,
                               const int* __restrict__ qidx,
                               const int* __restrict__ tog,
                               float* __restrict__ out, int B, int m, int k,
                               long long na, int block_t, int n_tiles,
                               int rows) {
  extern __shared__ __align__(16) int8_t lut_s[];
  __shared__ int qid_s[QB];
  __shared__ float scale_s[QB];
  const int g = blockIdx.x;
  const int* q_of = qidx + (long long)g * rows;
  int used = 0;
  for (int s = 0; s < rows; ++s)
    if (q_of[s] >= 0 && q_of[s] < B) used = s + 1;
  if (used == 0) return;  // a padding group: nothing reads its rows
  const int tile = tog[g];
  const bool ok = budget_tile_ok(tile, n_tiles);
  const long long row0 = (long long)tile * block_t;
  for (int s0 = 0; s0 < used; s0 += QB) {
    const int nq = min(QB, used - s0);
    __syncthreads();  // the previous pass has finished reading lut_s
    if (threadIdx.x < QB) {
      const int t = threadIdx.x;
      const int qi = t < nq ? q_of[s0 + t] : -1;
      const bool real = qi >= 0 && qi < B;
      qid_s[t] = real ? qi : -1;
      scale_s[t] = real ? scale[qi] : 0.f;
    }
    __syncthreads();
    adc_i8_stage<QB>(lut_s, luts, qid_s, nq, m * k);
    float* o = out + ((long long)g * rows + s0) * block_t;
    for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
      if (!ok) {
        for (int q = 0; q < nq; ++q)
          o[(long long)q * block_t + r] = budget_inf();
        continue;
      }
      int acc[QB];
      adc_i8_row<QB, CodeT>(acc, lut_s, codes_t, row0 + r, na, m, k);
      const float rt = rowterm[row0 + r];
#pragma unroll
      for (int q = 0; q < QB; ++q)
        if (q < nq)
          o[(long long)q * block_t + r] =
              __fadd_rn(__fmul_rn((float)acc[q], scale_s[q]), rt);
    }
  }
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const int8_t* luts, const float* scale,
                             const void* codes_t, const float* rowterm,
                             const int* qidx, const int* tog, float* out,
                             int B, int m, int k, long long na, int groups,
                             int rows, int block_t, cudaStream_t stream) {
  const size_t smem = (size_t)QB * m * k;
  cudaError_t err =
      adc_allow_smem(budget_adc_grouped_int8_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  budget_adc_grouped_int8_kernel<QB, CodeT>
      <<<groups, ADC_THREADS, smem, stream>>>(
          luts, scale, static_cast<const CodeT*>(codes_t), rowterm, qidx, tog,
          out, B, m, k, na, block_t, (int)(na / block_t), rows);
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes_t, const float* rowterm,
                          const int* qidx, const int* tog, float* out, int B,
                          int m, int k, long long na, int groups, int rows,
                          int block_t, cudaStream_t stream) {
  if (B < 1 || m < 1 || k < 1 || groups < 1 || rows < 1 ||
      !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
#define PW2V_K8(qb)                                                         \
  launch_qb<qb, CodeT>(luts, scale, codes_t, rowterm, qidx, tog, out, B, m, \
                       k, na, groups, rows, block_t, stream)
  switch (adc_i8_query_block(m, k)) {
    case 32: return PW2V_K8(32);
    case 16: return PW2V_K8(16);
    case 8: return PW2V_K8(8);
    case 4: return PW2V_K8(4);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K8
}

extern "C" int pw2v_budget_adc_grouped_int8(
    const void* luts, const void* scale, const void* codes_t, int code_bytes,
    const void* rowterm, const void* qidx, const void* tog, void* out, int B,
    int m, int k, long long na, int groups, int rows, int block_t,
    void* stream) {
  const int8_t* l = static_cast<const int8_t*>(luts);
  const float* sc = static_cast<const float*>(scale);
  const float* rt = static_cast<const float*>(rowterm);
  const int* qi = static_cast<const int*>(qidx);
  const int* tg = static_cast<const int*>(tog);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, sc, codes_t, rt, qi, tg, o, B, m, k, na, groups,
                           rows, block_t, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, sc, codes_t, rt, qi, tg, o, B, m, k, na, groups,
                           rows, block_t, s);
  return cudaErrorInvalidValue;
}
