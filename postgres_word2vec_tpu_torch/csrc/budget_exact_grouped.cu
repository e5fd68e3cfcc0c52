// K10: tile-grouped budgeted exact scores, up to 32 queries per block
// sharing one tile of raw vectors.
//
//   out[g*rows + s, r] = rownorm[n] - 2 * q . v_n,
//                        q = queries[qidx[g, s]], n = tog[g]*block_t + r
//
// queries (B, D) float32, vecs (NA, D) bf16 row-major, rownorm (NA,) float32,
// qidx (G, rows) int32 (B marks an unused slot), tog (G,) int32 -> out
// (G*rows, block_t) float32, reassembled by the wrapper into K9's
// (B, P*block_t) contract. Rows of unused slots are never read back. Same
// precision as K9: float32 queries, bf16 vectors widened exactly, float32
// accumulation in another order than the plain matmul's.
//
// Replaces the TPU kernel _budget_exact_grouped_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_exact_grouped_pallas):
// a (rows, d) @ (d, block_t) product per group on the matrix unit, over a
// gathered (G*rows, d) query copy. Here the block stages its group's queries
// (read by qidx, no gathered copy) in shared memory transposed to [d][32],
// and each thread owns one tile row: it reads the row's 16-byte chunks and,
// for every value, adds it times all 32 queries (float4 broadcast reads of
// shared memory) into 32 register accumulators. CUDA cores for now; the
// tensor cores are a later step.
//
// Bound on the H100: shared-memory bandwidth for the query operand (one
// 16-byte read per four FMAs); each tile row is read once per group.
#include "adc_common.cuh"
#include "bf16.cuh"
#include "budget_common.cuh"

#define BXG_ROWS 32  // queries a group holds at most

__global__ void __launch_bounds__(BUDGET_THREADS)
budget_exact_grouped_kernel(const float* __restrict__ queries,
                            const uint16_t* __restrict__ vecs,
                            const float* __restrict__ rownorm,
                            const int* __restrict__ qidx,
                            const int* __restrict__ tog,
                            float* __restrict__ out, int B, int D,
                            int block_t, int n_tiles, int rows) {
  extern __shared__ __align__(16) float q_s[];  // [D][BXG_ROWS]
  const int g = blockIdx.x;
  const int* q_of = qidx + (long long)g * rows;
  int used = 0;
  for (int s = 0; s < rows; ++s)
    if (q_of[s] >= 0 && q_of[s] < B) used = s + 1;
  if (used == 0) return;  // a padding group: nothing reads its rows
  for (int i = threadIdx.x; i < D * BXG_ROWS; i += blockDim.x) {
    const int d = i / BXG_ROWS, s = i % BXG_ROWS;
    const int qi = s < used ? q_of[s] : -1;
    q_s[i] = (qi >= 0 && qi < B) ? queries[(long long)qi * D + d] : 0.f;
  }
  __syncthreads();
  const int tile = tog[g];
  const bool ok = budget_tile_ok(tile, n_tiles);
  const long long row0 = (long long)tile * block_t;
  float* o = out + (long long)g * rows * block_t;
  for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
    if (!ok) {
      for (int s = 0; s < used; ++s) o[(long long)s * block_t + r] = budget_inf();
      continue;
    }
    const uint16_t* v = vecs + (row0 + r) * D;
    float acc[BXG_ROWS];
#pragma unroll
    for (int s = 0; s < BXG_ROWS; ++s) acc[s] = 0.f;
    for (int c = 0; c < D / 8; ++c) {
      float f[8];
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(v + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float4* qq =
            reinterpret_cast<const float4*>(q_s + (c * 8 + e) * BXG_ROWS);
#pragma unroll
        for (int t = 0; t < BXG_ROWS / 4; ++t) {
          const float4 w = qq[t];
          acc[4 * t] = fmaf(f[e], w.x, acc[4 * t]);
          acc[4 * t + 1] = fmaf(f[e], w.y, acc[4 * t + 1]);
          acc[4 * t + 2] = fmaf(f[e], w.z, acc[4 * t + 2]);
          acc[4 * t + 3] = fmaf(f[e], w.w, acc[4 * t + 3]);
        }
      }
    }
    const float nrm = rownorm[row0 + r];
#pragma unroll
    for (int s = 0; s < BXG_ROWS; ++s)
      if (s < used) o[(long long)s * block_t + r] = nrm - 2.0f * acc[s];
  }
}

extern "C" int pw2v_budget_exact_grouped(const void* queries, const void* vecs,
                                         const void* rownorm, const void* qidx,
                                         const void* tog, void* out, int B,
                                         int D, long long na, int groups,
                                         int rows, int block_t, void* stream) {
  if (B < 1 || groups < 1 || rows < 1 || rows > BXG_ROWS || D < 8 ||
      D % 8 != 0 || D > 1024 || !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)D * BXG_ROWS * sizeof(float);
  cudaError_t err = adc_allow_smem(budget_exact_grouped_kernel, smem);
  if (err != cudaSuccess) return err;
  budget_exact_grouped_kernel<<<groups, BUDGET_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const uint16_t*>(vecs),
      static_cast<const float*>(rownorm), static_cast<const int*>(qidx),
      static_cast<const int*>(tog), static_cast<float*>(out), B, D, block_t,
      (int)(na / block_t), rows);
  return cudaGetLastError();
}
