// K9: budgeted tile-gather exact scores, one query per block.
//
//   out[b, p*block_t + r] = rownorm[n] - 2 * q_b . v_n,   n = t*block_t + r,
//                           t = tiles[b, p]
//
// queries (B, D) float32, vecs (NA, D) bf16 row-major cell-aligned target
// vectors, rownorm (NA,) float32 (+inf on pad rows, whose vectors are zero),
// tiles (B, P) int32 -> out (B, P*block_t) float32 shifted scores; callers
// add |q|^2 back. D is a multiple of 8 (16-byte rows) and at most 1024.
//
// Precision: queries stay float32 (the plain version, budget_exact_xla,
// keeps them float32; the TPU kernel rounds them to bf16), the bf16 vectors
// widen exactly to float32, and products accumulate in float32 on CUDA
// cores. The sum is taken in another order than the plain matmul's.
//
// Replaces the TPU kernel _budget_exact_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_exact_pallas), which
// reads a transposed (d, NA) vector table tile by tile. Here the table stays
// row-major: a block owns one query and up to 8 of its slots; each warp takes
// one row at a time, its 32 lanes read the row's 16-byte chunks side by side
// (coalesced) against the query values each lane keeps in registers, and a
// warp shuffle sums the lanes.
//
// Bound on the H100: device-memory reads of the probed tiles (D*2 bytes a
// row, 2*D flops a row); a GEMV per tile, far below the tensor cores.
#include "bf16.cuh"
#include "budget_common.cuh"

// 8-value chunks a lane holds: D <= 32 * BX_MAX_CHUNKS * 8 = 1024.
#define BX_MAX_CHUNKS 4

__global__ void __launch_bounds__(BUDGET_THREADS)
budget_exact_kernel(const float* __restrict__ queries,
                    const uint16_t* __restrict__ vecs,
                    const float* __restrict__ rownorm,
                    const int* __restrict__ tiles, float* __restrict__ out,
                    int D, int P, int block_t, int n_tiles, int spb) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int chunks = D / 8;
  const float* q = queries + (long long)b * D;
  float qv[BX_MAX_CHUNKS][8];
#pragma unroll
  for (int i = 0; i < BX_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[i][e] = c < chunks ? q[c * 8 + e] : 0.f;
  }
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
    for (int r = warp; r < block_t; r += nwarps) {
      const uint16_t* v = vecs + (row0 + r) * D;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < BX_MAX_CHUNKS; ++i) {
        const int c = lane + 32 * i;
        if (c < chunks) {
          float f[8];
          bf16x8_to_f32(*reinterpret_cast<const uint4*>(v + c * 8), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(f[e], qv[i][e], acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) o[r] = rownorm[row0 + r] - 2.0f * acc;
    }
  }
}

extern "C" int pw2v_budget_exact(const void* queries, const void* vecs,
                                 const void* rownorm, const void* tiles,
                                 void* out, int B, int D, long long na, int P,
                                 int block_t, void* stream) {
  if (B < 1 || P < 1 || D < 8 || D % 8 != 0 || D > 32 * BX_MAX_CHUNKS * 8 ||
      !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const int spb =
      budget_slots_per_block(B, P, BUDGET_TARGET_BLOCKS, BUDGET_MAX_SPB);
  const long long gy = (P + spb - 1) / spb;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)gy);
  budget_exact_kernel<<<grid, BUDGET_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const uint16_t*>(vecs),
      static_cast<const float*>(rownorm), static_cast<const int*>(tiles),
      static_cast<float*>(out), D, P, block_t, (int)(na / block_t), spb);
  return cudaGetLastError();
}
