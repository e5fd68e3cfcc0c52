// K9: budgeted tile-gather exact scores.
//
//   out[b, p*block_t + r] = rownorm[n] - 2 * q_b . v_n,   n = t*block_t + r,
//                           t = tiles[b, p]
//
// queries (B, d) float32 with d <= D (read with zero fill up to D, so the
// caller pads nothing), vecs (NA, D) bf16 row-major cell-aligned target
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
// row-major and a warp's lanes read a row's 16-byte chunks side by side
// (coalesced) against the query values each lane keeps in registers.
//
// Bound on the H100: device-memory reads of the probed tiles (2*D bytes a
// row, 2*D flops a row); a GEMV per tile, far below the tensor cores. A
// single query's probe (a few tiles of 256 rows, a few hundred KB) is
// latency, not bandwidth: the time is the longest chain of dependent loads
// in one warp. What the design does about it:
// - a block owns one query and a range of rows of its slots. Batches take
//   whole slots, up to BUDGET_MAX_SPB of them a block, so the query in
//   registers is reused across tiles; a small probe splits each slot's rows
//   over `bps` blocks so that the launch spreads over the 132 SMs and a warp
//   sums a few rows, not a quarter of a tile one after another;
// - a warp takes K9_ROWS rows at a time and issues the loads of all of them
//   (and their row norms) before any arithmetic, then reduces the K9_ROWS
//   sums together by halving, at each shuffle step, the rows a lane holds
//   (six shuffles for four rows, not twenty); four lanes then store four
//   neighbouring results;
// - slots on the table's last tile, the plans' padding, write +inf and read
//   no vector once the block has seen that the tile's row norms are all
//   +inf; ids outside the table likewise.
#include "bf16.cuh"
#include "budget_common.cuh"

#define K9_ROWS 4  // rows a warp sums at a time (a power of two, <= 32)
// A launch of fewer slots than this splits them over blocks: two blocks for
// each of the H100's 132 SMs.
#define K9_SMALL_SLOTS 264
// Rows a block takes at least when it splits slots: K9_ROWS for each warp.
#define K9_MIN_ROWS (K9_ROWS * BUDGET_THREADS / 32)

// Halve the N rows a lane holds at shuffle distance S: lanes with bit S set
// keep the upper half and add their partner's share of it, the others the
// lower half; then go on with N/2 at S/2.
template <int N, int S>
__device__ __forceinline__ void k9_halve(float* acc, int lane) {
  if constexpr (N > 1) {
    const bool up = lane & S;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = up ? acc[i + N / 2] : acc[i];
      const float give = up ? acc[i] : acc[i + N / 2];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, give, S);
    }
    k9_halve<N / 2, S / 2>(acc, lane);
  }
}

// The warp's K9_ROWS sums, each over its 32 lanes → the sum of row
// lane / (32 / K9_ROWS), in every lane.
__device__ __forceinline__ float k9_reduce(float (&acc)[K9_ROWS], int lane) {
  k9_halve<K9_ROWS, 16>(acc, lane);
  float v = acc[0];
#pragma unroll
  for (int s = 16 / K9_ROWS; s > 0; s >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// CH: 16-byte chunks (8 values) a lane holds, so D <= 32 * 8 * CH.
template <int CH>
__global__ void __launch_bounds__(BUDGET_THREADS)
budget_exact_kernel(const float* __restrict__ queries,
                    const uint16_t* __restrict__ vecs,
                    const float* __restrict__ rownorm,
                    const int* __restrict__ tiles, float* __restrict__ out,
                    int d, int D, int P, int block_t, int n_tiles, int spb,
                    int bps) {
  const int b = blockIdx.x;
  const int sb = blockIdx.y / bps;  // this block's slots, and rows of them
  const int part = blockIdx.y - sb * bps;
  const int per = (block_t + bps - 1) / bps;
  const int r0 = part * per;
  const int r1 = min(block_t, r0 + per);
  if (r0 >= r1) return;
  const int p0 = sb * spb;
  const int p1 = min(P, p0 + spb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int chunks = D / 8;
  const float* q = queries + (long long)b * d;
  float qv[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qv[i][e] = c * 8 + e < d ? __ldg(q + c * 8 + e) : 0.f;
  }
  // Slots that name the table's last tile need no read if its row norms are
  // all +inf (q . v is finite): every thread reads the same tile ids, so the
  // question is asked by all of the block's threads or by none.
  bool last = false;
  for (int p = p0; p < p1; ++p)
    last |= tiles[(long long)b * P + p] == n_tiles - 1;
  const bool skip_last =
      last && budget_last_tile_is_inf(rownorm, n_tiles, block_t);
  constexpr int LPR = 32 / K9_ROWS;  // lanes that end up with one row's sum
  for (int p = p0; p < p1; ++p) {
    const long long slot = (long long)b * P + p;
    const int tile = tiles[slot];
    float* o = out + slot * block_t;
    if (!budget_tile_ok(tile, n_tiles) || (skip_last && tile == n_tiles - 1)) {
      for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
        o[r] = budget_inf();
      continue;
    }
    const long long row0 = (long long)tile * block_t;
    for (int rb = r0 + warp * K9_ROWS; rb < r1; rb += nwarps * K9_ROWS) {
      uint4 v[K9_ROWS][CH];
#pragma unroll
      for (int i = 0; i < K9_ROWS; ++i) {
        const uint16_t* vr = vecs + (row0 + rb + i) * D;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const int c = lane + 32 * ch;
          v[i][ch] = rb + i < r1 && c < chunks
                         ? __ldg(reinterpret_cast<const uint4*>(vr + c * 8))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      const int mine = rb + lane / LPR;  // the row this lane's sum ends in
      const bool store = lane % LPR == 0 && mine < r1;
      const float nrm = store ? __ldg(rownorm + row0 + mine) : 0.f;
      float acc[K9_ROWS];
#pragma unroll
      for (int i = 0; i < K9_ROWS; ++i) {
        acc[i] = 0.f;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          float f[8];
          bf16x8_to_f32(v[i][ch], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i] = fmaf(f[e], qv[ch][e], acc[i]);
        }
      }
      const float dot = k9_reduce(acc, lane);
      if (store) o[mine] = nrm - 2.0f * dot;
    }
  }
}

template <int CH>
static cudaError_t launch(const float* queries, const uint16_t* vecs,
                          const float* rownorm, const int* tiles, float* out,
                          int B, int d, int D, long long na, int P,
                          int block_t, int spb, int bps,
                          cudaStream_t stream) {
  const long long gy = (long long)(P + spb - 1) / spb * bps;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)gy);
  budget_exact_kernel<CH><<<grid, BUDGET_THREADS, 0, stream>>>(
      queries, vecs, rownorm, tiles, out, d, D, P, block_t,
      (int)(na / block_t), spb, bps);
  return cudaGetLastError();
}

// The entry point with the blocks a slot is split over given (0: the
// kernel's choice), for sweeps and tests. With bps = 1 a block takes up to
// BUDGET_MAX_SPB whole slots; with more, one slot's share of rows.
extern "C" int pw2v_budget_exact_bps(const void* queries, const void* vecs,
                                     const void* rownorm, const void* tiles,
                                     void* out, int B, int d, int D,
                                     long long na, int P, int block_t,
                                     int bps, void* stream) {
  if (B < 1 || P < 1 || d < 1 || d > D || D % 8 != 0 || D > 1024 ||
      bps < 0 || bps > block_t || !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const long long slots = (long long)B * P;
  if (bps == 0) {  // split the slots of a small launch, by whole warps' rows
    const long long want = (K9_SMALL_SLOTS + slots - 1) / slots;
    const long long most = block_t / K9_MIN_ROWS;
    bps = (int)(want < most ? want : most);
    if (bps < 1) bps = 1;
  }
  const int spb = bps == 1 ? budget_slots_per_block(B, P, BUDGET_TARGET_BLOCKS,
                                                    BUDGET_MAX_SPB)
                           : 1;
  const float* q = static_cast<const float*>(queries);
  const uint16_t* v = static_cast<const uint16_t*>(vecs);
  const float* rn = static_cast<const float*>(rownorm);
  const int* t = static_cast<const int*>(tiles);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = D / 8;
  if (chunks <= 32)
    return launch<1>(q, v, rn, t, o, B, d, D, na, P, block_t, spb, bps, s);
  if (chunks <= 64)
    return launch<2>(q, v, rn, t, o, B, d, D, na, P, block_t, spb, bps, s);
  return launch<4>(q, v, rn, t, o, B, d, D, na, P, block_t, spb, bps, s);
}

extern "C" int pw2v_budget_exact(const void* queries, const void* vecs,
                                 const void* rownorm, const void* tiles,
                                 void* out, int B, int d, int D, long long na,
                                 int P, int block_t, void* stream) {
  return pw2v_budget_exact_bps(queries, vecs, rownorm, tiles, out, B, d, D,
                               na, P, block_t, 0, stream);
}
