// K10: tile-grouped budgeted exact scores, up to 32 queries per block
// sharing one tile of raw vectors, on the tensor cores.
//
//   out[g*rows + s, r] = rownorm[n] - 2 * q . v_n,
//                        q = queries[qidx[g, s]], n = tog[g]*block_t + r
//
// queries (B, D) float32, vecs (NA, D) bf16 row-major, rownorm (NA,) float32,
// qidx (G, rows) int32 (B marks an unused slot), tog (G,) int32 -> out
// (G*rows, block_t) float32, reassembled by the wrapper into K9's
// (B, P*block_t) contract. Rows of unused slots are never written and never
// read back; a tile id outside the table reads as the inf tile.
//
// Precision: the queries stay float32, as in the plain version (the TPU
// kernel casts them to bf16, which would miss the port's 1e-4 by an order
// of magnitude). Each staged query value q is split into three bf16 parts,
// hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid), each rounded
// to nearest even; their 3 x 8 significant bits hold q's 24 exactly, and
// the kernel runs three bf16 products, hi.v + mid.v + lo.v, with float32
// accumulation on the tensor cores against the bf16 rows (exact). Two
// parts leave a residual up to 2^-16 |q|: within a few 1e-6 for unit
// queries, but up to ~1e-4 for queries of norm 10 at small D.
//
// Replaces the TPU kernel _budget_exact_grouped_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_exact_grouped_pallas):
// a (rows, d) @ (d, block_t) product per group on the matrix unit, over a
// gathered (G*rows, d) query copy.
//
// Bound on the H100: device-memory bytes, one 256 x 304 bf16 tile (156 KB) per
// group read once and the (used, block_t) float32 output; the products are 3 x
// 5 MFLOP a full group. In practice the tensor-core products (mma.sync reaches
// well under the bf16 peak, and the split triples them) and each block's
// serial staging set the pace, not the bytes (chip_smoke.py's sweep of the
// part count shows what one part costs).
//
// Design. A block takes 128 rows of a group's tile (blockIdx.y) and their
// (128, D) @ (D, rows) product on mma.sync.m16n8k16 (bf16 in, float32
// accumulation), tile rows as M and the group's queries as N, padded to a
// multiple of 8; the n-tiles past the group's last used slot are skipped. The
// block stages its group's queries (by qidx, no gathered copy) split into
// their three parts in shared memory, each warp reading whole query rows, so
// the loads coalesce. The tile is read straight into the A fragments with
// 16-byte loads: since a dot product does not depend on the order of its
// terms, the two k16 steps of a 32-column chunk take the columns in the order
// that lets thread t of a quad hold columns 8t..8t+7 of its row in one load
// (logical k 2t, 2t+1 -> 8t + 4i, 8t + 4i + 1 and 2t+8, 2t+9 -> 8t + 4i + 2,
// 8t + 4i + 3 in step i), and the staged queries are laid out in the same
// order. Four lanes then read 64 contiguous bytes of a row, every load is a
// whole sector, and no shared memory or barrier stands between the tile and
// the tensor cores. Each warp takes 16 rows (one m16 fragment) and keeps seven
// chunks' loads in flight ahead of its products, the first seven issued before
// the queries are staged. Chunks past D (D % 32 != 0) load zeros. The groups
// of one tile are consecutive (the wrapper's layout sorts by tile), so they
// run side by side and the tile comes from device memory once and from L2
// after that. The epilogue writes rownorm - 2*acc from the accumulator
// fragments, only for used slots; a warp's store fills whole 32-byte sectors
// of four slot rows.
#include "adc_common.cuh"
#include "budget_common.cuh"

#define BXG_ROWS 32   // queries a group holds at most
#define BXG_WARPS 8   // warps per block
#define BXG_BLOCK_ROWS (BXG_WARPS * 16)  // tile rows per block: 16 a warp
#define BXG_PARTS 3   // bf16 parts that hold a float32 query value exactly
#define BXG_RING 8    // chunks in registers: one in use, 7 loads in flight

// The bf16 bits of x rounded to nearest even (x finite).
__device__ __forceinline__ uint32_t bf16_bits_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// Split (a, b) into PARTS packed bf16 pairs, each part the bf16 of what
// the parts before it left, a in the low half (the lower k of an mma
// fragment register).
template <int PARTS>
__device__ __forceinline__ void split_bf16x2(float a, float b,
                                             uint32_t (&part)[PARTS]) {
#pragma unroll
  for (int i = 0; i < PARTS; ++i) {
    const uint32_t ha = bf16_bits_rn(a), hb = bf16_bits_rn(b);
    part[i] = ha | hb << 16;
    // exact: the difference lies in the 16 bits that bf16 drops
    a -= __uint_as_float(ha << 16);
    b -= __uint_as_float(hb << 16);
  }
}

// c += A (16x16 bf16, row) . B (16x8 bf16, col), float32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// PARTS bf16 parts per query value: BXG_PARTS in the port; fewer only
// through the sweep entry point below, to measure what a part costs.
template <int PARTS>
__global__ void __launch_bounds__(BXG_WARPS * 32, 2)
budget_exact_grouped_kernel(const float* __restrict__ queries,
                            const uint16_t* __restrict__ vecs,
                            const float* __restrict__ rownorm,
                            const int* __restrict__ qidx,
                            const int* __restrict__ tog,
                            float* __restrict__ out, int B, int D,
                            int block_t, int n_tiles, int rows) {
  // [chunk][n-tile][part][lane]: lane 4g + t holds columns 32c + 8t ..
  // 32c + 8t + 7 of slot 8*n-tile + g as bf16
  extern __shared__ __align__(16) uint4 q_s[];
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int* q_of = qidx + (long long)g * rows;
  // slots up to the last real query: one coalesced read and a ballot
  const int qv = lane < rows ? q_of[lane] : -1;
  const unsigned real = __ballot_sync(0xffffffffu, qv >= 0 && qv < B);
  if (real == 0) return;  // a padding group: nothing reads its rows
  const int used = 32 - __clz(real);
  const int tile = tog[g];
  float* o = out + (long long)g * rows * block_t;
  const int rb = blockIdx.y * BXG_BLOCK_ROWS;  // this block's first row
  const int nrb = min(BXG_BLOCK_ROWS, block_t - rb);
  if (!budget_tile_ok(tile, n_tiles)) {
    for (int i = threadIdx.x; i < used * nrb; i += blockDim.x)
      o[(long long)(i / nrb) * block_t + rb + i % nrb] = budget_inf();
    return;
  }
  const int nch = (D + 31) / 32;  // 32-column chunks
  // This thread's rows of its warp's m16 fragment: r0 + gq and r0 + gq + 8
  // (none past block_t; a warp past it only helps stage the queries).
  const long long row0 = (long long)tile * block_t;
  const int r0 = rb + warp * 16;
  const uint4* src[2];
  bool in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + gq + 8 * i;
    in[i] = r < block_t;
    src[i] =
        reinterpret_cast<const uint4*>(vecs + (row0 + (in[i] ? r : 0)) * D) +
        t;
  }
  // columns 32c + 8t .. +7 of the two rows; zeros past D or block_t
  auto load = [&](uint4 (&a)[2], int c) {
    const bool col = c < nch && c * 32 + t * 8 < D;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[i] = col && in[i] ? __ldg(src[i] + 4 * c) : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 a[BXG_RING][2];  // chunk c in a[c % BXG_RING]
#pragma unroll
  for (int j = 0; j < BXG_RING - 1; ++j) load(a[j], j);

  const int n8 = (used + 7) / 8;  // n-tiles of 8 slots this group needs
  const int pieces = nch * 4;     // 8-column pieces of a query row
#pragma unroll 4
  for (int i = threadIdx.x; i < n8 * 8 * pieces; i += blockDim.x) {
    const int s = i / pieces, p = i - s * pieces;
    const int qi = s < used ? q_of[s] : -1;
    uint32_t w[4][PARTS] = {};
    if (qi >= 0 && qi < B && p * 8 < D) {
      const float4* qrow =
          reinterpret_cast<const float4*>(queries + (long long)qi * D + p * 8);
      const float4 x = qrow[0], y = qrow[1];
      split_bf16x2(x.x, x.y, w[0]);
      split_bf16x2(x.z, x.w, w[1]);
      split_bf16x2(y.x, y.y, w[2]);
      split_bf16x2(y.z, y.w, w[3]);
    }
    uint4* dst = q_s + ((p / 4) * n8 + s / 8) * (32 * PARTS) +
                 (s % 8) * 4 + p % 4;
#pragma unroll
    for (int pt = 0; pt < PARTS; ++pt)
      dst[32 * pt] = make_uint4(w[0][pt], w[1][pt], w[2][pt], w[3][pt]);
  }
  __syncthreads();
  if (r0 >= block_t) return;

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int c0 = 0; c0 < nch; c0 += BXG_RING) {
#pragma unroll
    for (int j = 0; j < BXG_RING; ++j) {  // chunk c0 + j, in a[j]
      if (c0 + j >= nch) break;
      load(a[(j + BXG_RING - 1) % BXG_RING], c0 + j + BXG_RING - 1);
      const uint4 w = a[j][0], x = a[j][1];  // rows g, g + 8
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= n8) break;
        const uint4* qs =
            q_s + ((c0 + j) * n8 + nt) * (32 * PARTS) + lane;
#pragma unroll
        for (int i = 0; i < PARTS; ++i) {
          const uint4 b = qs[32 * i];
          mma_bf16_16816(acc[nt], w.x, x.x, w.y, x.y, b.x, b.y);
          mma_bf16_16816(acc[nt], w.z, x.z, w.w, x.w, b.z, b.w);
        }
      }
    }
  }
  // acc[nt][2h + e] is row r0 + gq + 8h, slot 8nt + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    if (r >= block_t) continue;
    const float nrm = rownorm[row0 + r];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * nt + 2 * t + e;
        if (s < used)
          o[(long long)s * block_t + r] = nrm - 2.0f * acc[nt][2 * h + e];
      }
    }
  }
}

template <int PARTS>
static cudaError_t launch(const float* queries, const uint16_t* vecs,
                          const float* rownorm, const int* qidx,
                          const int* tog, float* out, int B, int D,
                          long long na, int groups, int rows, int block_t,
                          cudaStream_t stream) {
  // PARTS x 16 bytes per lane, chunk and n-tile of 8 slots: at most
  // 32 x 4 x 1.5 KB at D = 1024
  const size_t smem = (size_t)((D + 31) / 32) * ((rows + 7) / 8) *
                      (32 * PARTS) * sizeof(uint4);
  cudaError_t err = adc_allow_smem(budget_exact_grouped_kernel<PARTS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)groups,
                  (unsigned)((block_t + BXG_BLOCK_ROWS - 1) / BXG_BLOCK_ROWS));
  budget_exact_grouped_kernel<PARTS>
      <<<grid, BXG_WARPS * 32, smem, stream>>>(queries, vecs, rownorm, qidx,
                                               tog, out, B, D, block_t,
                                               (int)(na / block_t), rows);
  return cudaGetLastError();
}

// As pw2v_budget_exact_grouped with `parts` bf16 parts per query value (3,
// the kernel's, exact; 2 or 1 lose precision). For sweeps.
extern "C" int pw2v_budget_exact_grouped_parts(
    const void* queries, const void* vecs, const void* rownorm,
    const void* qidx, const void* tog, void* out, int B, int D, long long na,
    int groups, int rows, int block_t, int parts, void* stream) {
  if (B < 1 || groups < 1 || rows < 1 || rows > BXG_ROWS || D < 8 ||
      D % 8 != 0 || D > 1024 || !budget_shape_ok(na, block_t) ||
      (block_t + BXG_BLOCK_ROWS - 1) / BXG_BLOCK_ROWS > 65535)
    return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  const uint16_t* v = static_cast<const uint16_t*>(vecs);
  const float* rn = static_cast<const float*>(rownorm);
  const int* qi = static_cast<const int*>(qidx);
  const int* tg = static_cast<const int*>(tog);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 3: return launch<3>(q, v, rn, qi, tg, o, B, D, na, groups, rows,
                             block_t, s);
    case 2: return launch<2>(q, v, rn, qi, tg, o, B, D, na, groups, rows,
                             block_t, s);
    case 1: return launch<1>(q, v, rn, qi, tg, o, B, D, na, groups, rows,
                             block_t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int pw2v_budget_exact_grouped(const void* queries, const void* vecs,
                                         const void* rownorm, const void* qidx,
                                         const void* tog, void* out, int B,
                                         int D, long long na, int groups,
                                         int rows, int block_t, void* stream) {
  return pw2v_budget_exact_grouped_parts(queries, vecs, rownorm, qidx, tog,
                                         out, B, D, na, groups, rows, block_t,
                                         BXG_PARTS, stream);
}
