// K7: tile-grouped budgeted ADC, up to `rows` (query, slot) pairs per block
// sharing one tile, written straight into K6's (B, P*block_t) result.
//
// The pairs of a budget probe (pair i = b*P + p: query b, slot p) are grouped
// by tile on the card (budget_pair_layout.cu): group g holds up to `rows`
// pairs pairs[g, :] (-1 marks an unused slot; the real ones come first), all
// probing tile t = tog[g]. For each real slot, pair i:
//
//   out[i*block_t + r] = sum_j luts[i / P, j, codes_t[j, t*block_t + r]]
//                        + rowterm[t*block_t + r]
//
// luts (B, m, k) float32, codes_t (m, NA) uint8/int16 cell-aligned codes,
// rowterm (NA,) float32 (+inf on pad rows and the inf tile). Sums run over
// subspaces in order, then the row term is added, as in the plain version
// (budget_adc_plain), so the results are the plain version's bit for bit;
// +inf stays +inf, and a tile id outside the table writes +inf and reads
// nothing.
//
// Replaces the TPU kernel _budget_adc_grouped_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_grouped_pallas),
// which gathers an expanded (G*rows, m, k) bf16 LUT copy in device memory,
// runs the lookup as a one-hot matmul and gathers its (G*rows, block_t)
// output back by row.
//
// Bound on the H100: at the join's shape (30x32 LUTs, 256-row tiles) the
// launch is about one wave of blocks, so a block's chain (its slot ids, then
// the LUTs they name, then the sums) is the kernel's time, and the sums are
// bound by their shared-memory lookups. What the design does about it:
// - the result has K6's layout: slot s of group g writes row pairs[g, s] of
//   the (B, P*block_t) output, so no grouped copy of the output is written,
//   read back and gathered, and a warp's stores fill 128 contiguous bytes of
//   one pair's row;
// - one ballot finds the group's real slots; a padding group returns at
//   once;
// - a group on the inf tile (the plans' padding, about half of a join's
//   pairs) writes +inf into its pairs' rows without copying or summing, once
//   the block has seen that the tile's row terms are all +inf;
// - the first warp asks for the code tile by bulk copies (TMA) before the
//   LUTs are staged, so the tile arrives meanwhile (plain copies where a
//   tile's code runs are not 16-byte aligned, e.g. block_t = 100);
// - a pass stages only the least width W (1, 2, 4, 8 or 16 slots) that
//   holds the group's slots left, up to the launch's widest, which keeps the
//   LUTs and the tile within K7_SMEM_TARGET; a larger group takes several
//   passes over the staged tile;
// - the LUTs are staged query-major, copied by query id in 16-byte words. At
//   the join's k = 32 a LUT row fills the 32 banks once, so the lookups of a
//   warp (one code each) never collide; query-minor LUTs (entry r of the W
//   slots one run of W floats, read 16 bytes at a time) let eight lanes meet
//   in two to four bank groups and measured slower on an H100 (PERF.md);
// - a thread owns a code row and sums each staged query over subspaces in
//   order. At the join's shape (k = 32, m <= 32) the strides are fixed at
//   compile time (LUT rows 32 floats apart, a query's LUT 1024), so every
//   offset of a lookup but its code's is an immediate;
// - the entry point for sweeps can give a thread four neighbouring rows and
//   four of a wide pass's slots instead (one shared load for four codes, one
//   16-byte store a pair, as in K6); at the join's plan one row measured
//   faster (PERF.md), so the kernel keeps one row a thread (K7_RPT).
#include "adc_common.cuh"
#include "budget_common.cuh"

#define K7_MAX_W 16  // slots staged at a time, at most
// Shared memory a block aims to stay under, LUTs and code tile together. At
// the join's 30x32 that stages 16 slots at a time (72 KB, three blocks an
// SM), which the sweep of chip_smoke.py found a twentieth faster than 8.
#define K7_SMEM_TARGET (72 * 1024)
// A block's dynamic shared memory: the SM's 227 KB less the static arrays.
#define K7_SMEM_MAX (ADC_SMEM_MAX - 1024)
// Rows a thread where the caller leaves it to the kernel (1 or 4; four only
// on passes that keep half the block busy).
#define K7_RPT 1
// The fixed strides: LUT rows KS = 32 floats apart, a query's LUT K7_FIXED_QS.
#define K7_FIXED_QS (32 * 32)

// Floats between two staged LUTs: K7_FIXED_QS with fixed strides, else mk
// rounded up to a whole row of banks.
__host__ __device__ inline int k7_lut_stride(int ks, int mk) {
  return ks ? K7_FIXED_QS : (mk + 31) / 32 * 32;
}

// Stage the float32 LUTs of the w slots' queries qid_s[0 .. w) query-major,
// slot q's at lut_s + q*qs; a slot of id -1 stages nothing (its sums are
// never stored). With vec (every LUT 16-byte aligned: the base is and mk %
// 4 == 0) in 16-byte words, else a float at a time.
__device__ __forceinline__ void k7_stage(float* lut_s,
                                         const float* __restrict__ luts,
                                         const int* qid_s, int w, int mk,
                                         int qs, int vec) {
  if (vec) {
    const int m4 = mk / 4;
    for (int i = threadIdx.x; i < w * m4; i += blockDim.x) {
      const int q = i / m4;
      const int r4 = i - q * m4;
      const int id = qid_s[q];
      if (id >= 0)
        *reinterpret_cast<float4*>(lut_s + q * qs + 4 * r4) =
            __ldg(reinterpret_cast<const float4*>(luts + (long long)id * mk) +
                  r4);
    }
  } else {
    for (int i = threadIdx.x; i < w * mk; i += blockDim.x) {
      const int q = i / mk;
      const int r = i - q * mk;
      const int id = qid_s[q];
      if (id >= 0) lut_s[q * qs + r] = __ldg(luts + (long long)id * mk + r);
    }
  }
}

// The codes of rows r .. r+R-1 of one subspace's run, from run + r: one
// shared load for four rows (run and r 4-aligned), else one a row.
template <int R, typename CodeT>
__device__ __forceinline__ void k7_codes(const CodeT* c, int (&code)[R]) {
  if constexpr (R == 4 && sizeof(CodeT) == 1) {
    const unsigned w = *reinterpret_cast<const unsigned*>(c);
#pragma unroll
    for (int i = 0; i < 4; ++i) code[i] = (int)((w >> (8 * i)) & 0xffu);
  } else if constexpr (R == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(c);
    code[0] = (int)(short)(w.x & 0xffffu);
    code[1] = (int)(short)(w.x >> 16);
    code[2] = (int)(short)(w.y & 0xffffu);
    code[3] = (int)(short)(w.y >> 16);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) code[i] = (int)c[i];
  }
}

// One pass over the tile's rows for the W staged slots, of which the first
// nq are real. A thread takes R neighbouring rows (1; or 4, whose codes come
// in one shared load and whose sums leave a pair in one 16-byte store) for
// QT of the staged slots: all W with one row, four with four rows, so the
// block's threads split the slots of a wide pass. KS: the fixed LUT row
// stride (k = 32 and query stride K7_FIXED_QS), or 0 for k and qs at run
// time.
template <int W, int R, int KS, typename CodeT>
__device__ __forceinline__ void k7_rows(const float* lut_s,
                                        const CodeT* code_s,
                                        const int* pair_s,
                                        const float* __restrict__ term,
                                        float* __restrict__ out, int m,
                                        int k_, int qs_, int block_t,
                                        int nq) {
  constexpr int QT = (R == 1 || W < 4) ? W : 4;
  constexpr int CH = W / QT;  // chunks of QT slots
  const int k = KS ? KS : k_;
  const int qs = KS ? K7_FIXED_QS : qs_;
  const int nr = block_t / R;
  for (int u = threadIdx.x; u < nr * CH; u += blockDim.x) {
    const int c = CH == 1 ? 0 : u / nr;
    const int q0 = c * QT;
    if (q0 >= nq) continue;  // a chunk of padding slots
    const int r = (u - c * nr) * R;
    const float* lut_c = lut_s + q0 * qs;
    float acc[R][QT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < QT; ++q) acc[i][q] = 0.f;
#pragma unroll 6
    for (int j = 0; j < m; ++j) {
      int code[R];
      k7_codes<R, CodeT>(code_s + (size_t)j * block_t + r, code);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float* e = lut_c + j * k + code[i];
#pragma unroll
        for (int q = 0; q < QT; ++q)
          if (q0 + q < nq) acc[i][q] += e[q * qs];
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const int p = q0 + q < nq ? pair_s[q0 + q] : -1;
      if (p < 0) continue;
      float* o = out + (long long)p * block_t + r;
      if constexpr (R == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[0][q] + __ldg(term + r),
                        acc[1][q] + __ldg(term + r + 1),
                        acc[2][q] + __ldg(term + r + 2),
                        acc[3][q] + __ldg(term + r + 3));
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) o[i] = acc[i][q] + __ldg(term + r + i);
      }
    }
  }
}

// RPT: the rows a thread (1, or 4 on the passes that keep half the block
// busy), an instantiation of its own so that four rows' registers do not
// cost the one-row kernel resident blocks. (A minimum of two blocks an SM
// lifts ptxas's own cap of 64 registers, at which the int16 instantiation
// spilled.)
template <int KS, int RPT, typename CodeT>
__global__ void __launch_bounds__(BUDGET_THREADS, 2)
budget_adc_grouped_kernel(const float* __restrict__ luts,
                          const CodeT* __restrict__ codes_t,
                          const float* __restrict__ rowterm,
                          const int* __restrict__ pairs,
                          const int* __restrict__ tog,
                          float* __restrict__ out, int P, int bp, int m,
                          int k, long long na, int block_t, int n_tiles,
                          int rows, int wmax, int bulk_tiles, int vec_luts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pair_s[K7_MAX_W];
  __shared__ int qid_s[K7_MAX_W];
  __shared__ __align__(8) unsigned long long bar_s;  // the tile's mbarrier
  const int g = blockIdx.x;
  const int* p_of = pairs + (long long)g * rows;
  const int tile = tog[g];
  const int used = budget_used_slots(p_of, rows, bp);
  if (used == 0) return;  // a padding group
  // a group on the inf tile (the plans' padding) is +inf whatever its LUTs
  if (!budget_tile_ok(tile, n_tiles) ||
      (tile == n_tiles - 1 &&
       budget_last_tile_is_inf(rowterm, n_tiles, block_t))) {
    const int lane = threadIdx.x & 31;
    const bool wide = block_t % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const float inf = budget_inf();
    for (int s = threadIdx.x >> 5; s < used; s += blockDim.x >> 5) {
      const int p = p_of[s];
      if (p < 0 || p >= bp) continue;
      float* o = out + (long long)p * block_t;
      if (wide)
        for (int r = 4 * lane; r < block_t; r += 128)
          *reinterpret_cast<float4*>(o + r) = make_float4(inf, inf, inf, inf);
      else
        for (int r = lane; r < block_t; r += 32) o[r] = inf;
    }
    return;
  }
  const int mk = m * k;
  const int qs = k7_lut_stride(KS, mk);
  const long long row0 = (long long)tile * block_t;
  float* lut_s = reinterpret_cast<float*>(smem);
  CodeT* code_s = reinterpret_cast<CodeT*>(
      smem + budget_round16((size_t)wmax * qs * sizeof(float)));
  if (bulk_tiles) {
    if (threadIdx.x == 0) {
      mbar_init(adc_smem_addr(&bar_s), 1);
      mbar_init_fence();
    }
    __syncwarp();  // the first warp asks, so only it needs the mbarrier yet
  }
  budget_copy_rows<CodeT>(code_s, nullptr, codes_t, rowterm, na, m, row0,
                          block_t, block_t, bulk_tiles,
                          adc_smem_addr(&bar_s), threadIdx.x, blockDim.x);
  const float* term = rowterm + row0;
  for (int s0 = 0; s0 < used;) {
    const int left = used - s0;
    int w = wmax;  // the least width that takes what is left
    while (w > 1 && w / 2 >= left) w /= 2;
    const int nq = min(w, left);
    if (s0 > 0) __syncthreads();  // the last pass is done with lut_s
    if (threadIdx.x < w) {
      int p = threadIdx.x < nq ? p_of[s0 + threadIdx.x] : -1;
      if (p >= bp) p = -1;
      pair_s[threadIdx.x] = p;
      qid_s[threadIdx.x] = p >= 0 ? p / P : -1;
    }
    __syncthreads();
    k7_stage(lut_s, luts, qid_s, w, mk, qs, vec_luts);
    __syncthreads();
    if (bulk_tiles && s0 == 0) mbar_wait(adc_smem_addr(&bar_s), 0);
    // four rows a thread where the pass still keeps half the block busy
    const bool r4 =
        RPT == 4 && (block_t / 4) * (w / 4) >= (int)blockDim.x / 2;
#define PW2V_K7_ROWS(W, R)                                                \
  k7_rows<W, R, KS, CodeT>(lut_s, code_s, pair_s, term, out, m, k, qs,     \
                           block_t, nq)
    switch (w) {
      case 16: if (r4) PW2V_K7_ROWS(16, RPT); else PW2V_K7_ROWS(16, 1); break;
      case 8: if (r4) PW2V_K7_ROWS(8, RPT); else PW2V_K7_ROWS(8, 1); break;
      case 4: if (r4) PW2V_K7_ROWS(4, RPT); else PW2V_K7_ROWS(4, 1); break;
      case 2: PW2V_K7_ROWS(2, 1); break;
      default: PW2V_K7_ROWS(1, 1); break;
    }
#undef PW2V_K7_ROWS
    s0 += w;
  }
}

// Shared memory of a block that stages up to w LUTs qs floats apart beside
// its code tile.
static inline size_t k7_smem(int w, int qs, int m, int block_t, int cb) {
  return budget_round16((size_t)w * qs * sizeof(float)) +
         (size_t)m * block_t * cb;
}

template <int KS, int RPT, typename CodeT>
static cudaError_t launch_rpt(const float* luts, const CodeT* codes_t,
                              const float* rowterm, const int* pairs,
                              const int* tog, float* out, int B, int m,
                              int k, long long na, int P, int groups,
                              int rows, int block_t, int wmax, size_t smem,
                              cudaStream_t stream) {
  const int cb = (int)sizeof(CodeT);
  cudaError_t err =
      adc_allow_smem(budget_adc_grouped_kernel<KS, RPT, CodeT>, smem);
  if (err != cudaSuccess) return err;
  budget_adc_grouped_kernel<KS, RPT, CodeT>
      <<<groups, BUDGET_THREADS, smem, stream>>>(
          luts, codes_t, rowterm, pairs, tog, out, P, B * P, m, k, na,
          block_t, (int)(na / block_t), rows, wmax,
          budget_bulk_tiles(codes_t, rowterm, na, block_t, block_t, cb),
          reinterpret_cast<uintptr_t>(luts) % 16 == 0 && (m * k) % 4 == 0);
  return cudaGetLastError();
}

template <int KS, typename CodeT>
static cudaError_t launch_ks(const float* luts, const CodeT* codes_t,
                             const float* rowterm, const int* pairs,
                             const int* tog, float* out, int B, int m, int k,
                             long long na, int P, int groups, int rows,
                             int block_t, int wmax, int rpt,
                             cudaStream_t stream) {
  const int cb = (int)sizeof(CodeT);
  const int qs = k7_lut_stride(KS, m * k);
  if (wmax == 0) {
    for (int w = K7_MAX_W; w >= 1 && wmax == 0; w /= 2)
      if (k7_smem(w, qs, m, block_t, cb) <= K7_SMEM_TARGET) wmax = w;
    for (int w = K7_MAX_W; w >= 1 && wmax == 0; w /= 2)
      if (k7_smem(w, qs, m, block_t, cb) <= K7_SMEM_MAX) wmax = w;
  }
  if (rpt == 0) rpt = K7_RPT;
  if (wmax < 1 || wmax > K7_MAX_W || (wmax & (wmax - 1)) != 0 ||
      k7_smem(wmax, qs, m, block_t, cb) > K7_SMEM_MAX ||
      (rpt != 1 && rpt != 4))
    return cudaErrorInvalidValue;
  const size_t smem = k7_smem(wmax, qs, m, block_t, cb);
  // four rows a thread need whole quads of rows and 16-byte output rows
  if (rpt == 4 && block_t % 4 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_rpt<KS, 4, CodeT>(luts, codes_t, rowterm, pairs, tog, out,
                                    B, m, k, na, P, groups, rows, block_t,
                                    wmax, smem, stream);
  return launch_rpt<KS, 1, CodeT>(luts, codes_t, rowterm, pairs, tog, out, B,
                                  m, k, na, P, groups, rows, block_t, wmax,
                                  smem, stream);
}

// wmax: the most slots staged at a time, a power of two up to K7_MAX_W; 0
// lets the kernel choose the largest whose LUTs fit beside the tile in
// K7_SMEM_TARGET (in a block's shared memory at all, for large LUTs). The
// join's shape (k = 32, m <= 32) takes the fixed strides.
template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes_t,
                          const float* rowterm, const int* pairs,
                          const int* tog, float* out, int B, int m, int k,
                          long long na, int P, int groups, int rows,
                          int block_t, int wmax, int rpt,
                          cudaStream_t stream) {
  if (B < 1 || P < 1 || m < 1 || k < 1 || groups < 1 || rows < 1 ||
      (long long)B * P > 0x7fffffffLL || !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const CodeT* c = static_cast<const CodeT*>(codes_t);
  if (k == 32 && m <= 32)
    return launch_ks<32, CodeT>(luts, c, rowterm, pairs, tog, out, B, m, k,
                                na, P, groups, rows, block_t, wmax, rpt,
                                stream);
  return launch_ks<0, CodeT>(luts, c, rowterm, pairs, tog, out, B, m, k, na,
                             P, groups, rows, block_t, wmax, rpt, stream);
}

// The entry point with the widest staging and the rows a thread (1 or 4)
// given (0: the kernel's choice), for sweeps and tests. pairs (groups, rows) and tog (groups,) come from
// pw2v_budget_pair_layout; out is the (B, P*block_t) result.
extern "C" int pw2v_budget_adc_grouped_w(
    const void* luts, const void* codes_t, int code_bytes,
    const void* rowterm, const void* pairs, const void* tog, void* out,
    int B, int m, int k, long long na, int P, int groups, int rows,
    int block_t, int wmax, int rpt, void* stream) {
  const float* l = static_cast<const float*>(luts);
  const float* rt = static_cast<const float*>(rowterm);
  const int* pr = static_cast<const int*>(pairs);
  const int* tg = static_cast<const int*>(tog);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes_t, rt, pr, tg, o, B, m, k, na, P, groups,
                           rows, block_t, wmax, rpt, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes_t, rt, pr, tg, o, B, m, k, na, P, groups,
                           rows, block_t, wmax, rpt, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_budget_adc_grouped(const void* luts, const void* codes_t,
                                       int code_bytes, const void* rowterm,
                                       const void* pairs, const void* tog,
                                       void* out, int B, int m, int k,
                                       long long na, int P, int groups,
                                       int rows, int block_t, void* stream) {
  return pw2v_budget_adc_grouped_w(luts, codes_t, code_bytes, rowterm, pairs,
                                   tog, out, B, m, k, na, P, groups, rows,
                                   block_t, 0, 0, stream);
}
