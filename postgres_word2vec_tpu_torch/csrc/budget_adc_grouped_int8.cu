// K8: tile-grouped budgeted ADC over int8 LUTs, `rows` queries per block
// sharing one tile. K7's contract (budget_adc_grouped.cu) with int8 LUTs:
//
//   out[g*rows + s, r] = float(sum_j luts[q, j, codes_t[j, t*block_t + r]])
//                        * scale[q] + rowterm[t*block_t + r],
//   q = qidx[g, s], t = tog[g]
//
// luts (B, m, k) int8 in [-127, 127] as quantize_luts_int8 makes them. The
// sum is exact; the multiply and the add are rounded one at a time
// (__fmul_rn, then __fadd_rn), as the plain version rounds them, so no fused
// multiply-add makes the two differ and the finite results are the plain
// version's bit for bit. +inf in rowterm stays +inf, and a tile id outside
// the table reads as the inf tile.
//
// Replaces the TPU kernel _budget_adc_grouped_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_grouped_pallas
// with lut_dtype="int8"), which gathers an expanded (G*rows, m, k) int8 LUT
// copy and a per-slot scale in device memory and runs an int8 one-hot matmul.
//
// Bound on the H100: at the join's shape the launch is one wave of blocks, so
// its time is one block's chain of dependent device-memory reads (slot ids,
// then the LUTs they name) and then shared-memory lookups at random banks.
// What the design does about it:
// - the block finds its real slots with one ballot and asks for its code
//   tile by bulk copies (TMA) first, so the tile arrives while the LUTs are
//   staged;
// - it stages only as many slots as the group has, rounded up to 4, 8, 16
//   or 32 (W): a group of ten queries stages and sums 16, not 32, and two
//   thirds of the join's groups hold at most four;
// - the LUTs are read straight from the (B, m, k) tensor by qidx in 32-bit
//   words, biased to unsigned bytes and transposed in registers to the
//   query-minor layout of K3 and K5 (adc_u8_stage_ids), stored without bank
//   conflicts; each query's scale is fetched behind the same barrier;
// - a thread owns a code row and sums its lookups 16 queries at a time with
//   one 16-byte shared load per code, two biased bytes to a 16-bit lane
//   (AdcU8; one int32 per query past m = ADC_U8_MAX_M);
// - a warp's stores write 128 contiguous bytes of one slot's row, and slots
//   past the group's last query are neither summed nor written. Whole
//   padding groups return at once: the reassembly never reads them. Groups
//   on the inf tile (the plans' padding slots) write +inf and stage nothing
//   once the block has seen that the tile's row terms are all +inf.
// Groups wider than the block stages at a time (16 slots at 30x32, fewer for
// large LUTs such as the fused-pair 15x1024) take several passes over the
// staged tile.
#include "adc_common.cuh"
#include "budget_common.cuh"

#define K8_MAX_W 32  // slots staged at a time, at most
// Shared memory a block aims to stay under, LUTs and code tile together: an
// eighth of an SM's. At the join's 30x32 that stages 16 slots at a time (23
// KB; a full group takes two passes), which the sweep of chip_smoke.py found
// about a tenth faster than staging 32 (38 KB).
#define K8_SMEM_TARGET (28 * 1024)
// A block's dynamic shared memory: the SM's 227 KB less the static arrays.
#define K8_SMEM_MAX (ADC_SMEM_MAX - 1024)

// One pass over the tile's rows for the W staged slots, of which the first
// nq are real: the thread's rows, 16 (or W) queries a turn.
template <int W, bool Packed, typename CodeT>
__device__ __forceinline__ void k8_rows(const uint8_t* lut_s,
                                        const float* scale_s,
                                        const CodeT* code_s,
                                        const float* __restrict__ term,
                                        float* __restrict__ o, int m, int k,
                                        int block_t, int nq) {
  constexpr int F = W < 16 ? W : 16;  // queries of one turn
  constexpr int TURNS = W / F;
  for (int h = 0; h < TURNS && h * F < nq; ++h) {
    AdcU8<W, Packed, TURNS> look(lut_s, h, m, scale_s, 0, W);
    for (int r = threadIdx.x; r < block_t; r += blockDim.x) {
      const float rt = term[r];
      const CodeT* cr = code_s + r;
      look.clear();
#pragma unroll 6
      for (int j = 0; j < m; ++j)
        look.add(j * k + (int)cr[(size_t)j * block_t]);
#pragma unroll
      for (int i = 0; i < F; ++i)
        if (h * F + i < nq)
          o[(long long)(h * F + i) * block_t + r] =
              __fadd_rn(look.value(i), rt);
    }
  }
}

template <bool Packed, typename CodeT>
__global__ void __launch_bounds__(BUDGET_THREADS)
budget_adc_grouped_int8_kernel(const int8_t* __restrict__ luts,
                               const float* __restrict__ scale,
                               const CodeT* __restrict__ codes_t,
                               const float* __restrict__ rowterm,
                               const int* __restrict__ qidx,
                               const int* __restrict__ tog,
                               float* __restrict__ out, int B, int m, int k,
                               long long na, int block_t, int n_tiles,
                               int rows, int wmax, int bulk_tiles,
                               int word_luts) {
  extern __shared__ __align__(16) uint8_t lut_s[];
  __shared__ int qid_s[K8_MAX_W];
  __shared__ float scale_s[K8_MAX_W];
  __shared__ __align__(8) unsigned long long bar_s;  // the tile's mbarrier
  const int g = blockIdx.x;
  const int* q_of = qidx + (long long)g * rows;
  const int tile = tog[g];
  const int used = budget_used_slots(q_of, rows, B);
  if (used == 0) return;  // a padding group: nothing reads its rows
  float* o_g = out + (long long)g * rows * block_t;
  // a group on the inf tile (the plans' padding) is +inf whatever its LUTs
  if (!budget_tile_ok(tile, n_tiles) ||
      (tile == n_tiles - 1 &&
       budget_last_tile_is_inf(rowterm, n_tiles, block_t))) {
    for (int i = threadIdx.x; i < used * block_t; i += blockDim.x)
      o_g[i] = budget_inf();
    return;
  }
  const int mk = m * k;
  const long long row0 = (long long)tile * block_t;
  CodeT* code_s =
      reinterpret_cast<CodeT*>(lut_s + budget_round16((size_t)wmax * mk));
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
  for (int s0 = 0; s0 < used;) {
    const int left = used - s0;
    int w = wmax;  // the least width that takes what is left
    while (w > 4 && w / 2 >= left) w /= 2;
    const int nq = min(w, left);
    if (s0 > 0) __syncthreads();  // the last pass is done with lut_s
    int id = -1;
    if (threadIdx.x < w) {
      if (threadIdx.x < nq) {
        const int qi = q_of[s0 + threadIdx.x];
        if (qi >= 0 && qi < B) id = qi;
      }
      qid_s[threadIdx.x] = id;
    }
    __syncthreads();
    const float sc = id >= 0 ? scale[id] : 0.f;
    switch (w) {
      case 32: adc_u8_stage_ids<32>(lut_s, luts, qid_s, mk, word_luts); break;
      case 16: adc_u8_stage_ids<16>(lut_s, luts, qid_s, mk, word_luts); break;
      case 8: adc_u8_stage_ids<8>(lut_s, luts, qid_s, mk, word_luts); break;
      default: adc_u8_stage_ids<4>(lut_s, luts, qid_s, mk, word_luts); break;
    }
    if (threadIdx.x < w) scale_s[threadIdx.x] = sc;
    __syncthreads();
    if (bulk_tiles && s0 == 0) mbar_wait(adc_smem_addr(&bar_s), 0);
    float* o = o_g + (long long)s0 * block_t;
    const float* term = rowterm + row0;
#define PW2V_K8_ROWS(W)                                                      \
  k8_rows<W, Packed, CodeT>(lut_s, scale_s, code_s, term, o, m, k, block_t, \
                            nq)
    switch (w) {
      case 32: PW2V_K8_ROWS(32); break;
      case 16: PW2V_K8_ROWS(16); break;
      case 8: PW2V_K8_ROWS(8); break;
      default: PW2V_K8_ROWS(4); break;
    }
#undef PW2V_K8_ROWS
    s0 += w;
  }
}

// Shared memory of a block that stages up to w slots beside its code tile.
static inline size_t k8_smem(int w, int mk, int m, int block_t, int cb) {
  return budget_round16((size_t)w * mk) + (size_t)m * block_t * cb;
}

template <bool Packed, typename CodeT>
static cudaError_t launch_packed(const int8_t* luts, const float* scale,
                                 const CodeT* codes_t, const float* rowterm,
                                 const int* qidx, const int* tog, float* out,
                                 int B, int m, int k, long long na,
                                 int groups, int rows, int block_t, int wmax,
                                 cudaStream_t stream) {
  const int cb = (int)sizeof(CodeT);
  const size_t smem = k8_smem(wmax, m * k, m, block_t, cb);
  cudaError_t err = adc_allow_smem(
      budget_adc_grouped_int8_kernel<Packed, CodeT>, smem);
  if (err != cudaSuccess) return err;
  budget_adc_grouped_int8_kernel<Packed, CodeT>
      <<<groups, BUDGET_THREADS, smem, stream>>>(
          luts, scale, codes_t, rowterm, qidx, tog, out, B, m, k, na, block_t,
          (int)(na / block_t), rows, wmax,
          budget_bulk_tiles(codes_t, rowterm, na, block_t, block_t, cb),
          reinterpret_cast<uintptr_t>(luts) % 4 == 0 && (m * k) % 4 == 0);
  return cudaGetLastError();
}

// wmax: the most slots staged at a time, 4, 8, 16 or 32; 0 lets the kernel
// choose the largest whose LUTs fit beside the tile in K8_SMEM_TARGET (in a
// block's shared memory at all, for very large LUTs).
template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes_t, const float* rowterm,
                          const int* qidx, const int* tog, float* out, int B,
                          int m, int k, long long na, int groups, int rows,
                          int block_t, int wmax, cudaStream_t stream) {
  if (B < 1 || m < 1 || k < 1 || groups < 1 || rows < 1 ||
      !budget_shape_ok(na, block_t))
    return cudaErrorInvalidValue;
  const int cb = (int)sizeof(CodeT);
  if (wmax == 0) {
    for (int w = K8_MAX_W; w >= 4 && wmax == 0; w /= 2)
      if (k8_smem(w, m * k, m, block_t, cb) <= K8_SMEM_TARGET) wmax = w;
    for (int w = K8_MAX_W; w >= 4 && wmax == 0; w /= 2)
      if (k8_smem(w, m * k, m, block_t, cb) <= K8_SMEM_MAX) wmax = w;
  }
  if ((wmax != 4 && wmax != 8 && wmax != 16 && wmax != 32) ||
      k8_smem(wmax, m * k, m, block_t, cb) > K8_SMEM_MAX)
    return cudaErrorInvalidValue;
  const CodeT* c = static_cast<const CodeT*>(codes_t);
  if (m <= ADC_U8_MAX_M)
    return launch_packed<true, CodeT>(luts, scale, c, rowterm, qidx, tog, out,
                                      B, m, k, na, groups, rows, block_t,
                                      wmax, stream);
  return launch_packed<false, CodeT>(luts, scale, c, rowterm, qidx, tog, out,
                                     B, m, k, na, groups, rows, block_t, wmax,
                                     stream);
}

// The entry point with the staged width given (0: the kernel's choice), for
// sweeps and tests.
extern "C" int pw2v_budget_adc_grouped_int8_w(
    const void* luts, const void* scale, const void* codes_t, int code_bytes,
    const void* rowterm, const void* qidx, const void* tog, void* out, int B,
    int m, int k, long long na, int groups, int rows, int block_t, int wmax,
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
                           rows, block_t, wmax, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, sc, codes_t, rt, qi, tg, o, B, m, k, na, groups,
                           rows, block_t, wmax, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_budget_adc_grouped_int8(
    const void* luts, const void* scale, const void* codes_t, int code_bytes,
    const void* rowterm, const void* qidx, const void* tog, void* out, int B,
    int m, int k, long long na, int groups, int rows, int block_t,
    void* stream) {
  return pw2v_budget_adc_grouped_int8_w(luts, scale, codes_t, code_bytes,
                                        rowterm, qidx, tog, out, B, m, k, na,
                                        groups, rows, block_t, 0, stream);
}
