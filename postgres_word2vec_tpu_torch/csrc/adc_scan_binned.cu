// K4: ADC scan fused with a strided-bin min/argmin.
//
// For every block_n-row tile of the code table and every bin j < 128, bin j
// holds rows {tile*block_n + j + s*128 : s < block_n/128}. The kernel emits,
// per query, the float32 minimum of the ADC sums over the bin's rows and the
// global id of the row that holds it (smallest id on ties):
//
//   mins[b, tile*128 + j], ids[b, tile*128 + j] = tile*block_n + s*128 + j
//
// Rows at or past N count as +inf; a bin with no valid row keeps +inf and the
// id of its first row (s = 0). This is the bin and id convention of the TPU
// kernel, so the two compare bin by bin. The card takes bins = 128 (the TPU
// kernel's and every caller's); block_n is a multiple of 128.
//
// Replaces the TPU kernel _adc_binned_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_binned_pallas). The
// TPU version packs the argmin into the low mantissa bits of the minimum, a
// workaround for its compiler that floor-perturbs the min; here the true min
// and a separate argmin are kept in registers.
//
// Bound on the H100: shared-memory lookups. Every (query, row) pair costs m
// float32 lookups at random LUT entries, B*N*m*4 bytes in all (37.7 GB at
// B = 256, N = 3.07M, m = 12; ~1.3 ms at the card's ~30 TB/s of shared
// memory before bank conflicts); the output is block_n/128 (16x) smaller
// than the dense scan's, and the codes are read once per query block.
//
// Design. A block stages the LUTs of QB queries query-minor (adc_f32_stage:
// 16 queries, 192 KB at 12x256), so one 16-byte shared load fetches one
// lookup for four queries, and no per-query predicate is left in the loop
// (slots past B are zero). The block walks whole tiles: thread group j (four
// threads at QB = 16) owns bin j and walks its rows in increasing s with a
// strict <, each thread four of the queries; the four threads of a group
// read one 64-byte LUT entry together, so a quarter-warp of a 16-byte load
// touches two entries and meets at most a two-way bank conflict. The tile's
// codes reach shared memory by cp.async in slabs of `slab` 128-row steps
// (m x 1024 bytes at 12x256), double-buffered, so the copy of the next slab
// overlaps the lookups of this one. Each row's sum runs over subspaces
// j = 0..m-1 in order, so the minima equal the plain version's bit for bit.
// The walk is adc_walk (adc_common.cuh), shared with K2 and K3, which differ
// only in their lookups and epilogue; K4's epilogue is AdcBinMin below.
#include "adc_common.cuh"

#define AB_BINS ADC_ROWS  // bins per tile: one thread group each

// K4's epilogue: per thread and query the bin's min and its step s, kept in
// registers over the tile's rows (a strict <, rows in increasing s: the
// smallest id on ties) and written at the tile's end.
template <int F>
struct AdcBinMin {
  float* mins;
  int* ids;
  long long n_out;  // bins of all tiles
  int b0, nq, block_n, j, v;
  float best[F];
  int arg[F];

  __device__ __forceinline__ void tile_begin(long long) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      best[i] = __int_as_float(0x7f800000);  // +inf
      arg[i] = 0;
    }
  }

  template <typename Look>
  __device__ __forceinline__ void row(const Look& look, int s) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if (look.acc[i] < best[i]) {
        best[i] = look.acc[i];
        arg[i] = s;
      }
    }
  }

  __device__ __forceinline__ void tile_end(long long tile) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int q = v * F + i;
      if (q < nq) {
        const long long o = (long long)(b0 + q) * n_out + tile * AB_BINS + j;
        mins[o] = best[i];
        ids[o] = (int)(tile * block_n + (long long)arg[i] * AB_BINS + j);
      }
    }
  }
};

template <int QB, typename CodeT>
__global__ void __launch_bounds__(AB_BINS * AdcF32<QB>::L)
adc_scan_binned_kernel(const float* __restrict__ luts,
                       const CodeT* __restrict__ codes,
                       float* __restrict__ mins, int* __restrict__ ids,
                       int B, int m, int k, long long N, int block_n,
                       long long n_tiles, int slab, int async_codes) {
  using Look = AdcF32<QB>;
  extern __shared__ __align__(16) float lut_s[];
  const int mk = m * k;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  adc_f32_stage<QB>(lut_s, luts, b0, nq, mk);
  CodeT* code_s = reinterpret_cast<CodeT*>(
      reinterpret_cast<char*>(lut_s) + adc_lut_bytes(QB, mk, sizeof(float)));
  const int v = threadIdx.x % Look::L;
  Look look{lut_s, v};
  AdcBinMin<Look::F> epi{mins, ids, n_tiles * AB_BINS, b0, nq, block_n,
                         (int)threadIdx.x / Look::L, v};
  adc_walk<Look::L>(look, epi, codes, code_s, m, k, N, block_n, n_tiles,
                    slab, async_codes);
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const float* luts, const void* codes,
                             float* mins, int* ids, int B, int m, int k,
                             long long N, int block_n, cudaStream_t stream) {
  constexpr int threads = AB_BINS * AdcF32<QB>::L;
  const int cb = (int)sizeof(CodeT);
  const size_t lut = (size_t)QB * m * k * sizeof(float);
  const int slab = adc_walk_slab(lut, m, cb, block_n / AB_BINS);
  if (slab == 0) return cudaErrorInvalidValue;
  const size_t smem = adc_walk_smem(lut, m, cb, slab);
  cudaError_t err = adc_allow_smem(adc_scan_binned_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (N + block_n - 1) / block_n;
  const long long gy = (B + QB - 1) / QB;
  unsigned gx = 0;
  err = adc_walk_blocks(smem, threads, gy, n_tiles, &gx);
  if (err != cudaSuccess) return err;
  adc_scan_binned_kernel<QB, CodeT>
      <<<dim3(gx, (unsigned)gy), threads, smem, stream>>>(
          luts, static_cast<const CodeT*>(codes), mins, ids, B, m, k, N,
          block_n, n_tiles, slab, adc_async_codes(codes, N, cb));
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes, float* mins,
                          int* ids, int B, int m, int k, long long N,
                          int block_n, int bins, int qb,
                          cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || k < 1 || bins != AB_BINS ||
      block_n < AB_BINS || block_n % AB_BINS != 0)
    return cudaErrorInvalidValue;
  if (qb == 0)
    qb = adc_walk_query_block(16, 1, (size_t)m * k * sizeof(float), m,
                              (int)sizeof(CodeT));
  switch (qb) {
    case 16: return launch_qb<16, CodeT>(luts, codes, mins, ids, B, m, k, N,
                                         block_n, stream);
    case 8: return launch_qb<8, CodeT>(luts, codes, mins, ids, B, m, k, N,
                                       block_n, stream);
    case 4: return launch_qb<4, CodeT>(luts, codes, mins, ids, B, m, k, N,
                                       block_n, stream);
    case 2: return launch_qb<2, CodeT>(luts, codes, mins, ids, B, m, k, N,
                                       block_n, stream);
    case 1: return launch_qb<1, CodeT>(luts, codes, mins, ids, B, m, k, N,
                                       block_n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// As pw2v_adc_scan_binned with the queries per block forced to qb (16, 8,
// 4, 2 or 1; 0 chooses as pw2v_adc_scan_binned does). For sweeps.
extern "C" int pw2v_adc_scan_binned_qb(const void* luts, const void* codes,
                                       int code_bytes, void* mins, void* ids,
                                       int B, int m, int k, long long N,
                                       int block_n, int bins, int qb,
                                       void* stream) {
  const float* l = static_cast<const float*>(luts);
  float* mn = static_cast<float*>(mins);
  int* id = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes, mn, id, B, m, k, N, block_n, bins, qb,
                           s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes, mn, id, B, m, k, N, block_n, bins, qb,
                           s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_adc_scan_binned(const void* luts, const void* codes,
                                    int code_bytes, void* mins, void* ids,
                                    int B, int m, int k, long long N,
                                    int block_n, int bins, void* stream) {
  return pw2v_adc_scan_binned_qb(luts, codes, code_bytes, mins, ids, B, m, k,
                                 N, block_n, bins, 0, stream);
}
