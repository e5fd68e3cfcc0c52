// K2: dense ADC scan, (B, m, k) float32 LUTs x (m, N) codes -> (B, N) float32.
//
//   out[b, n] = sum_j luts[b, j, codes[j, n]]
//
// Replaces the TPU kernel _adc_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_pallas), which turns
// each lookup into a one-hot matmul for the TPU's matrix unit. On Hopper the
// lookup is a shared-memory read. Any B and N: the ragged query block and
// the ragged end of N are masked in the kernel; nothing is padded.
//
// Bound on the H100: the B*N*4-byte output (3.15 GB at 256 x 3.07M, 0.95 ms
// at 3.35 TB/s) and the shared-memory lookups, B*N*m*4 bytes (37.7 GB at
// m = 12, ~1.3 ms at the card's ~30 TB/s of shared memory).
//
// Design. The lookups are K4's (adc_scan_binned.cu) through the shared walk
// (adc_walk, adc_common.cuh): 16 queries' float32 LUTs staged query-minor
// (192 KB at 12x256; 8, 4, 2 or 1 queries for larger m*k), four threads per
// code row reading one 64-byte entry together, codes by cp.async in
// double-buffered slabs of 1024 rows, each sum over subspaces j = 0..m-1 in
// order, so the result equals the plain version bit for bit. The output
// leaves through the dense epilogue (AdcDense): each thread stores its four
// results itself, a warp filling whole 32-byte sectors of four query rows;
// the stores drain while the thread goes on to its next row's lookups, so
// the output's HBM time hides under the lookups'. (Gathering a slab's output
// in a shared tile first, to write 512-byte runs, cost shared memory, a
// smaller slab and a barrier per slab, and was slower on the H100.)
#include "adc_common.cuh"

template <int QB, typename CodeT>
__global__ void __launch_bounds__(ADC_ROWS * AdcF32<QB>::L)
adc_scan_kernel(const float* __restrict__ luts,
                const CodeT* __restrict__ codes, float* __restrict__ out,
                int B, int m, int k, long long N, long long n_tiles, int slab,
                int async_codes) {
  using Look = AdcF32<QB>;
  extern __shared__ __align__(16) float lut_s[];
  const int mk = m * k;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  adc_f32_stage<QB>(lut_s, luts, b0, nq, mk);
  CodeT* code_s = reinterpret_cast<CodeT*>(
      reinterpret_cast<char*>(lut_s) + adc_lut_bytes(QB, mk, sizeof(float)));
  const int rows = slab * ADC_ROWS;
  const int v = threadIdx.x % Look::L;
  Look look{lut_s, v};
  AdcDense<Look::F> epi{out, N, b0, nq, rows, (int)threadIdx.x / Look::L, v};
  adc_walk<Look::L>(look, epi, codes, code_s, m, k, N, rows, n_tiles, slab,
                    async_codes);
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const float* luts, const void* codes, float* out,
                             int B, int m, int k, long long N,
                             cudaStream_t stream) {
  constexpr int threads = ADC_ROWS * AdcF32<QB>::L;
  const int cb = (int)sizeof(CodeT);
  const size_t lut = (size_t)QB * m * k * sizeof(float);
  const int slab = adc_walk_slab(lut, m, cb, 8);
  if (slab == 0) return cudaErrorInvalidValue;
  const size_t smem = adc_walk_smem(lut, m, cb, slab);
  cudaError_t err = adc_allow_smem(adc_scan_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)slab * ADC_ROWS;
  const long long n_tiles = (N + rows - 1) / rows;
  const long long gy = (B + QB - 1) / QB;
  unsigned gx = 0;
  err = adc_walk_blocks(smem, threads, gy, n_tiles, &gx);
  if (err != cudaSuccess) return err;
  adc_scan_kernel<QB, CodeT><<<dim3(gx, (unsigned)gy), threads, smem,
                               stream>>>(
      luts, static_cast<const CodeT*>(codes), out, B, m, k, N, n_tiles, slab,
      adc_async_codes(codes, N, cb));
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes, float* out,
                          int B, int m, int k, long long N, int qb,
                          cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  if (qb == 0)
    qb = adc_walk_query_block(16, 1, (size_t)m * k * sizeof(float), m,
                              (int)sizeof(CodeT));
#define PW2V_K2(q) launch_qb<q, CodeT>(luts, codes, out, B, m, k, N, stream)
  switch (qb) {
    case 16: return PW2V_K2(16);
    case 8: return PW2V_K2(8);
    case 4: return PW2V_K2(4);
    case 2: return PW2V_K2(2);
    case 1: return PW2V_K2(1);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K2
}

// As pw2v_adc_scan with the queries per block forced to qb (16, 8, 4, 2 or
// 1; 0 chooses as pw2v_adc_scan does). For sweeps.
extern "C" int pw2v_adc_scan_qb(const void* luts, const void* codes,
                                int code_bytes, void* out, int B, int m,
                                int k, long long N, int qb, void* stream) {
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes, o, B, m, k, N, qb, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes, o, B, m, k, N, qb, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_adc_scan(const void* luts, const void* codes,
                             int code_bytes, void* out, int B, int m, int k,
                             long long N, void* stream) {
  return pw2v_adc_scan_qb(luts, codes, code_bytes, out, B, m, k, N, 0, stream);
}
