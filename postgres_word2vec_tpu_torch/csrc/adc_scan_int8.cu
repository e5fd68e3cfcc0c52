// K3: dense ADC scan over int8 LUTs, (B, m, k) int8 LUTs + (B,) float32
// scales x (m, N) codes -> (B, N) float32.
//
//   out[b, n] = float(sum_j luts[b, j, codes[j, n]]) * scale[b]
//
// The sum is exact; the one multiply is rounded as the plain version rounds
// it, so the two agree bit for bit.
//
// Replaces the TPU kernel _adc_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_pallas with
// lut_dtype="int8"), which runs an int8 one-hot matmul on the TPU's matrix
// unit. Here the lookup is a shared-memory read. The per-query scale comes
// from the torch glue (ops/kernels.py quantize_luts_int8); the kernel does
// not recompute it. Any B and N: the ragged edges are masked in the kernel.
//
// Bound on the H100: the B*N*4-byte output (3.15 GB at 256 x 3.07M, 0.95 ms
// at 3.35 TB/s). A query's int8 LUT is a quarter of its float32 one, so the
// lookups are B*N*m bytes (9.4 GB at m = 12) and the integer adds that sum
// them: neither comes near the output's time once they are packed.
//
// Design. The walk is K2's and K4's (adc_walk, adc_common.cuh): up to 64
// queries' LUTs staged query-minor and biased to uint8 (192 KB at 12x256),
// four threads per code row each reading 16 adjacent bytes of one 64-byte
// entry (16 queries), so a quarter-warp's 16-byte loads touch two entries;
// codes by cp.async in double-buffered slabs. The bytes are summed two to a
// 16-bit lane (AdcU8: four lookups in four integer operations, exact while
// m <= 258; a larger m keeps one int32 per query). The output leaves through
// K2's dense epilogue (AdcDense): each thread stores its 16 results itself,
// a warp filling whole 32-byte sectors of four query rows, and the stores
// drain under the next rows' lookups.
#include "adc_common.cuh"

template <int QB, bool Packed, typename CodeT>
__global__ void __launch_bounds__(ADC_ROWS * AdcU8<QB, Packed>::L)
adc_scan_int8_kernel(const int8_t* __restrict__ luts,
                     const float* __restrict__ scale,
                     const CodeT* __restrict__ codes, float* __restrict__ out,
                     int B, int m, int k, long long N, long long n_tiles,
                     int slab, int async_codes) {
  using Look = AdcU8<QB, Packed>;
  extern __shared__ __align__(16) uint8_t lut_u8[];
  const int mk = m * k;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  adc_u8_stage<QB>(lut_u8, luts, b0, nq, mk);
  CodeT* code_s = reinterpret_cast<CodeT*>(reinterpret_cast<char*>(lut_u8) +
                                            adc_lut_bytes(QB, mk, 1));
  const int rows = slab * ADC_ROWS;
  const int v = threadIdx.x % Look::L;
  Look look(lut_u8, v, m, scale, b0, nq);
  AdcDense<Look::F> epi{out, N, b0, nq, rows, (int)threadIdx.x / Look::L, v};
  adc_walk<Look::L>(look, epi, codes, code_s, m, k, N, rows, n_tiles, slab,
                    async_codes);
}

template <int QB, bool Packed, typename CodeT>
static cudaError_t launch_qb(const int8_t* luts, const float* scale,
                             const void* codes, float* out, int B, int m,
                             int k, long long N, cudaStream_t stream) {
  constexpr int threads = ADC_ROWS * AdcU8<QB, Packed>::L;
  const int cb = (int)sizeof(CodeT);
  const size_t lut = (size_t)QB * m * k;
  const int slab = adc_walk_slab(lut, m, cb, 8);
  if (slab == 0) return cudaErrorInvalidValue;
  const size_t smem = adc_walk_smem(lut, m, cb, slab);
  cudaError_t err =
      adc_allow_smem(adc_scan_int8_kernel<QB, Packed, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)slab * ADC_ROWS;
  const long long n_tiles = (N + rows - 1) / rows;
  const long long gy = (B + QB - 1) / QB;
  unsigned gx = 0;
  err = adc_walk_blocks(smem, threads, gy, n_tiles, &gx);
  if (err != cudaSuccess) return err;
  adc_scan_int8_kernel<QB, Packed, CodeT>
      <<<dim3(gx, (unsigned)gy), threads, smem, stream>>>(
          luts, scale, static_cast<const CodeT*>(codes), out, B, m, k, N,
          n_tiles, slab, adc_async_codes(codes, N, cb));
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes, float* out, int B, int m, int k,
                          long long N, int qb, cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  if (qb == 0)
    qb = adc_walk_query_block(64, 4, (size_t)m * k, m, (int)sizeof(CodeT));
  // 16-bit lanes hold m*254 only up to m = ADC_U8_MAX_M. A larger m fits a
  // block only with k < 227 (four queries' LUTs), so uint8 codes.
  if (m > ADC_U8_MAX_M && sizeof(CodeT) != 1) return cudaErrorInvalidValue;
#define PW2V_K3(q)                                                            \
  (m <= ADC_U8_MAX_M                                                          \
       ? launch_qb<q, true, CodeT>(luts, scale, codes, out, B, m, k, N,       \
                                   stream)                                    \
       : launch_qb<q, false, uint8_t>(luts, scale, codes, out, B, m, k, N,    \
                                      stream))
  switch (qb) {
    case 64: return PW2V_K3(64);
    case 32: return PW2V_K3(32);
    case 16: return PW2V_K3(16);
    case 8: return PW2V_K3(8);
    case 4: return PW2V_K3(4);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K3
}

// As pw2v_adc_scan_int8 with the queries per block forced to qb (64, 32,
// 16, 8 or 4; 0 chooses as pw2v_adc_scan_int8 does). For sweeps.
extern "C" int pw2v_adc_scan_int8_qb(const void* luts, const void* scale,
                                     const void* codes, int code_bytes,
                                     void* out, int B, int m, int k,
                                     long long N, int qb, void* stream) {
  const int8_t* l = static_cast<const int8_t*>(luts);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, sc, codes, o, B, m, k, N, qb, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, sc, codes, o, B, m, k, N, qb, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_adc_scan_int8(const void* luts, const void* scale,
                                  const void* codes, int code_bytes,
                                  void* out, int B, int m, int k,
                                  long long N, void* stream) {
  return pw2v_adc_scan_int8_qb(luts, scale, codes, code_bytes, out, B, m, k,
                               N, 0, stream);
}
