// K5: ADC scan over int8 LUTs fused with a strided-bin min/argmin.
//
// Bins follow K4 (adc_scan_binned.cu): bin j < 128 of a block_n-row tile
// holds rows {tile*block_n + j + s*128 : s < block_n/128}. Per query and
// bin the contract is the minimum of the exact packed key
//
//   key = sum * 2^shift + s,   sum = sum_j luts[b, j, codes[j, row]],
//   shift = log2(pow2ceil(block_n/128)),
//
// that is, the bin minimum of the exact integer sum and, on a tie, the
// lowest sub-index (the lowest row id). The outputs are
//
//   mins[b, tile*128 + j] = float(sum) * scale[b]   (one __fmul_rn)
//   ids[b, tile*128 + j]  = tile*block_n + s*128 + j
//
// Rows at or past N are masked in the kernel: a bin with no valid row comes
// out as +inf with id -1. The card takes bins = 128 (every caller's).
//
// Replaces the TPU kernel _adc_binned_kernel_i8 of
// postgres_word2vec_tpu/ops/pallas_kernels.py (adc_scan_binned_pallas with
// lut_dtype="int8"), which packs the same key after an int8 one-hot matmul
// and applies the scale in its wrapper; here the scale is applied to the
// binned output in the kernel.
//
// Bound on the H100: shared-memory lookups, as K3 (B*N*m one-byte lookups,
// 9.4 GB at B = 256, N = 3.07M, m = 12); the output is 16x smaller than
// K3's dense one and the codes are read once per query block.
//
// Design. The walk and the lookups are K3's (adc_scan_int8.cu): adc_walk
// with the AdcU8 policy, up to 64 queries' LUTs staged query-minor and
// biased to uint8, four threads per code row, codes by cp.async in
// double-buffered slabs, bytes summed two to a 16-bit lane while m <= 258.
// Thread group j owns bin j of every tile, as in K4, and walks the bin's
// rows in increasing s. The epilogue (AdcBinMinU8 below) keeps, per query,
// one 32-bit key (lane sum << 16 | s) and takes an unsigned min: two
// integer operations per query and row (a byte permute and a min), and no
// separate argmin register. The biased lane sum is the signed sum + 127*m,
// so its order is the signed sum's and the minimum is exact; a tie keeps
// the lower s. Unpacked (m > 258) the key is 64-bit, (sum << 32 | s).
#include <type_traits>

#include "adc_common.cuh"

#define K5_BINS ADC_ROWS  // bins per tile: one thread group each

// K5's epilogue: per thread and query the bin's min key, kept in registers
// over the tile's rows and written at the tile's end.
template <int F, bool Packed>
struct AdcBinMinU8 {
  using Key = std::conditional_t<Packed, uint32_t, unsigned long long>;
  static constexpr int SHIFT = Packed ? 16 : 32;  // the sum's place in a key
  float* mins;
  int* ids;
  const float* scale;
  long long n_out;  // bins of all tiles
  int b0, nq, block_n, j, v, bias;
  Key best[F];

  __device__ __forceinline__ void tile_begin(long long) {
#pragma unroll
    for (int i = 0; i < F; ++i) best[i] = ~Key(0);  // no row: never a key
  }

  // Query 4t + b of the thread sits in lane b & 2 of acc[2t + (b & 1)] when
  // packed (AdcU8::value); a lane holds at most 258*254 < 0xFFFF, so a real
  // key is below the empty one.
  template <typename Look>
  __device__ __forceinline__ void row(const Look& look, int s) {
    if constexpr (Packed) {
#pragma unroll
      for (int t = 0; t < F / 4; ++t) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          // bytes 0-1 of the key are s, bytes 2-3 the query's lane
          const uint32_t key = __byte_perm(
              (uint32_t)s, look.acc[2 * t + (b & 1)], b & 2 ? 0x7610 : 0x5410);
          best[4 * t + b] = min(best[4 * t + b], key);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < F; ++i)
        best[i] = min(best[i], (Key)look.acc[i] << 32 | (uint32_t)s);
    }
  }

  __device__ __forceinline__ void tile_end(long long tile) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int q = v * F + i;
      if (q < nq) {
        const long long o = (long long)(b0 + q) * n_out + tile * K5_BINS + j;
        if (best[i] == ~Key(0)) {
          mins[o] = __int_as_float(0x7f800000);  // +inf
          ids[o] = -1;
        } else {
          const int sum = (int)(best[i] >> SHIFT) - bias;
          const int s = (int)(best[i] & ((Key(1) << SHIFT) - 1));
          mins[o] = __fmul_rn((float)sum, scale[b0 + q]);
          ids[o] = (int)(tile * block_n + (long long)s * K5_BINS + j);
        }
      }
    }
  }
};

// One block per SM is enough (64 queries' LUTs fill its shared memory), so
// ptxas may give a thread up to 128 registers: left to itself it caps
// <64, packed> at 64 and spills.
template <int QB, bool Packed, typename CodeT>
__global__ void __launch_bounds__(ADC_ROWS * AdcU8<QB, Packed>::L, 1)
adc_scan_binned_int8_kernel(const int8_t* __restrict__ luts,
                            const float* __restrict__ scale,
                            const CodeT* __restrict__ codes,
                            float* __restrict__ mins, int* __restrict__ ids,
                            int B, int m, int k, long long N, int block_n,
                            long long n_tiles, int slab, int async_codes) {
  using Look = AdcU8<QB, Packed>;
  extern __shared__ __align__(16) uint8_t lut_u8[];
  const int mk = m * k;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  adc_u8_stage<QB>(lut_u8, luts, b0, nq, mk);
  CodeT* code_s = reinterpret_cast<CodeT*>(reinterpret_cast<char*>(lut_u8) +
                                            adc_lut_bytes(QB, mk, 1));
  const int v = threadIdx.x % Look::L;
  Look look(lut_u8, v, m, scale, b0, nq);
  AdcBinMinU8<Look::F, Packed> epi{mins, ids, scale, n_tiles * K5_BINS, b0,
                                   nq, block_n, (int)threadIdx.x / Look::L,
                                   v, 127 * m};
  adc_walk<Look::L>(look, epi, codes, code_s, m, k, N, block_n, n_tiles, slab,
                    async_codes);
}

template <int QB, bool Packed, typename CodeT>
static cudaError_t launch_qb(const int8_t* luts, const float* scale,
                             const void* codes, float* mins, int* ids, int B,
                             int m, int k, long long N, int block_n,
                             cudaStream_t stream) {
  constexpr int threads = ADC_ROWS * AdcU8<QB, Packed>::L;
  const int cb = (int)sizeof(CodeT);
  const size_t lut = (size_t)QB * m * k;
  const int slab = adc_walk_slab(lut, m, cb, block_n / K5_BINS);
  if (slab == 0) return cudaErrorInvalidValue;
  const size_t smem = adc_walk_smem(lut, m, cb, slab);
  cudaError_t err =
      adc_allow_smem(adc_scan_binned_int8_kernel<QB, Packed, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (N + block_n - 1) / block_n;
  const long long gy = (B + QB - 1) / QB;
  unsigned gx = 0;
  err = adc_walk_blocks(smem, threads, gy, n_tiles, &gx);
  if (err != cudaSuccess) return err;
  adc_scan_binned_int8_kernel<QB, Packed, CodeT>
      <<<dim3(gx, (unsigned)gy), threads, smem, stream>>>(
          luts, scale, static_cast<const CodeT*>(codes), mins, ids, B, m, k,
          N, block_n, n_tiles, slab, adc_async_codes(codes, N, cb));
  return cudaGetLastError();
}

template <typename CodeT>
static cudaError_t launch(const int8_t* luts, const float* scale,
                          const void* codes, float* mins, int* ids, int B,
                          int m, int k, long long N, int block_n, int bins,
                          int qb, cudaStream_t stream) {
  // s must fit the packed key's 16 bits
  if (B < 1 || N < 1 || m < 1 || k < 1 || bins != K5_BINS ||
      block_n < K5_BINS || block_n % K5_BINS != 0 ||
      block_n / K5_BINS > 65536)
    return cudaErrorInvalidValue;
  if (qb == 0)
    qb = adc_walk_query_block(64, 4, (size_t)m * k, m, (int)sizeof(CodeT));
  // As K3: past ADC_U8_MAX_M the sums are unpacked, which fits a block only
  // with k < 227, so uint8 codes.
  if (m > ADC_U8_MAX_M && sizeof(CodeT) != 1) return cudaErrorInvalidValue;
#define PW2V_K5(q)                                                            \
  (m <= ADC_U8_MAX_M                                                          \
       ? launch_qb<q, true, CodeT>(luts, scale, codes, mins, ids, B, m, k, N, \
                                   block_n, stream)                           \
       : launch_qb<q, false, uint8_t>(luts, scale, codes, mins, ids, B, m, k, \
                                      N, block_n, stream))
  switch (qb) {
    case 64: return PW2V_K5(64);
    case 32: return PW2V_K5(32);
    case 16: return PW2V_K5(16);
    case 8: return PW2V_K5(8);
    case 4: return PW2V_K5(4);
    default: return cudaErrorInvalidValue;
  }
#undef PW2V_K5
}

// As pw2v_adc_scan_binned_int8 with the queries per block forced to qb (64,
// 32, 16, 8 or 4; 0 chooses as pw2v_adc_scan_binned_int8 does). For sweeps.
extern "C" int pw2v_adc_scan_binned_int8_qb(const void* luts,
                                            const void* scale,
                                            const void* codes, int code_bytes,
                                            void* mins, void* ids, int B,
                                            int m, int k, long long N,
                                            int block_n, int bins, int qb,
                                            void* stream) {
  const int8_t* l = static_cast<const int8_t*>(luts);
  const float* sc = static_cast<const float*>(scale);
  float* mn = static_cast<float*>(mins);
  int* id = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, sc, codes, mn, id, B, m, k, N, block_n, bins,
                           qb, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, sc, codes, mn, id, B, m, k, N, block_n, bins,
                           qb, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_adc_scan_binned_int8(const void* luts, const void* scale,
                                         const void* codes, int code_bytes,
                                         void* mins, void* ids, int B, int m,
                                         int k, long long N, int block_n,
                                         int bins, void* stream) {
  return pw2v_adc_scan_binned_int8_qb(luts, scale, codes, code_bytes, mins,
                                      ids, B, m, k, N, block_n, bins, 0,
                                      stream);
}
