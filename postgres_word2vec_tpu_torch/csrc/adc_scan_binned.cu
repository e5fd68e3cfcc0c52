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
#include "adc_common.cuh"

#define AB_BINS 128  // bins per tile: one thread group each
#define AB_WAVES 4   // blocks launched per SM slot, for balance

__device__ __forceinline__ uint32_t ab_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Shared memory of a block: QB staged LUTs, then two code slabs.
__host__ __device__ inline size_t ab_lut_bytes(int qb, int m, int k) {
  return ((size_t)qb * m * k * sizeof(float) + 15) / 16 * 16;
}

static inline size_t ab_smem(int qb, int m, int k, int cb, int slab) {
  return ab_lut_bytes(qb, m, k) + 2 * (size_t)m * slab * AB_BINS * cb;
}

// Queries per block for an (m, k) codebook: the largest of 16, 8, 4, 2 and
// 1 whose LUTs fit beside two one-step code slabs; 0 if none does.
static inline int ab_query_block(int m, int k, int cb) {
  for (int qb = 16; qb >= 1; qb /= 2)
    if (ab_smem(qb, m, k, cb, 1) <= ADC_SMEM_MAX) return qb;
  return 0;
}

// 128-row steps per code slab: the largest of 8, 4, 2 and 1 that divides
// the tile's steps and fits beside the LUTs; 0 if none does.
static inline int ab_slab(int qb, int m, int k, int cb, int steps) {
  for (int slab = 8; slab >= 1; slab /= 2)
    if (steps % slab == 0 && ab_smem(qb, m, k, cb, slab) <= ADC_SMEM_MAX)
      return slab;
  return 0;
}

template <int QB, typename CodeT>
__global__ void __launch_bounds__(AB_BINS * AdcF32<QB>::L)
adc_scan_binned_kernel(const float* __restrict__ luts,
                       const CodeT* __restrict__ codes,
                       float* __restrict__ mins, int* __restrict__ ids,
                       int B, int m, int k, long long N, int block_n,
                       long long n_tiles, int slab, int async_codes) {
  constexpr int F = AdcF32<QB>::F;
  constexpr int L = AdcF32<QB>::L;
  extern __shared__ __align__(16) float lut_s[];
  const int mk = m * k;
  const int b0 = blockIdx.y * QB;
  const int nq = min(QB, B - b0);
  adc_f32_stage<QB>(lut_s, luts, b0, nq, mk);
  CodeT* code_s = reinterpret_cast<CodeT*>(
      reinterpret_cast<char*>(lut_s) + ab_lut_bytes(QB, m, k));
  const int rows = slab * AB_BINS;  // rows of one slab
  const size_t slab_elems = (size_t)m * rows;
  const int slabs = block_n / rows;  // slabs of one tile
  const int j = threadIdx.x / L;     // this thread's bin
  const int v = threadIdx.x % L;     // its queries: v*F .. v*F + F-1
  // This block's tiles: blockIdx.x, + gridDim.x, ... (gridDim.x <= n_tiles)
  const long long n_slabs =
      ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * slabs;
  auto tile_of = [&](long long p) {
    return (long long)blockIdx.x + (p / slabs) * gridDim.x;
  };

  // Copy slab p (m subspace runs of `rows` codes) into buffer p % 2. Rows
  // past N are never read, so they are not copied.
  auto stage = [&](long long p) {
    CodeT* dst = code_s + (p & 1) * slab_elems;
    const long long row0 = tile_of(p) * block_n + (p % slabs) * rows;
    if (async_codes) {
      const int per = rows * (int)sizeof(CodeT) / 16;
      const long long left = (N - row0) * (long long)sizeof(CodeT);
      for (int i = threadIdx.x; i < m * per; i += blockDim.x) {
        const int jj = i / per;
        const long long off = (long long)(i - jj * per) * 16;
        if (off >= left) continue;
        cp_async16(ab_smem_addr(reinterpret_cast<char*>(dst + (size_t)jj *
                                                              rows) + off),
                   reinterpret_cast<const char*>(codes + (long long)jj * N +
                                                 row0) + off,
                   (int)min(16LL, left - off));
      }
    } else {  // codes not 16-byte aligned per subspace: plain copies
      for (int i = threadIdx.x; i < m * rows; i += blockDim.x) {
        const int jj = i / rows;
        const long long n = row0 + (i - jj * rows);
        if (n < N) dst[i] = codes[(long long)jj * N + n];
      }
    }
    cp_async_commit();
  };

  float best[F];
  int arg[F];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    best[i] = 0.f;
    arg[i] = 0;
  }
  if (n_slabs > 0) stage(0);
  for (long long p = 0; p < n_slabs; ++p) {
    if (p + 1 < n_slabs) {
      stage(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long tile = tile_of(p);
    const int sl = (int)(p % slabs);
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        best[i] = __int_as_float(0x7f800000);  // +inf
        arg[i] = 0;
      }
    }
    const CodeT* cs = code_s + (p & 1) * slab_elems + j;
    const long long row0 = tile * block_n + (long long)sl * rows + j;
    for (int ss = 0; ss < slab; ++ss) {
      if (row0 + ss * AB_BINS >= N) break;  // rows grow: the rest is padding
      float acc[F];
#pragma unroll
      for (int i = 0; i < F; ++i) acc[i] = 0.f;
      const CodeT* cr = cs + ss * AB_BINS;
#pragma unroll 4
      for (int jj = 0; jj < m; ++jj)
        adc_f32_add<QB>(acc, lut_s, jj * k + (int)cr[(size_t)jj * rows], v);
      const int s = sl * slab + ss;
#pragma unroll
      for (int i = 0; i < F; ++i) {
        if (acc[i] < best[i]) {
          best[i] = acc[i];
          arg[i] = s;
        }
      }
    }
    if (sl == slabs - 1) {
      const long long n_out = n_tiles * AB_BINS;
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
    __syncthreads();  // every thread is done with buffer p % 2
  }
}

template <int QB, typename CodeT>
static cudaError_t launch_qb(const float* luts, const void* codes,
                             float* mins, int* ids, int B, int m, int k,
                             long long N, int block_n, cudaStream_t stream) {
  constexpr int threads = AB_BINS * AdcF32<QB>::L;
  const int cb = (int)sizeof(CodeT);
  const int slab = ab_slab(QB, m, k, cb, block_n / AB_BINS);
  if (slab == 0) return cudaErrorInvalidValue;
  const size_t smem = ab_smem(QB, m, k, cb, slab);
  cudaError_t err = adc_allow_smem(adc_scan_binned_kernel<QB, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (N + block_n - 1) / block_n;
  const long long gy = (B + QB - 1) / QB;
  if (gy > 65535) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long per_sm = (long long)(ADC_SMEM_MAX / smem);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  if (per_sm < 1) per_sm = 1;
  long long gx = ((long long)sms * per_sm * AB_WAVES + gy - 1) / gy;
  if (gx > n_tiles) gx = n_tiles;  // n_tiles < 2^31: N is a long long of rows
  const int async_codes =
      reinterpret_cast<uintptr_t>(codes) % 16 == 0 && (N * cb) % 16 == 0;
  adc_scan_binned_kernel<QB, CodeT>
      <<<dim3((unsigned)gx, (unsigned)gy), threads, smem, stream>>>(
          luts, static_cast<const CodeT*>(codes), mins, ids, B, m, k, N,
          block_n, n_tiles, slab, async_codes);
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
  if (qb == 0) qb = ab_query_block(m, k, (int)sizeof(CodeT));
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
