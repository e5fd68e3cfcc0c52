// K1: fused brute-force scan with a strided-bin min/argmin.
//
// queries (B, D) bf16, table (N_pad, D) bf16 row-major, norms (N_pad,) f32
// -> for every block_n-row tile and bin j < 128 (bin j holds rows
// {tile*block_n + s*128 + j}), per query, the float32 minimum of the shifted
// score norm[n] - 2*q.v[n] and the global id of the row that holds it
// (smallest id on ties). D is a multiple of 8 (16-byte rows), N_pad a multiple
// of block_n, and block_n a multiple of 128. Pad rows are zero with +inf
// norms, so their score is +inf and never NaN.
//
// Replaces the TPU kernel _fused_exact_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (fused_exact_scan_pallas). The
// TPU version needs the table pre-tiled as (n_tiles, D, block_n) for its DMA
// engine; here the table stays row-major, with rows zero-padded to 16 bytes.
//
// Design: a block owns 64 queries and one tile. It walks the tile in
// block_n/128 chunks of 128 rows; chunk s holds exactly row s of every bin,
// so each thread keeps a running min/argmin for its (query, bin) outputs in
// registers across chunks and the (B, N) score matrix never reaches device
// memory. Each chunk is a 64 x 128 x D product on CUDA cores: 32-deep slices
// of queries and rows are staged in shared memory as float32 (bf16 widens
// exactly), and each of the 256 threads accumulates a 4 x 8 register tile in
// float32.
//
// Bound on the H100: compute. At B = 1024 and N = 3.07M x 304 the scan is
// ~1.9 TFLOP per batch; on CUDA cores this kernel sits far below the card's
// bf16 tensor-core rate. The table is read once per 64-query block (from L2
// for neighbouring blocks, which share a tile).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

#define FX_THREADS 256
#define FX_QB 64     // queries per block
#define FX_BN 128    // rows per chunk == bins
#define FX_KS 32     // depth of one staged slice
#define FX_TQ 4      // queries per thread
#define FX_TN 8      // rows (bins) per thread

__global__ void __launch_bounds__(FX_THREADS)
fused_exact_scan_kernel(const uint16_t* __restrict__ queries,
                        const uint16_t* __restrict__ table,
                        const float* __restrict__ norms,
                        float* __restrict__ mins, int* __restrict__ ids,
                        int B, int D, int block_n, long long n_out) {
  __shared__ __align__(16) float As[FX_KS][FX_QB];
  __shared__ __align__(16) float Bs[FX_KS][FX_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bins tx*8 .. tx*8+7
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3
  const int b0 = blockIdx.x * FX_QB;
  const long long tile = blockIdx.y;
  const int sub = block_n / FX_BN;

  float best[FX_TQ][FX_TN];
  int arg[FX_TQ][FX_TN];
#pragma unroll
  for (int r = 0; r < FX_TQ; ++r)
#pragma unroll
    for (int e = 0; e < FX_TN; ++e) {
      best[r][e] = __int_as_float(0x7f800000);  // +inf
      arg[r][e] = 0;
    }

  for (int s = 0; s < sub; ++s) {
    const long long r0 = tile * block_n + (long long)s * FX_BN;
    float acc[FX_TQ][FX_TN];
#pragma unroll
    for (int r = 0; r < FX_TQ; ++r)
#pragma unroll
      for (int e = 0; e < FX_TN; ++e) acc[r][e] = 0.f;

    for (int k0 = 0; k0 < D; k0 += FX_KS) {
      // Stage rows: 128 rows x 4 parts of 8 bf16 = 512 16-byte loads.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = tid + h * FX_THREADS;
        const int part = v / FX_BN;
        const int row = v % FX_BN;
        const int kc = k0 + part * 8;
        float f[8];
        if (kc < D) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              table + (r0 + row) * (long long)D + kc);
          bf16x8_to_f32(u, f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) Bs[part * 8 + e][row] = f[e];
      }
      // Stage queries: 64 queries x 4 parts = 256 16-byte loads.
      {
        const int part = tid / FX_QB;
        const int q = tid % FX_QB;
        const int kc = k0 + part * 8;
        float f[8];
        if (kc < D && b0 + q < B) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              queries + (long long)(b0 + q) * D + kc);
          bf16x8_to_f32(u, f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) As[part * 8 + e][q] = f[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FX_KS; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 c0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
        const float4 c1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
        const float av[FX_TQ] = {a.x, a.y, a.z, a.w};
        const float bv[FX_TN] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < FX_TQ; ++r)
#pragma unroll
          for (int e = 0; e < FX_TN; ++e) acc[r][e] += av[r] * bv[e];
      }
      __syncthreads();
    }

    const float4 n0 = *reinterpret_cast<const float4*>(norms + r0 + tx * 8);
    const float4 n1 = *reinterpret_cast<const float4*>(norms + r0 + tx * 8 + 4);
    const float nv[FX_TN] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
    for (int r = 0; r < FX_TQ; ++r)
#pragma unroll
      for (int e = 0; e < FX_TN; ++e) {
        const float score = nv[e] - 2.0f * acc[r][e];
        if (score < best[r][e]) {
          best[r][e] = score;
          arg[r][e] = s;
        }
      }
  }

#pragma unroll
  for (int r = 0; r < FX_TQ; ++r) {
    const int q = b0 + ty * 4 + r;
    if (q >= B) continue;
#pragma unroll
    for (int e = 0; e < FX_TN; ++e) {
      const int j = tx * 8 + e;
      const long long o = (long long)q * n_out + tile * FX_BN + j;
      mins[o] = best[r][e];
      ids[o] = (int)(tile * block_n + (long long)arg[r][e] * FX_BN + j);
    }
  }
}

extern "C" int pw2v_fused_exact_scan(const void* queries, const void* table,
                                     const void* norms, void* mins, void* ids,
                                     int B, int D, long long n_pad,
                                     int block_n, void* stream) {
  if (B < 1 || D < 8 || D % 8 != 0 || block_n < FX_BN ||
      block_n % FX_BN != 0 || n_pad < block_n || n_pad % block_n != 0)
    return cudaErrorInvalidValue;
  const long long n_tiles = n_pad / block_n;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + FX_QB - 1) / FX_QB), (unsigned)n_tiles);
  fused_exact_scan_kernel<<<grid, FX_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(queries),
      static_cast<const uint16_t*>(table), static_cast<const float*>(norms),
      static_cast<float*>(mins), static_cast<int*>(ids), B, D, block_n,
      n_tiles * FX_BN);
  return cudaGetLastError();
}
