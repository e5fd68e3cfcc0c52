// K1: fused brute-force scan with a strided-bin min/argmin, on wgmma + TMA.
//
// queries (B, D) bf16, table (N_pad, D) bf16 row-major, norms (N_pad,) f32
// -> for every block_n-row tile and bin j < 128 (bin j holds rows
// {tile*block_n + s*128 + j}), per query, the float32 minimum of the shifted
// score norm[n] - 2*q.v[n] and the global id of the row that holds it
// (smallest id on ties). D is a multiple of 8 (16-byte rows) and at most 448,
// N_pad a multiple of block_n, and block_n a multiple of 128 of at most
// 32768. Pad rows are zero with +inf norms, so their score is +inf and never
// NaN, and they never win a bin.
//
// Replaces the TPU kernel _fused_exact_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (fused_exact_scan_pallas). The
// TPU version needs the table pre-tiled as (n_tiles, D, block_n) for its DMA
// engine; here the table stays row-major, with rows zero-padded to 16 bytes.
//
// Bound on the H100: compute. At B = 1024 and N = 3.07M x 300 the product is
// 1.9 TFLOP, 1.9 ms at the 989 TFLOP/s bf16 tensor-core rate; the table's
// 1.87 GB read once takes 0.56 ms.
//
// Design. The q.v product runs on the tensor cores: wgmma m64n128k16, bf16
// in, float32 accumulate, both operands read from shared memory in the
// 128-byte swizzled K-major layout that TMA writes. A CTA owns 128 queries
// and one tile: two consumer warpgroups of 64 queries each and one producer
// warpgroup, of which one thread issues the loads. It first loads the CTA's
// queries with TMA (ceil(D/64) boxes of 64 columns x 128 rows, 80 KB at
// D = 304) and keeps them in shared memory for the whole tile, then streams
// the tile through a ring of FX_STAGES boxes of 128 rows x 64 columns, each
// signalled by an mbarrier with its byte count and freed by an mbarrier
// that both consumer warpgroups arrive on. Columns past D (304..319 of the
// fifth box) are TMA's out-of-bounds zero fill, as are query rows past B;
// the k-steps that would read only zero columns are skipped (the last box's
// count is a template argument), so a 128-row chunk takes 19 k-steps. One
// chunk of 128 rows is exactly row s of every bin, so after its k-steps
// each thread turns its 64 accumulators (2 queries x 32 bins) into
// norm - 2*acc and keeps a running min in registers and the chunk index s
// of the min, one byte each, packed four to a register; the (B, N) score
// matrix never reaches device memory. Chunks go in increasing s with a
// strict <, which keeps the smallest id on ties. The chunk's 32 norms a
// thread needs are loaded when its products start, so the epilogue does not
// wait on them. The grid puts the query block fastest, so the ceil(B/128)
// CTAs of one tile run together and read the tile once from device memory
// and then from L2. setmaxnreg moves registers from the producer warpgroup
// (40) to the consumers (232): 64 accumulators, 64 mins, 16 packed argmins
// and 32 norms fit without spills. The wgmmas' loop has no divergent path
// (the barrier polls are single asm blocks, the warp index is broadcast),
// or ptxas would serialize them. The TMA descriptor comes from the driver
// entry point cuTensorMapEncodeTiled, fetched through the runtime (no
// -lcuda), and the table's descriptor is cached for the last table pointer
// and shape.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FX_BN 128             // rows per chunk == bins == wgmma N
#define FX_QB 128             // queries per CTA: two warpgroups of 64
#define FX_BOX_K 64           // bf16 columns per box: one 128-byte row
#define FX_BOX_BYTES (FX_BOX_K * 2 * 128)  // a box: 128 rows x 128 bytes
#define FX_STAGES 6           // table boxes in flight
#define FX_MAX_KB 7           // query boxes kept: D <= 448
#define FX_THREADS 384        // 2 consumer warpgroups + 1 producer warpgroup
#define FX_CONSUMER_REGS 232  // setmaxnreg: 2*128*232 + 128*40 <= 65536
#define FX_PRODUCER_REGS 40

// ------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete. The poll loop is one
// asm block, so the compiler sees no divergent loop around the wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Box (c0 = column, c1 = row) of a 2-D tensor map into shared memory; the
// barrier's transaction count drops by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (the layout TMA writes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16, bf16) * B (16 x 128, bf16) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The STEPS k-steps of one box: A from the warpgroup's query rows, B from
// the ring stage; `first` starts the chunk's sum from zero.
template <int STEPS>
__device__ __forceinline__ void box_mma(float (&acc)[64], uint32_t a,
                                        uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_128(acc, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32),
              first && kk == 0 ? 0 : 1);
}

// ------------------------------------------------------------- kernel

// LAST: the k-steps of the last box, ((D - 1) % 64) / 16 + 1 (3 at D = 304).
template <int LAST>
__global__ void __launch_bounds__(FX_THREADS, 1)
fused_exact_scan_kernel(__grid_constant__ const CUtensorMap qmap,
                        __grid_constant__ const CUtensorMap tmap,
                        const float* __restrict__ norms,
                        float* __restrict__ mins, int* __restrict__ ids,
                        int B, int D, int block_n, int qblocks,
                        long long n_out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // Swizzled boxes need 1024-byte alignment; the launch adds the slack.
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int nkb = (D + FX_BOX_K - 1) / FX_BOX_K;
  const uint32_t q_s = base;                           // nkb query boxes
  const uint32_t t_s = q_s + nkb * FX_BOX_BYTES;       // the table ring
  const uint32_t bars = t_s + FX_STAGES * FX_BOX_BYTES;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (FX_STAGES + st); };
  const uint32_t qbar = bars + 16u * FX_STAGES;

  const int qb = (int)(blockIdx.x % qblocks);
  const long long tile = blockIdx.x / qblocks;
  const long long r_tile = tile * block_n;
  const int sub = block_n / FX_BN;

  if (threadIdx.x == 0) {
    for (int st = 0; st < FX_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival per consumer warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so the wgmma paths are not divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= 8) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 ::"n"(FX_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, nkb * FX_BOX_BYTES);
      for (int kb = 0; kb < nkb; ++kb)
        tma_load(q_s + kb * FX_BOX_BYTES, &qmap, qbar, kb * FX_BOX_K,
                 qb * FX_QB);
      const int n_box = sub * nkb;
      for (int it = 0; it < n_box; ++it) {
        const int st = it % FX_STAGES;
        mbar_wait(empty(st), ((it / FX_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), FX_BOX_BYTES);
        const int s = it / nkb;
        tma_load(t_s + st * FX_BOX_BYTES, &tmap, full(st),
                 (it - s * nkb) * FX_BOX_K, (int)(r_tile + s * FX_BN));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
               ::"n"(FX_CONSUMER_REGS));
  // Consumers. Accumulator i = 4c + 2h + e of a thread is query row
  // 16*(warp%4) + lane/4 + 8h of its warpgroup and bin 8c + 2*(lane%4) + e.
  const int wg = warp / 4;
  const int lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  const int col0 = 2 * (lane & 3);
  const uint32_t a_s = q_s + wg * (64 * 128);  // this warpgroup's 64 rows
  float acc[64], best[64];
  uint32_t argw[16];  // chunk index of each min, one byte per bin
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    best[i] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) argw[c] = 0u;

  mbar_wait(qbar, 0);
  for (int s = 0; s < sub; ++s) {
    // the chunk's norms, loaded now so that they land during its products
    const float* nrow = norms + r_tile + (long long)s * FX_BN + col0;
    float2 nv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c)
      nv[c] = __ldg(reinterpret_cast<const float2*>(nrow + 8 * c));
    for (int kb = 0; kb < nkb; ++kb) {
      const int it = s * nkb + kb;
      const int st = it % FX_STAGES;
      mbar_wait(full(st), (it / FX_STAGES) & 1);
      fence_acc(acc);
      wgmma_fence();
      if (kb + 1 < nkb)
        box_mma<4>(acc, a_s + kb * FX_BOX_BYTES, t_s + st * FX_BOX_BYTES,
                   kb == 0);
      else
        box_mma<LAST>(acc, a_s + kb * FX_BOX_BYTES, t_s + st * FX_BOX_BYTES,
                      kb == 0);
      wgmma_commit();
      if (kb > 0) {  // the previous box's products are done: free it
        wgmma_wait<1>();
        if (leader) mbar_arrive(empty((it - 1) % FX_STAGES));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (leader) mbar_arrive(empty((s * nkb + nkb - 1) % FX_STAGES));

    const uint32_t srep = (uint32_t)s * 0x01010101u;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      uint32_t mask = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * h + e;
          const float score = fmaf(-2.0f, acc[i], e ? nv[c].y : nv[c].x);
          const bool lt = score < best[i];
          best[i] = lt ? score : best[i];
          mask |= lt ? (0xffu << (8 * (2 * h + e))) : 0u;
        }
      argw[c] = (argw[c] & ~mask) | (srep & mask);
    }
  }

  const int qrow = qb * FX_QB + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = qrow + 8 * h;
    if (q >= B) continue;
    float* mrow = mins + (long long)q * n_out + tile * FX_BN;
    int* irow = ids + (long long)q * n_out + tile * FX_BN;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * c + col0;
      const int s0 = (argw[c] >> (16 * h)) & 0xff;
      const int s1 = (argw[c] >> (16 * h + 8)) & 0xff;
      *reinterpret_cast<float2*>(mrow + col) =
          make_float2(best[4 * c + 2 * h], best[4 * c + 2 * h + 1]);
      *reinterpret_cast<int2*>(irow + col) =
          make_int2((int)(r_tile + s0 * FX_BN + col),
                    (int)(r_tile + s1 * FX_BN + col + 1));
    }
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, D) row-major bf16 tensor as 128-row x 64-column boxes in the
// 128-byte swizzle; reads out of bounds fill zeros.
static cudaError_t make_map(CUtensorMap* map, const void* ptr, int D,
                            long long rows) {
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {FX_BOX_K, FX_BN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The table's map, cached for the last (pointer, D, rows): a search calls
// the kernel on the same table again and again.
static cudaError_t table_map(CUtensorMap* out, const void* table, int D,
                             long long rows) {
  static CUtensorMap cached;
  static const void* c_ptr = nullptr;
  static int c_d = 0;
  static long long c_rows = 0;
  if (table != c_ptr || D != c_d || rows != c_rows) {
    const cudaError_t err = make_map(&cached, table, D, rows);
    if (err != cudaSuccess) {
      c_ptr = nullptr;
      return err;
    }
    c_ptr = table;
    c_d = D;
    c_rows = rows;
  }
  *out = cached;
  return cudaSuccess;
}

template <int LAST>
static cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& tmap,
                         const float* norms, float* mins, int* ids, int B,
                         int D, int block_n, int qblocks, long long n_out,
                         unsigned grid, size_t smem, cudaStream_t stream) {
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_exact_scan_kernel<LAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fused_exact_scan_kernel<LAST><<<grid, FX_THREADS, smem, stream>>>(
      qmap, tmap, norms, mins, ids, B, D, block_n, qblocks, n_out);
  return cudaGetLastError();
}

extern "C" int pw2v_fused_exact_scan(const void* queries, const void* table,
                                     const void* norms, void* mins, void* ids,
                                     int B, int D, long long n_pad,
                                     int block_n, void* stream) {
  if (B < 1 || D < 8 || D % 8 != 0 || D > FX_MAX_KB * FX_BOX_K ||
      block_n < FX_BN || block_n % FX_BN != 0 || block_n / FX_BN > 256 ||
      n_pad < block_n || n_pad % block_n != 0 || n_pad > INT_MAX)
    return cudaErrorInvalidValue;
  const long long n_tiles = n_pad / block_n;
  const int qblocks = (B + FX_QB - 1) / FX_QB;
  if (n_tiles * qblocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap qmap, tmap;
  cudaError_t err = make_map(&qmap, queries, D, B);
  if (err != cudaSuccess) return err;
  err = table_map(&tmap, table, D, n_pad);
  if (err != cudaSuccess) return err;
  const int nkb = (D + FX_BOX_K - 1) / FX_BOX_K;
  const size_t smem = 1024 + (size_t)(nkb + FX_STAGES) * FX_BOX_BYTES +
                      16 * FX_STAGES + 8;
  const int last = ((D - 1) % FX_BOX_K) / 16 + 1;
  const unsigned grid = (unsigned)(n_tiles * qblocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nr = static_cast<const float*>(norms);
  float* mn = static_cast<float*>(mins);
  int* id = static_cast<int*>(ids);
  const long long n_out = n_tiles * FX_BN;
  switch (last) {
    case 1: return launch<1>(qmap, tmap, nr, mn, id, B, D, block_n, qblocks,
                             n_out, grid, smem, st);
    case 2: return launch<2>(qmap, tmap, nr, mn, id, B, D, block_n, qblocks,
                             n_out, grid, smem, st);
    case 3: return launch<3>(qmap, tmap, nr, mn, id, B, D, block_n, qblocks,
                             n_out, grid, smem, st);
    default: return launch<4>(qmap, tmap, nr, mn, id, B, D, block_n, qblocks,
                              n_out, grid, smem, st);
  }
}
