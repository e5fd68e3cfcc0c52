// K6: budgeted tile-gather ADC, one query per block.
//
//   out[b, p*block_t + r] = sum_j luts[b, j, codes_t[j, t*block_t + r]]
//                           + rowterm[t*block_t + r],   t = tiles[b, p]
//
// luts (B, m, k) float32, codes_t (m, NA) uint8/int16 cell-aligned codes
// (subspace-major), rowterm (NA,) float32 with +inf on pad rows and the inf
// tile, tiles (B, P) int32 -> out (B, P*block_t) float32. Sums run over
// subspaces in order, then the row term is added, as in the plain version,
// so the float32 results agree bit for bit; +inf + finite stays +inf. A tile
// id outside the table writes +inf and reads nothing.
//
// Replaces the TPU kernel _budget_adc_kernel of
// postgres_word2vec_tpu/ops/pallas_kernels.py (budget_adc_pallas). There the
// tile ids arrive by scalar prefetch, each (query, slot) is one grid step and
// the lookup is a one-hot matmul with bf16 LUTs.
//
// Bound on the H100: the code bytes of the probed tiles from device memory
// (the 3M-row join's 92 MB of codes do not fit in L2) and the output; at
// k = 256 also the shared-memory lookups, which meet at random banks. A
// block that reads one tile, sums it and only then asks for the next pays
// the device-memory latency once per slot. What the design does about it:
// - a block owns one query and `spb` of its slots. It reads all its tile ids
//   at once and stages the query's float32 LUT once (61 KB at the fused-pair
//   15x1024 LUTs, above the 48 KB default, hence the opt-in);
// - a plan is padded to P slots with the table's last tile, the inf tile:
//   two thirds of an IVFADC batch's slots. A block that holds such slots
//   reads that tile's row terms once (from L1 after the SM's first block)
//   and, if they are all +inf, treats the slots as ids outside the table:
//   +inf written, nothing copied or summed, and the card's blocks do not
//   all pull the same tile through one slice of L2;
// - a thread owns four neighbouring code rows, so one shared load brings
//   the four codes of a subspace (five shared loads for four lookups, not
//   eight) and the results leave as one 16-byte store. A unit of 256 rows
//   then takes 64 threads, so the block's threads form groups (four at the
//   joins' shape) that take the block's units in turn and wait only for
//   their own group (a named barrier), not for the block;
// - a group's codes and row terms reach shared memory through its own ring
//   of `depth` units filled by bulk copies (TMA) that its first warp asks
//   for, one mbarrier a ring place: while the group sums unit u, the units
//   after it are in flight, so the latency is paid once a block, and the
//   copies cost the other warps no instruction. A unit is a whole tile, or a
//   part of one where two whole tiles do not fit beside the LUT;
// - sums run over the subspaces in order with one accumulator a row. At k =
//   32 a LUT row fills the 32 banks exactly and the lookups of a warp never
//   collide;
// - the loop is bound by the instructions it executes (integer operations run
//   at half the float rate), so the joins' shape (k <= 32, tiles of at most
//   256 rows of uint8 codes) gets its strides at compile time: LUT rows KS =
//   32 floats apart (k rounded up) and code runs 256 codes apart. A lookup
//   then needs one byte permute, which yields the entry's offset (K6Codes),
//   and one add; every other offset is an immediate. Other shapes take the
//   strides at run time (KS = 0): at k = 256 and 1024-row tiles fixed
//   strides measured no faster;
// - units whose rows are not a multiple of four, an output that is not
//   16-byte aligned and launches of few units (a single query's probe, which
//   is one unit's latency) take one row a thread and single loads and
//   stores.
#include "adc_common.cuh"
#include "budget_common.cuh"

// Groups a launch aims for and the most slots a group takes (a block takes
// that many for each of its groups), chosen by the sweep of chip_smoke.py at
// the joins' and the IVFADC batch's shapes.
#define K6_TARGET_GROUPS 3072
#define K6_MAX_SPG 6
#define K6_SPB_LIMIT 64  // the most slots of a block
// Units of a launch up to which a thread takes one row, not four: two for
// each of the H100's 132 SMs.
#define K6_SMALL_UNITS 264
// Ring depth: one unit summed, one in flight. Deeper rings were no faster at
// the joins' shapes and slower at the IVFADC batch's, where their shared
// memory costs resident blocks (the same sweep).
#define K6_DEPTH 2
#define K6_MAX_DEPTH 4  // what the sweep entry point accepts
// Where the strides are fixed at compile time: the most rows of a tile, and
// the distance of its code runs.
#define K6_FIXED_ROWS 256
// A block's dynamic shared memory: the SM's 227 KB less the static arrays.
#define K6_SMEM_MAX (ADC_SMEM_MAX - 1024)
// Groups of a block, at most, and the shared memory their rings may take
// together with the LUT before the block makes do with fewer groups.
#define K6_MAX_GROUPS 8
#define K6_SMEM_TARGET (76 * 1024)

// Four codes of neighbouring rows, fetched by one shared load. byte_offset(i)
// is where code i's float lies in a LUT row. Integer operations are the
// loop's scarce resource, so each offset is made by one byte permute: with
// Small (every code below 64, so four times a code still fits its byte)
// from the word shifted and masked once for all four, else from the code
// and a multiply that the compiler folds into the address. (The mask keeps
// a code that is out of range from carrying into its neighbour's offset.)
template <typename CodeT, bool Small>
struct K6Codes;
template <bool Small>
struct K6Codes<uint8_t, Small> {
  uint32_t w;
  __device__ __forceinline__ explicit K6Codes(const uint8_t* p)
      : w(Small ? (*reinterpret_cast<const uint32_t*>(p) << 2) & 0xfcfcfcfcu
                : *reinterpret_cast<const uint32_t*>(p)) {}
  __device__ __forceinline__ uint32_t byte_offset(int i) const {
    const uint32_t b = __byte_perm(w, 0u, 0x4440u | i);  // byte i, zeros
    return Small ? b : b * (uint32_t)sizeof(float);
  }
};
template <bool Small>
struct K6Codes<int16_t, Small> {
  uint2 w;
  __device__ __forceinline__ explicit K6Codes(const int16_t* p)
      : w(*reinterpret_cast<const uint2*>(p)) {}
  __device__ __forceinline__ uint32_t byte_offset(int i) const {
    const uint32_t h =
        __byte_perm(i < 2 ? w.x : w.y, 0u, i & 1 ? 0x4432u : 0x4410u);
    return h * (uint32_t)sizeof(float);
  }
};

// Barrier of the `threads` threads (whole warps) that share barrier `id`.
__device__ __forceinline__ void k6_group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// (The blocks an SM should hold: with strides at run time four blocks of 64
// registers a thread beat two of 96, at the IVFADC batch's shape; with fixed
// strides the rings' shared memory lets an SM hold three blocks, and ptxas
// left to itself takes 95 registers, which would make them two.)
template <int KS, typename CodeT>
__global__ void __launch_bounds__(BUDGET_THREADS, KS ? 3 : 4)
budget_adc_kernel(const float* __restrict__ luts,
                  const CodeT* __restrict__ codes_t,
                  const float* __restrict__ rowterm,
                  const int* __restrict__ tiles, float* __restrict__ out,
                  int m, int k, long long na, int P, int block_t, int n_tiles,
                  int spb, int depth, int unit_rows, int tg, int quads,
                  int bulk_tiles, int bulk_lut) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tile_s[K6_SPB_LIMIT];
  __shared__ __align__(8) unsigned long long
      bar_s[K6_MAX_GROUPS * K6_MAX_DEPTH + 1];
  const int b = blockIdx.x;
  const int p0 = blockIdx.y * spb;
  const int ns = min(spb, P - p0);
  const int mk = m * k;
  const int ks = KS ? KS : k;  // floats between LUT rows in shared memory
  const int cs = KS ? K6_FIXED_ROWS : unit_rows;  // codes between code runs
  const int ng = blockDim.x / tg;      // groups of the block
  const int grp = threadIdx.x / tg;    // this thread's group
  const int t = threadIdx.x - grp * tg;  // and its place there
  float* lut_s = reinterpret_cast<float*>(smem);
  const size_t term_bytes = budget_round16((size_t)unit_rows * sizeof(float));
  const size_t unit_bytes =
      budget_unit_bytes(m, unit_rows, cs, sizeof(CodeT));
  // the group's ring of `depth` places
  unsigned char* ring = smem +
                        budget_round16((size_t)m * ks * sizeof(float)) +
                        (size_t)grp * depth * unit_bytes;
  const int parts = block_t / unit_rows;  // units of one slot
  const int nu = ns * parts;              // units of the block
  // mbarrier of the group's ring place i; the LUT's is the last of all
  auto bar = [&](int i) { return adc_smem_addr(bar_s + grp * depth + i); };
  const uint32_t lut_bar = adc_smem_addr(bar_s + ng * depth);

  bool last = false;  // one of this thread's slots names the last tile
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int tile = tiles[(long long)b * P + p0 + i];
    tile_s[i] = budget_tile_ok(tile, n_tiles) ? tile : -1;
    last |= tile == n_tiles - 1;
  }
  const float* lut = luts + (long long)b * mk;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= ng * depth; ++i)
      mbar_init(adc_smem_addr(bar_s + i), 1);
    mbar_init_fence();
    if (bulk_lut) {  // at once: the LUT does not wait for the tile ids
      mbar_expect_tx(lut_bar, mk * (uint32_t)sizeof(float));
      bulk_copy(adc_smem_addr(lut_s), lut, mk * (uint32_t)sizeof(float),
                lut_bar);
    }
  }
  if (!bulk_lut)  // also where the rows are padded to KS
    for (int i = threadIdx.x; i < mk; i += blockDim.x)
      lut_s[(i / k) * ks + i % k] = lut[i];
  __syncthreads();  // tile_s, the mbarriers, a LUT copied by hand
  // Slots that name the table's last tile need no copy and no sums if its
  // row terms are all +inf (LUT sums are finite): make them bad ids.
  if (__syncthreads_or(last) &&
      budget_last_tile_is_inf(rowterm, n_tiles, block_t)) {
    for (int i = threadIdx.x; i < ns; i += blockDim.x)
      if (tile_s[i] == n_tiles - 1) tile_s[i] = -1;
    __syncthreads();
  }
  // From here on the groups go their own ways: group g takes units g,
  // g + ng, ... of the block and meets only at its own barrier.

  // Unit u of the block is part u % parts of slot u / parts.
  auto slot_of = [&](int u) { return parts == 1 ? u : u / parts; };
  // Ask for a unit's rows; a bad tile has none.
  auto fetch = [&](int u, int place) {
    const int slot = slot_of(u);
    const int tile = tile_s[slot];
    if (tile < 0) return;
    unsigned char* at = ring + (size_t)place * unit_bytes;
    budget_copy_rows<CodeT>(
        reinterpret_cast<CodeT*>(at + term_bytes),
        reinterpret_cast<float*>(at), codes_t, rowterm, na, m,
        (long long)tile * block_t + (u - slot * parts) * unit_rows,
        unit_rows, cs, bulk_tiles, bar(place), t, tg);
  };
  auto after = [&](int place) { return place + 1 == depth ? 0 : place + 1; };

  int ahead = grp, ahead_place = 0;  // the next unit to ask for, and where
  for (int i = 0; i < depth - 1 && ahead < nu; ++i) {
    fetch(ahead, ahead_place);
    ahead += ng;
    ahead_place = after(ahead_place);
  }
  if (bulk_lut) mbar_wait(lut_bar, 0);
  unsigned phases = 0;  // bit i: the parity ring place i completes next
  for (int u = grp, place = 0; u < nu; u += ng, place = after(place)) {
    // The group is done with the unit before this one, whose place the unit
    // depth-1 ahead takes; plain copies of this unit have landed.
    k6_group_sync(grp + 1, tg);
    if (ahead < nu) {
      fetch(ahead, ahead_place);
      ahead += ng;
      ahead_place = after(ahead_place);
    }
    const int slot = slot_of(u);
    float* o = out + ((long long)b * P + p0 + slot) * block_t +
               (u - slot * parts) * unit_rows;
    if (tile_s[slot] < 0) {
      for (int r = t; r < unit_rows; r += tg) o[r] = budget_inf();
      continue;
    }
    if (bulk_tiles) {
      mbar_wait(bar(place), (phases >> place) & 1u);
      phases ^= 1u << place;
    }
    const unsigned char* at = ring + (size_t)place * unit_bytes;
    const float* term_s = reinterpret_cast<const float*>(at);
    const CodeT* code_s = reinterpret_cast<const CodeT*>(at + term_bytes);
    if (quads) {  // four neighbouring rows a thread, their codes in one load
      for (int r = 4 * t; r < unit_rows; r += 4 * tg) {
        const CodeT* cr = code_s + r;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll(KS ? 3 : 2)
        for (int j = 0; j < m; ++j) {
          const K6Codes<CodeT, KS != 0> c(cr + (size_t)j * cs);
          const char* lj = reinterpret_cast<const char*>(lut_s + j * ks);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i] += *reinterpret_cast<const float*>(lj + c.byte_offset(i));
        }
        const float4 rt = *reinterpret_cast<const float4*>(term_s + r);
        *reinterpret_cast<float4*>(o + r) = make_float4(
            acc[0] + rt.x, acc[1] + rt.y, acc[2] + rt.z, acc[3] + rt.w);
      }
    } else {
      for (int r = t; r < unit_rows; r += tg) {
        const CodeT* cr = code_s + r;
        float acc = 0.f;
#pragma unroll 6
        for (int j = 0; j < m; ++j)
          acc += lut_s[j * ks + (int)cr[(size_t)j * cs]];
        o[r] = acc + term_s[r];
      }
    }
  }
}

// How a launch lays out its blocks and their shared memory.
struct K6Plan {
  int spb, unit_rows, depth, tg, groups, quads;
  size_t lut_bytes, unit_bytes;
};

// The plan for LUT rows `ks` floats apart (0: k apart, strides at run time);
// false if it does not fit. With fixed strides a unit is a whole tile of at
// most K6_FIXED_ROWS rows; with strides at run time the largest halving of a
// tile (the whole tile as a rule) of which two fit beside the LUT. spb,
// depth: 0 lets the plan choose.
static bool k6_plan(int B, int P, int m, int k, int block_t, int cb, int ks,
                    int spb, int depth, const float* out, K6Plan* p) {
  p->lut_bytes = budget_round16((size_t)m * (ks ? ks : k) * sizeof(float));
  int rows = block_t;
  auto unit = [&](int r) {
    return budget_unit_bytes(m, r, ks ? K6_FIXED_ROWS : r, cb);
  };
  if (ks && rows > K6_FIXED_ROWS) return false;
  while (!ks && p->lut_bytes + 2 * unit(rows) > K6_SMEM_MAX && rows % 2 == 0)
    rows /= 2;
  if (p->lut_bytes + 2 * unit(rows) > K6_SMEM_MAX) return false;
  p->unit_rows = rows;
  p->unit_bytes = unit(rows);
  if (depth == 0) depth = K6_DEPTH;
  while (p->lut_bytes + depth * p->unit_bytes > K6_SMEM_MAX) --depth;
  p->depth = depth;
  // A thread takes four rows of a unit, so a group is a quarter of a unit's
  // rows (whole warps) and the block's threads make as many groups as fit.
  // A launch of few units (a single query's probe) is one unit's latency,
  // which is shorter with a thread to a row: there, unless four rows a
  // thread still fill the block, and where a unit's rows are no multiple of
  // four or the output is not 16-byte aligned, a thread takes one row.
  const bool few = (long long)B * P * (block_t / rows) <= K6_SMALL_UNITS &&
                   rows < 4 * BUDGET_THREADS;
  p->quads = !few && rows % 4 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0;
  p->tg = 32;
  while ((p->quads ? 4 : 1) * p->tg < rows && p->tg < BUDGET_THREADS)
    p->tg *= 2;
  int groups = BUDGET_THREADS / p->tg;
  while (groups > 1 &&
         p->lut_bytes + (size_t)groups * depth * p->unit_bytes >
             K6_SMEM_TARGET)
    groups /= 2;
  if (spb == 0) {
    spb = groups * budget_slots_per_block(B, P, K6_TARGET_GROUPS, K6_MAX_SPG);
    if (spb > K6_SPB_LIMIT) spb = K6_SPB_LIMIT;
  }
  p->spb = spb;
  // no more groups than a full block has units
  const long long units = (long long)(spb < P ? spb : P) * (block_t / rows);
  while (groups > units) groups /= 2;
  p->groups = groups;
  return (P + spb - 1) / spb <= 65535;
}

template <int KS, typename CodeT>
static cudaError_t launch_ks(const float* luts, const CodeT* codes_t,
                             const float* rowterm, const int* tiles,
                             float* out, int B, int m, int k, long long na,
                             int P, int block_t, const K6Plan& p,
                             cudaStream_t stream) {
  const size_t smem =
      p.lut_bytes + (size_t)p.groups * p.depth * p.unit_bytes;
  cudaError_t err = adc_allow_smem(budget_adc_kernel<KS, CodeT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)((P + p.spb - 1) / p.spb));
  budget_adc_kernel<KS, CodeT><<<grid, p.groups * p.tg, smem, stream>>>(
      luts, codes_t, rowterm, tiles, out, m, k, na, P, block_t,
      (int)(na / block_t), p.spb, p.depth, p.unit_rows, p.tg, p.quads,
      budget_bulk_tiles(codes_t, rowterm, na, block_t, p.unit_rows,
                        (int)sizeof(CodeT)),
      reinterpret_cast<uintptr_t>(luts) % 16 == 0 && (m * k) % 4 == 0 &&
          (KS == 0 || KS == k));
  return cudaGetLastError();
}

// spb, depth: 0 lets the plan choose (K6_TARGET_GROUPS, K6_MAX_SPG;
// K6_DEPTH).
template <typename CodeT>
static cudaError_t launch(const float* luts, const void* codes_t,
                          const float* rowterm, const int* tiles, float* out,
                          int B, int m, int k, long long na, int P,
                          int block_t, int spb, int depth,
                          cudaStream_t stream) {
  const int cb = (int)sizeof(CodeT);
  if (B < 1 || P < 1 || m < 1 || k < 1 ||
      (size_t)m * k * sizeof(float) > K6_SMEM_MAX ||
      !budget_shape_ok(na, block_t) || spb < 0 || spb > K6_SPB_LIMIT ||
      depth < 0 || depth == 1 || depth > K6_MAX_DEPTH)
    return cudaErrorInvalidValue;
  const CodeT* c = static_cast<const CodeT*>(codes_t);
  K6Plan p;
  if constexpr (sizeof(CodeT) == 1) {
    if (k <= 32 && k6_plan(B, P, m, k, block_t, cb, 32, spb, depth, out, &p))
      return launch_ks<32, CodeT>(luts, c, rowterm, tiles, out, B, m, k, na,
                                  P, block_t, p, stream);
  }
  if (!k6_plan(B, P, m, k, block_t, cb, 0, spb, depth, out, &p))
    return cudaErrorInvalidValue;
  return launch_ks<0, CodeT>(luts, c, rowterm, tiles, out, B, m, k, na, P,
                             block_t, p, stream);
}

// The entry point with the slots per block and the ring depth given (0: the
// kernel's choice), for sweeps and tests.
extern "C" int pw2v_budget_adc_spb(const void* luts, const void* codes_t,
                                   int code_bytes, const void* rowterm,
                                   const void* tiles, void* out, int B, int m,
                                   int k, long long na, int P, int block_t,
                                   int spb, int depth, void* stream) {
  const float* l = static_cast<const float*>(luts);
  const float* rt = static_cast<const float*>(rowterm);
  const int* t = static_cast<const int*>(tiles);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(l, codes_t, rt, t, o, B, m, k, na, P, block_t, spb,
                           depth, s);
  if (code_bytes == 2)
    return launch<int16_t>(l, codes_t, rt, t, o, B, m, k, na, P, block_t, spb,
                           depth, s);
  return cudaErrorInvalidValue;
}

extern "C" int pw2v_budget_adc(const void* luts, const void* codes_t,
                               int code_bytes, const void* rowterm,
                               const void* tiles, void* out, int B, int m,
                               int k, long long na, int P, int block_t,
                               void* stream) {
  return pw2v_budget_adc_spb(luts, codes_t, code_bytes, rowterm, tiles, out,
                             B, m, k, na, P, block_t, 0, 0, stream);
}
