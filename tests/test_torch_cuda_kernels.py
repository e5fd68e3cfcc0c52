"""The port's Hopper kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped where no CUDA device is present).

Run on an H100 (whose Python has no JAX, which ``tests/conftest.py``
imports): ``python -m pytest tests/test_torch_cuda_kernels.py -q
--noconftest``.

Tolerances:
- K2 dense ADC: equal to the plain version (the kernel sums subspaces in
  the plain version's order), at every query block of every entry point;
- K4 binned ADC: mins and ids equal to the plain version's (subspaces
  summed in its order, the smallest id on ties), and the binned contract:
  every id lies in its own bin and points at a row whose dense distance
  equals the bin min;
- K1 fused exact: the binned contract with atol 1e-3 — bf16 inputs,
  float32 sums over 304 terms taken on the tensor cores in another order
  than the plain matmul's; exact ties take the smallest id;
- K6 / K7 budget ADC: the same +inf entries, and the finite ones within
  atol 1e-5 for K6's boundary grid and equal everywhere else (subspaces
  summed in the plain version's order, then the row term); K7's pair
  layout is held to the plain layout's invariants;
- K9 / K10 budget exact: atol 1e-4 on the finite shifted scores and the
  same +inf entries (float32 queries, bf16 rows widened exactly, float32
  sums over up to 1024 products in another order than the plain matmul's;
  K9 reads queries narrower than the table unpadded; K10
  splits each query value into three bf16 parts, which hold it exactly,
  for the tensor cores, so queries of norm 10 hold 1e-4 too);
- K3 / K5 / K8 over int8 LUTs: exact integer sums (K3's and K5's packed
  16-bit lanes too, at m up to 258, and their unpacked sums past it) and
  the plain version's rounding of the rescale (and of K8's row-term add),
  so K3 and K5 are held to equality (mins, ids and +inf / −1 slots) and
  K8 to 0 on the finite entries with the same +inf entries;
- row sharding on four shards of ``cuda:0``: K2 / K3 once per shard and
  equal to the plain version on a shard's (m, S) codes, K6 / K7 equal and
  K9 / K10 within 1e-4 on a shard's join tiles at ``block_t = 128``, and
  the sharded engine's families equal to a CPU mesh's up to ties (1e-5;
  1e-4 for the IVFADC decomposition, 1e-2 where the exact budget round
  reads bf16 rows).
"""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu_torch.ops import kernels

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device"),
]

N_EDGES = (2047, 2048, 2049, 8191, 8193)
B_EDGES = (1, 257)
# K2 and K4 stage 16 queries a block at 12x256 (4 at 12x1024): ragged blocks
K4_B = (1, 16, 17, 33, 257)
# K1 takes 128 queries a block, 64 a warpgroup, and 8192-row tiles
K1_N = (8191, 8192, 8193, 3 * 8192 + 5)
K1_B = (1, 63, 64, 65, 128, 257, 1024)
CODEBOOKS = ((12, 256, torch.uint8), (60, 16, torch.uint8),
             (12, 1024, torch.int16))
# K2 also serves the IVPQ join's dense round: its fine and fused-pair books
DENSE_BOOKS = CODEBOOKS + ((30, 32, torch.uint8), (15, 1024, torch.int16))
BLOCKS = (128, 256, 1024)
# IVFADC residuals, the IVPQ join's fine codebook, its fused-pair LUTs.
BUDGET_BOOKS = ((12, 256, torch.uint8), (30, 32, torch.uint8),
                (15, 1024, torch.int16))


def _adc_inputs(seed, B, m, k, n, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 4.0
    codes_t = torch.randint(0, k, (m, n), generator=g, device="cuda")
    return luts, codes_t.to(dtype).contiguous()


@pytest.mark.parametrize("n", N_EDGES)
@pytest.mark.parametrize("B", K4_B)
@pytest.mark.parametrize("m,k,dtype", DENSE_BOOKS)
def test_adc_scan_matches_plain(n, B, m, k, dtype):
    luts, codes_t = _adc_inputs(n + B + m, B, m, k, n, dtype)
    before = kernels.KERNELS["adc_scan"].launches
    got = kernels.adc_scan(luts, codes_t)
    torch.cuda.synchronize()
    assert kernels.KERNELS["adc_scan"].launches == before + 1
    assert torch.equal(got, kernels.adc_scan_plain(luts, codes_t))


def _misaligned_codes(seed, m, k, n, dtype):
    """An (m, n) code table that is a contiguous view one element into its
    buffer, so its rows are not 16-byte aligned."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randint(0, k, (m * n + 1,), generator=g, device="cuda")
    codes_t = buf.to(dtype)[1:].view(m, n)
    assert codes_t.is_contiguous() and codes_t.data_ptr() % 16 != 0
    return codes_t


@pytest.mark.parametrize("lut_dtype", ("bf16", "int8"))
@pytest.mark.parametrize("m,k,dtype", ((12, 256, torch.uint8),
                                       (12, 1024, torch.int16)))
def test_dense_adc_takes_unaligned_codes(lut_dtype, m, k, dtype):
    """K2 and K3 copy the codes without cp.async when a subspace's run is
    not 16-byte aligned: here N·code_bytes is a multiple of 16 but the
    table starts one element into its buffer."""
    n, B = 4096, 33
    codes_t = _misaligned_codes(n + m, m, k, n, dtype)
    luts = torch.rand(B, m, k, generator=torch.Generator(
        device="cuda").manual_seed(m), device="cuda") * 4.0
    got = kernels.adc_scan(luts, codes_t, lut_dtype=lut_dtype)
    torch.cuda.synchronize()
    if lut_dtype == "int8":
        ql, sc = kernels.quantize_luts_int8(luts)
        want = kernels.adc_scan_plain(ql, codes_t, scale=sc)
    else:
        want = kernels.adc_scan_plain(luts, codes_t)
    assert torch.equal(got, want)


@pytest.mark.parametrize("qb", (16, 8, 4, 2, 1))
def test_adc_scan_every_query_block_matches_plain(qb):
    """K2 at each queries-per-block through the sweep entry point (the
    wrapper chooses 16 at 12x256)."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k, n = 37, 12, 256, 3001
    luts, codes_t = _adc_inputs(qb, B, m, k, n, torch.uint8)
    out = torch.full((B, n), float("nan"), device="cuda")
    err = _build.load().pw2v_adc_scan_qb(
        luts.data_ptr(), codes_t.data_ptr(), 1, out.data_ptr(), B, m, k, n,
        qb, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, kernels.adc_scan_plain(luts, codes_t))


@pytest.mark.parametrize("n", N_EDGES)
@pytest.mark.parametrize("B", K4_B)
@pytest.mark.parametrize("m,k,dtype", CODEBOOKS)
def test_adc_scan_binned_matches_plain(n, B, m, k, dtype):
    luts, codes_t = _adc_inputs(2 * n + B + m, B, m, k, n, dtype)
    mins, ids = kernels.adc_scan_binned(luts, codes_t)
    torch.cuda.synchronize()
    ref_mins, ref_ids = kernels.adc_scan_binned_plain(luts, codes_t)
    assert torch.equal(mins, ref_mins) and torch.equal(ids, ref_ids)
    dense = kernels.adc_scan_plain(luts, codes_t)
    kernels.verify_binned(mins, ids, ref_mins,
                          lambda i: torch.gather(dense, 1, i), block_n=2048,
                          bins=128, valid_n=n, atol=0.0)


@pytest.mark.parametrize("n", K1_N)
@pytest.mark.parametrize("B", K1_B)
def test_fused_exact_scan_matches_plain(n, B):
    rng = np.random.default_rng(n + B)
    v = rng.normal(size=(n, 300)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    vt = torch.as_tensor(v, device="cuda")
    table, norms, valid = kernels.tile_table(vt)
    q = kernels.pad_queries(vt[rng.integers(0, n, B)], table.shape[1])
    mins, ids = kernels.fused_exact_scan(q, table, norms)
    torch.cuda.synchronize()
    ref_mins, _ = kernels.fused_exact_scan_plain(q, table, norms)
    dense = norms[:valid][None] - 2.0 * (q.float() @ table[:valid].float().t())
    kernels.verify_binned(mins, ids, ref_mins,
                          lambda i: torch.gather(dense, 1, i), block_n=8192,
                          bins=128, valid_n=valid, atol=1e-3)


def test_fused_exact_scan_takes_the_smallest_id_on_ties():
    """Rows 3, 3 + 5*128 and 3 + 9*128 are equal, so they tie in bin 3 of
    tile 0: the bin's id is row 3 for the query that is that row, and the
    kernel's ids in that bin are the plain version's for every query."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(8192, 300)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[3 + 5 * 128] = v[3 + 9 * 128] = v[3]
    vt = torch.as_tensor(v, device="cuda")
    table, norms, _ = kernels.tile_table(vt)
    q = kernels.pad_queries(vt[[3, 10, 700, 3 + 5 * 128]], table.shape[1])
    mins, ids = kernels.fused_exact_scan(q, table, norms)
    ref_mins, ref_ids = kernels.fused_exact_scan_plain(q, table, norms)
    torch.cuda.synchronize()
    assert int(ids[0, 3]) == 3 and int(ids[3, 3]) == 3
    assert torch.equal(ids[:, 3], ref_ids[:, 3])
    torch.testing.assert_close(mins, ref_mins, atol=1e-3, rtol=0)


def test_wrappers_raise_on_bad_input():
    luts, codes_t = _adc_inputs(0, 2, 12, 256, 4096, torch.uint8)
    with pytest.raises(ValueError):
        kernels.adc_scan(luts, codes_t.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.adc_scan(luts.cpu(), codes_t)
    table, norms, _ = kernels.tile_table(torch.randn(100, 300, device="cuda"))
    with pytest.raises(ValueError):
        kernels.fused_exact_scan(torch.zeros(2, 304, device="cuda"), table,
                                 norms)
    with pytest.raises(ValueError, match="bins=128"):
        kernels.adc_scan_binned(luts, codes_t, block_n=2048, bins=64)
    wide, wide_norms, _ = kernels.tile_table(
        torch.randn(100, 456, device="cuda"))
    with pytest.raises(ValueError, match="448"):
        kernels.fused_exact_scan(kernels.pad_queries(wide[:2].float(), 456),
                                 wide, wide_norms)


def test_engine_on_cuda_matches_cpu(tmp_path):
    """The slice on the card: an engine saved on the CPU and loaded onto
    the card answers like the CPU engine (plain versions) in all three
    families, and each family launches its kernel."""
    from postgres_word2vec_tpu_torch import Freddy, VectorStore

    rng = np.random.default_rng(0)
    v = rng.normal(size=(20000, 48)).astype(np.float32)
    store = VectorStore.from_arrays([f"w{i}" for i in range(len(v))], v,
                                    device="cpu")
    cpu = Freddy.build(store, with_ivfadc=False, with_ivpq=False, pq_m=12,
                       pq_k=256, train_size=None, iters=4, opq_iters=2)
    cpu.save(tmp_path)
    gpu = Freddy.load(tmp_path, device="cuda")
    assert gpu.store.vectors.is_cuda and gpu.pq.codes.is_cuda
    q = cpu.store.vectors_norm[:64]
    for family, kernel in (("k_nearest_neighbour", None),
                           ("k_nearest_neighbour_pq", "adc_scan"),
                           ("k_nearest_neighbour_pq_pv", "adc_scan_binned")):
        cpu.set_knn_function(family)
        gpu.set_knn_function(family)
        before = kernels.launch_counts()
        d_g, i_g = gpu.knn_matrix(q.cuda(), 10)
        if kernel is not None:
            assert kernels.launch_counts()[kernel] == before[kernel] + 1
        d_c, i_c = cpu.knn_matrix(q, 10)
        if family == "k_nearest_neighbour_pq_pv":
            # card: shortlist from bin survivors; CPU: exact shortlist.
            # The re-rank is exact on both, so the card can only miss.
            assert torch.all(d_g.cpu() >= d_c - 1e-4)
            hits = sum(len(set(a.tolist()) & set(b.tolist()))
                       for a, b in zip(i_g.cpu(), i_c))
            assert hits / i_c.numel() >= 0.9
        else:
            torch.testing.assert_close(d_g.cpu(), d_c, atol=1e-4, rtol=0)
            assert (i_g.cpu() == i_c).float().mean() >= 0.99, family
        if family != "k_nearest_neighbour_pq":
            assert gpu.knn("w7", 3)[0][0] == "w7"


# ------------------------------------------------------ budget probes

def _budget_case(seed, B, m, k, dtype, block_t, nt=6, P=5):
    """A cell-aligned table of nt tiles + the inf tile, pad rows in tile 1,
    and tile plans that include the inf tile."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    na = (nt + 1) * block_t
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 4.0
    codes_t = torch.randint(0, k, (m, na), generator=g,
                            device="cuda").to(dtype)
    rowterm = torch.randn(na, generator=g, device="cuda")
    rowterm[block_t + block_t // 2:2 * block_t] = float("inf")
    rowterm[nt * block_t:] = float("inf")
    tiles = torch.randint(0, nt + 1, (B, P), generator=g, device="cuda",
                          dtype=torch.int32)
    return luts, codes_t, rowterm, tiles


def _assert_budget_close(got, want, atol):
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert not torch.isnan(got).any()
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    assert err <= atol, err


@pytest.mark.parametrize("block_t", BLOCKS)
@pytest.mark.parametrize("B", B_EDGES)
@pytest.mark.parametrize("m,k,dtype", BUDGET_BOOKS)
def test_budget_adc_matches_plain(block_t, B, m, k, dtype):
    luts, codes_t, rowterm, tiles = _budget_case(block_t + B + m, B, m, k,
                                                 dtype, block_t)
    before = kernels.KERNELS["budget_adc"].launches
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=block_t)
    assert kernels.KERNELS["budget_adc"].launches == before + 1
    want = kernels.budget_adc_plain(luts, codes_t, rowterm, tiles,
                                    block_t=block_t)
    _assert_budget_close(got, want, 1e-5)


# K6's ring of code tiles: slot counts around a block's share, plans of one
# tile, of inf tiles and of bad ids, the routes without cp.async, every
# slots-per-block and ring depth of the sweep entry point.

@pytest.mark.parametrize("P", (1, 5, 33))
@pytest.mark.parametrize("m,k,dtype", BUDGET_BOOKS)
def test_budget_adc_slot_counts_match_plain(P, m, k, dtype):
    luts, codes_t, rowterm, tiles = _budget_case(P + m, 37, m, k, dtype, 256,
                                                 P=P)
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=256)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=256), 0.0)


@pytest.mark.parametrize("plan", ("inf_tile", "bad_ids", "one_tile"))
def test_budget_adc_uniform_plans(plan):
    """A plan of nothing but the inf tile, one of nothing but ids outside
    the table (+inf everywhere, nothing read), and one whose slots all name
    the same tile (every unit of a block's ring holds the same rows)."""
    luts, codes_t, rowterm, tiles = _budget_case(21, 29, 30, 32, torch.uint8,
                                                 256, P=11)
    nt = codes_t.shape[1] // 256 - 1
    tiles[:] = {"inf_tile": nt, "bad_ids": -3, "one_tile": 2}[plan]
    if plan == "bad_ids":
        tiles[::2] = nt + 1
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=256)
    torch.cuda.synchronize()
    if plan == "one_tile":
        _assert_budget_close(got, kernels.budget_adc_plain(
            luts, codes_t, rowterm, tiles, block_t=256), 0.0)
        assert torch.isfinite(got).any()
    else:
        assert torch.isinf(got).all() and (got > 0).all()


@pytest.mark.parametrize("route", ("block_t", "codes", "luts"))
@pytest.mark.parametrize("m,k,dtype", ((12, 256, torch.uint8),
                                       (15, 1024, torch.int16),
                                       (5, 6, torch.uint8)))
def test_budget_adc_takes_unaligned_inputs(route, m, k, dtype):
    """K6 copies its tiles without cp.async when a tile's code runs do not
    start 16-byte aligned (block_t = 100; a table one element into its
    buffer) and its LUT when that is not (a LUT tensor one float into its
    buffer; 5x6 = 30 floats a query)."""
    block_t = 100 if route == "block_t" else 128
    luts, codes_t, rowterm, tiles = _budget_case(m + block_t, 57, m, k, dtype,
                                                 block_t)
    if route == "codes":
        buf = torch.zeros(codes_t.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = codes_t.reshape(-1)
        codes_t = buf[1:].view(m, -1)
        assert codes_t.data_ptr() % 16 != 0
    if route == "luts":
        buf = torch.zeros(luts.numel() + 1, device="cuda")
        buf[1:] = luts.reshape(-1)
        luts = buf[1:].view(luts.shape)
        assert luts.data_ptr() % 16 != 0 and luts.is_contiguous()
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=block_t)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


@pytest.mark.parametrize("spb", (0, 1, 2, 3, 4, 8, 12, 16, 24, 32, 64))
@pytest.mark.parametrize("depth", (0, 2, 3, 4))
def test_budget_adc_every_slots_per_block_and_depth_matches_plain(spb, depth):
    """K6 through the sweep entry point at each slots-per-block and ring
    depth (0: the kernel's own choice), P = 21 slots so that the last block
    of a query is ragged."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k, block_t, P = 17, 12, 256, 256, 21
    luts, codes_t, rowterm, tiles = _budget_case(spb + depth, B, m, k,
                                                 torch.uint8, block_t, P=P)
    tiles[1, 3] = -1
    out = torch.full((B, P * block_t), float("nan"), device="cuda")
    err = _build.load().pw2v_budget_adc_spb(
        luts.data_ptr(), codes_t.data_ptr(), 1, rowterm.data_ptr(),
        tiles.data_ptr(), out.data_ptr(), B, m, k, codes_t.shape[1], P,
        block_t, spb, depth, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = kernels.budget_adc_plain(luts, codes_t, rowterm,
                                    tiles.clamp(min=0), block_t=block_t)
    want[1, 3 * block_t:4 * block_t] = float("inf")
    _assert_budget_close(out, want, 0.0)


@pytest.mark.parametrize("block_t", (128, 512))
@pytest.mark.parametrize("m,k,dtype", ((60, 16, torch.uint8),
                                       (7, 100, torch.uint8),
                                       (6, 600, torch.int16),
                                       (5, 2000, torch.int16)))
def test_budget_adc_pads_lut_rows_to_its_fixed_strides(block_t, m, k, dtype):
    """uint8 tiles of at most 256 rows with k ≤ 32 take LUT rows 32 floats
    apart in shared memory (k = 16 is padded up to that); k = 100, 600 and
    2000 and 512-row tiles take the strides at run time."""
    luts, codes_t, rowterm, tiles = _budget_case(block_t + k, 31, m, k, dtype,
                                                 block_t, P=9)
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=block_t)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


@pytest.mark.parametrize("block_t", (6, 32, 50, 64, 100, 512, 2048))
@pytest.mark.parametrize("m,k,dtype", BUDGET_BOOKS)
def test_budget_adc_groups_and_rows_per_thread_match_plain(block_t, m, k,
                                                           dtype):
    """K6's threads take four rows each and form groups of a quarter of a
    tile's rows: eight groups of a warp at 32 to 100 rows, two at 512, one
    that loops at 2048; tiles of 6 and 50 rows (not a multiple of four) take
    one row a thread. P = 19 slots leave the groups unequal shares, and 23
    queries make more units than the launches that take a row a thread."""
    luts, codes_t, rowterm, tiles = _budget_case(block_t + m, 23, m, k, dtype,
                                                 block_t, P=19)
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=block_t)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


@pytest.mark.parametrize("case", ("out_off_16_bytes", "slots_past_threads"))
def test_budget_adc_sweep_entry_odd_layouts(case):
    """An output 4 bytes off a 16-byte boundary takes single stores; a LUT
    that leaves room for one group of a warp still stages a block of 64
    slots (more slots than threads)."""
    from postgres_word2vec_tpu_torch.ops import _build

    if case == "out_off_16_bytes":
        B, m, k, dtype, block_t, P, spb = 40, 30, 32, torch.uint8, 256, 9, 0
    else:
        B, m, k, dtype, block_t, P, spb = 5, 12, 4096, torch.int16, 16, 70, 64
    luts, codes_t, rowterm, tiles = _budget_case(5, B, m, k, dtype, block_t,
                                                 P=P)
    buf = torch.full((B * P * block_t + 1,), float("nan"), device="cuda")
    out = buf[1:] if case == "out_off_16_bytes" else buf[:-1]
    assert (out.data_ptr() % 16 != 0) == (case == "out_off_16_bytes")
    err = _build.load().pw2v_budget_adc_spb(
        luts.data_ptr(), codes_t.data_ptr(), codes_t.element_size(),
        rowterm.data_ptr(), tiles.data_ptr(), out.data_ptr(), B, m, k,
        codes_t.shape[1], P, block_t, spb, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    _assert_budget_close(out.view(B, P * block_t), kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


@pytest.mark.parametrize("last", ("all_inf", "one_finite_row"))
def test_budget_adc_kernels_skip_the_last_tile_only_if_all_inf(last):
    """K6 and K8 write +inf for slots on the table's last tile without
    reading its codes, but only after seeing that all its row terms are
    +inf: a last tile with one finite row is summed like any other."""
    luts, codes_t, rowterm, tiles = _budget_case(41, 47, 30, 32, torch.uint8,
                                                 256, P=7)
    nt = codes_t.shape[1] // 256 - 1
    tiles[:, 4:] = nt
    if last == "one_finite_row":
        rowterm[nt * 256 + 77] = 0.25
    want = kernels.budget_adc_plain(luts, codes_t, rowterm, tiles,
                                    block_t=256)
    assert bool(torch.isfinite(want[:, 4 * 256:]).any()) == (
        last == "one_finite_row")
    _assert_budget_close(kernels.budget_adc(
        luts, codes_t, rowterm, tiles, block_t=256), want, 0.0)
    ql, sc = kernels.quantize_luts_int8(luts)
    _assert_budget_close(
        kernels.budget_adc_grouped_int8(ql, sc, codes_t, rowterm, tiles,
                                        block_t=256, rows=32),
        kernels.budget_adc_plain(ql, codes_t, rowterm, tiles, block_t=256,
                                 scale=sc), 0.0)


@pytest.mark.parametrize("B", (3, 40))
def test_budget_adc_splits_tiles_that_do_not_fit_twice(B):
    """A 192 KB LUT (12x4096) leaves no room for two whole 1024-row tiles
    of int16 codes: the ring's unit becomes half a tile, a row a thread in a
    launch of few units (B = 3), four rows a thread in a larger one."""
    luts, codes_t, rowterm, tiles = _budget_case(31, B, 12, 4096, torch.int16,
                                                 1024, nt=3, P=4)
    got = kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=1024)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=1024), 0.0)


@pytest.mark.parametrize("block_t", BLOCKS)
@pytest.mark.parametrize("B", B_EDGES)
@pytest.mark.parametrize("m,k,dtype", BUDGET_BOOKS)
def test_budget_adc_grouped_matches_plain(block_t, B, m, k, dtype):
    luts, codes_t, rowterm, tiles = _budget_case(2 * block_t + B + m, B, m,
                                                 k, dtype, block_t)
    before = kernels.KERNELS["budget_adc_grouped"].launches
    got = kernels.budget_adc_grouped(luts, codes_t, rowterm, tiles,
                                     block_t=block_t, rows=32)
    assert kernels.KERNELS["budget_adc_grouped"].launches == before + 1
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


# K7's pair layout, staged widths, uniform plans and routes

def _assert_pair_layout(pairs, tog, tiles, n_tiles, rows):
    """The pair layout's contract: ⌈B·P/rows⌉ + n_tiles groups; every pair
    in exactly one slot; a group's real slots first; each slot's group on
    its pair's tile (ids outside the table: tile n_tiles); groups without
    a pair on the inf tile."""
    B, P = tiles.shape
    groups = -(-B * P // rows) + n_tiles
    assert pairs.shape == (groups, rows) and tog.shape == (groups,)
    real = pairs >= 0
    assert torch.equal(torch.sort(pairs[real]).values,
                       torch.arange(B * P, dtype=torch.int32,
                                    device=pairs.device))
    assert bool((real[:, 1:] <= real[:, :-1]).all())
    flat = tiles.reshape(-1).long()
    bucket = torch.where((flat >= 0) & (flat < n_tiles), flat, n_tiles)
    g = torch.arange(groups, device=pairs.device)[:, None].expand_as(pairs)
    assert torch.equal(tog[g[real]].long(), bucket[pairs[real].long()])
    assert bool((tog[~real.any(1)] == n_tiles - 1).all())


@pytest.mark.parametrize("rows", (1, 8, 32, 40))
@pytest.mark.parametrize("plan", ("mixed", "inf_tile", "bad_ids", "one_tile"))
def test_budget_pair_layout_holds_its_invariants(rows, plan):
    """The layout kernel against the plain layout's invariants, and the
    same tile per group and the same real slots as the plain version
    (buckets in tile order, each filled from its first slot); only the
    order of pairs inside a bucket may differ."""
    _, codes_t, _, tiles = _budget_case(rows, 257, 30, 32, torch.uint8, 256,
                                        P=13)
    n_tiles = codes_t.shape[1] // 256
    tiles[:, -2:] = n_tiles - 1
    if plan == "inf_tile":
        tiles[:] = n_tiles - 1
    elif plan == "bad_ids":
        tiles[::3] = -1
        tiles[1::3] = n_tiles + 5
    elif plan == "one_tile":
        tiles[:] = 2
    pairs, tog = kernels.budget_pair_layout(tiles, n_tiles, rows)
    torch.cuda.synchronize()
    _assert_pair_layout(pairs, tog, tiles, n_tiles, rows)
    want_pairs, want_tog = kernels.budget_pair_layout_plain(tiles, n_tiles,
                                                            rows)
    assert torch.equal(tog, want_tog)
    assert torch.equal(pairs >= 0, want_pairs >= 0)


def test_budget_pair_layout_takes_scratch_past_shared_memory():
    """A table of more tiles than the kernel's counts in shared memory
    (40,960): the counts go to scratch in device memory."""
    n_tiles = 50_000
    g = torch.Generator(device="cuda").manual_seed(3)
    tiles = torch.randint(-2, n_tiles + 2, (300, 20), generator=g,
                          device="cuda", dtype=torch.int32)
    pairs, tog = kernels.budget_pair_layout(tiles, n_tiles, 8)
    torch.cuda.synchronize()
    _assert_pair_layout(pairs, tog, tiles, n_tiles, 8)


def _k7_at_width(luts, codes_t, rowterm, tiles, block_t, rows, wmax,
                 out=None, rpt=0):
    """K7 through the entry point that takes the staged width and the rows
    a thread, into a NaN-poisoned (B, P·block_t) output → (CUDA error
    code, output)."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k = luts.shape
    na, P = codes_t.shape[1], tiles.shape[1]
    pairs, tog = kernels.budget_pair_layout(tiles, na // block_t, rows)
    if out is None:
        out = torch.full((B, P * block_t), float("nan"), device="cuda")
    err = _build.load().pw2v_budget_adc_grouped_w(
        luts.data_ptr(), codes_t.data_ptr(), codes_t.element_size(),
        rowterm.data_ptr(), pairs.data_ptr(), tog.data_ptr(), out.data_ptr(),
        B, m, k, na, P, tog.shape[0], rows, block_t, wmax, rpt,
        torch.cuda.current_stream().cuda_stream)
    return err, out


K7_GROUP_SIZES = (1, 4, 5, 8, 9, 16, 17, 32)


@pytest.mark.parametrize("rpt", (1, 4))
@pytest.mark.parametrize("wmax", (0, 1, 2, 4, 8, 16, 32))
@pytest.mark.parametrize("m,k,dtype", ((30, 32, torch.uint8),
                                       (20, 32, torch.int16),
                                       (12, 256, torch.uint8),
                                       (15, 1024, torch.int16)))
def test_budget_adc_grouped_every_group_size_and_width(wmax, m, k, dtype,
                                                       rpt):
    """Groups of 1, 4, 5, 8, 9, 16, 17 and 32 real pairs at every staged
    width and one or four rows a thread, with fixed strides (k = 32) and
    strides at run time: each pass stages the least width that holds what
    is left of its group (or ``wmax`` slots); a width over 16, or whose LUTs
    do not fit beside the tile, is refused. Every pair's row is written (no
    NaN left)."""
    luts, codes_t, rowterm, tiles = _sized_groups_case(
        wmax + m, m, k, dtype, 256, sizes=K7_GROUP_SIZES)
    err, got = _k7_at_width(luts, codes_t, rowterm, tiles, 256, 32, wmax,
                            rpt=rpt)
    qs = 1024 if k == 32 and m <= 32 else -(-m * k // 32) * 32
    lut_bytes = wmax * qs * 4
    if wmax > 16 or lut_bytes + m * 256 * codes_t.element_size() > 226 * 1024:
        assert err != 0
        return
    assert err == 0
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=256), 0.0)


@pytest.mark.parametrize("plan", ("inf_tile", "bad_ids", "one_tile"))
@pytest.mark.parametrize("rows", (8, 32))
def test_budget_adc_grouped_uniform_plans(plan, rows):
    """A plan of nothing but the inf tile, one of nothing but ids outside
    the table (+inf everywhere, nothing read), and one whose pairs all
    name the same tile (full groups, several passes each)."""
    luts, codes_t, rowterm, tiles = _budget_case(22, 29, 30, 32, torch.uint8,
                                                 256, P=11)
    nt = codes_t.shape[1] // 256 - 1
    tiles[:] = {"inf_tile": nt, "bad_ids": -3, "one_tile": 2}[plan]
    if plan == "bad_ids":
        tiles[::2] = nt + 1
    err, got = _k7_at_width(luts, codes_t, rowterm, tiles, 256, rows, 0)
    assert err == 0
    torch.cuda.synchronize()
    if plan == "one_tile":
        _assert_budget_close(got, kernels.budget_adc_plain(
            luts, codes_t, rowterm, tiles, block_t=256), 0.0)
        assert torch.isfinite(got).any()
    else:
        assert torch.isinf(got).all() and (got > 0).all()


@pytest.mark.parametrize("rpt", (1, 4))
@pytest.mark.parametrize("route", ("block_t", "codes", "luts", "out"))
@pytest.mark.parametrize("m,k,dtype", ((12, 256, torch.uint8),
                                       (15, 1024, torch.int16),
                                       (5, 6, torch.uint8),
                                       (3, 12, torch.uint8)))
def test_budget_adc_grouped_takes_unaligned_inputs(route, m, k, dtype, rpt):
    """K7's routes without wide loads or bulk copies: code tiles copied by
    plain loads (block_t = 100; a table one element into its buffer), LUTs
    staged a float at a time (a LUT tensor one float into its buffer; m·k
    = 30, not a multiple of 4), +inf written a float at a time (an output
    4 bytes off a 16-byte boundary, where four rows a thread also give way
    to one)."""
    block_t = 100 if route == "block_t" else 128
    luts, codes_t, rowterm, tiles = _budget_case(m + k + block_t, 45, m, k,
                                                 dtype, block_t)
    tiles[:, -1] = codes_t.shape[1] // block_t - 1
    if route == "codes":
        buf = torch.zeros(codes_t.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = codes_t.reshape(-1)
        codes_t = buf[1:].view(m, -1)
        assert codes_t.data_ptr() % 16 != 0
    if route == "luts":
        buf = torch.zeros(luts.numel() + 1, device="cuda")
        buf[1:] = luts.reshape(-1)
        luts = buf[1:].view(luts.shape)
        assert luts.data_ptr() % 16 != 0 and luts.is_contiguous()
    out = None
    if route == "out":
        buf = torch.full((tiles.numel() * block_t + 1,), float("nan"),
                         device="cuda")
        out = buf[1:].view(tiles.shape[0], -1)
        assert out.data_ptr() % 16 != 0
    err, got = _k7_at_width(luts, codes_t, rowterm, tiles, block_t, 32, 0,
                            out, rpt)
    assert err == 0
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=block_t), 0.0)


@pytest.mark.parametrize("last", ("all_inf", "one_finite_row"))
def test_budget_adc_grouped_skips_the_last_tile_only_if_all_inf(last):
    """K7 writes +inf for pairs on the table's last tile without reading
    its codes only after seeing that all its row terms are +inf."""
    luts, codes_t, rowterm, tiles = _budget_case(43, 47, 30, 32, torch.uint8,
                                                 256, P=7)
    nt = codes_t.shape[1] // 256 - 1
    tiles[:, 4:] = nt
    if last == "one_finite_row":
        rowterm[nt * 256 + 77] = 0.25
    got = kernels.budget_adc_grouped(luts, codes_t, rowterm, tiles,
                                     block_t=256, rows=32)
    _assert_budget_close(got, kernels.budget_adc_plain(
        luts, codes_t, rowterm, tiles, block_t=256), 0.0)


def _exact_case(seed, B, block_t, d=300, nt=6, P=5, q_norm=1.0, D=None):
    """Unit rows of width d in a (NA, D) bf16 table, D = d rounded up to a
    multiple of 8 unless given, pad rows in tile 1 and the inf tile;
    queries are rows of tile 0 scaled to norm ``q_norm``."""
    rng = np.random.default_rng(seed)
    na = (nt + 1) * block_t
    v = rng.normal(size=(na, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[block_t + block_t // 2:2 * block_t] = 0.0       # pad rows
    v[nt * block_t:] = 0.0                             # the inf tile
    vt = torch.as_tensor(v, device="cuda")
    vecs = torch.zeros(na, D or -(-d // 8) * 8, dtype=torch.bfloat16,
                       device="cuda")
    vecs[:, :d] = vt.to(torch.bfloat16)
    rownorm = torch.sum(vt * vt, dim=1)
    rownorm[block_t + block_t // 2:2 * block_t] = float("inf")
    rownorm[nt * block_t:] = float("inf")
    q = vt[torch.as_tensor(rng.integers(0, block_t, B), device="cuda")]
    tiles = torch.as_tensor(rng.integers(0, nt + 1, (B, P)), device="cuda",
                            dtype=torch.int32)
    return (q * q_norm).contiguous(), vecs, rownorm, tiles


@pytest.mark.parametrize("block_t", BLOCKS)
@pytest.mark.parametrize("B", B_EDGES)
def test_budget_exact_matches_plain(block_t, B):
    q, vecs, rownorm, tiles = _exact_case(block_t + B, B, block_t)
    before = kernels.KERNELS["budget_exact"].launches
    got = kernels.budget_exact(q, vecs, rownorm, tiles, block_t=block_t)
    assert kernels.KERNELS["budget_exact"].launches == before + 1
    want = kernels.budget_exact_plain(q, vecs, rownorm, tiles,
                                      block_t=block_t)
    _assert_budget_close(got, want, 1e-4)


@pytest.mark.parametrize("P", (1, 5, 33))
@pytest.mark.parametrize("d,D", ((5, 8), (20, 24), (300, 304), (1000, 1024)))
def test_budget_exact_single_query_matches_plain(P, d, D):
    """K9 at B = 1, the single query's probe, whose slots' rows spread over
    several blocks: row widths D = 8, 24, 304 and 1024 (one, two and four
    16-byte chunks a lane) with queries of d < D values read unpadded, a
    plan with the inf tile and an id outside the table."""
    q, vecs, rownorm, tiles = _exact_case(P + d, 1, 256, d=d, D=D, P=P)
    nt = vecs.shape[0] // 256 - 1
    tiles[0, -1] = nt
    if P > 1:
        tiles[0, 0] = -3
    before = kernels.KERNELS["budget_exact"].launches
    got = kernels.budget_exact(q, vecs, rownorm, tiles, block_t=256)
    assert kernels.KERNELS["budget_exact"].launches == before + 1
    want = kernels.budget_exact_plain(q, vecs, rownorm, tiles.clamp(min=0),
                                      block_t=256)
    if P > 1:
        want[0, :256] = float("inf")
    _assert_budget_close(got, want, 1e-4)


@pytest.mark.parametrize("bps", (0, 1, 2, 3, 8, 32, 256))
@pytest.mark.parametrize("B", (1, 3, 40))
def test_budget_exact_every_blocks_per_slot_matches_plain(bps, B):
    """K9 through the entry point that takes the blocks a slot is split
    over (0: the kernel's choice; 3 leaves a ragged last block, 256 a
    block a row), into a NaN-poisoned output that comes back whole."""
    from postgres_word2vec_tpu_torch.ops import _build

    q, vecs, rownorm, tiles = _exact_case(bps + B, B, 256, P=9)
    out = torch.full((B, 9 * 256), float("nan"), device="cuda")
    err = _build.load().pw2v_budget_exact_bps(
        q.data_ptr(), vecs.data_ptr(), rownorm.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), B, q.shape[1], vecs.shape[1], vecs.shape[0], 9, 256,
        bps, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    _assert_budget_close(out, kernels.budget_exact_plain(
        q, vecs, rownorm, tiles, block_t=256), 1e-4)


@pytest.mark.parametrize("last", ("all_inf", "one_finite_row"))
@pytest.mark.parametrize("B", (1, 40))
def test_budget_exact_skips_the_last_tile_only_if_all_inf(last, B):
    """K9 writes +inf for slots on the table's last tile without reading
    its vectors only after seeing that all its row norms are +inf."""
    q, vecs, rownorm, tiles = _exact_case(B + 7, B, 256, P=7)
    nt = vecs.shape[0] // 256 - 1
    tiles[:, 4:] = nt
    if last == "one_finite_row":
        rownorm[nt * 256 + 77] = 0.25
    got = kernels.budget_exact(q, vecs, rownorm, tiles, block_t=256)
    want = kernels.budget_exact_plain(q, vecs, rownorm, tiles, block_t=256)
    assert bool(torch.isfinite(want[:, 4 * 256:]).any()) == (
        last == "one_finite_row")
    _assert_budget_close(got, want, 1e-4)


@pytest.mark.parametrize("block_t", BLOCKS)
@pytest.mark.parametrize("B", B_EDGES)
@pytest.mark.parametrize("rows", (8, 32))
def test_budget_exact_grouped_matches_plain(block_t, B, rows):
    q, vecs, rownorm, tiles = _exact_case(2 * block_t + B, B, block_t)
    before = kernels.KERNELS["budget_exact_grouped"].launches
    got = kernels.budget_exact_grouped(q, vecs, rownorm, tiles,
                                       block_t=block_t, rows=rows)
    assert kernels.KERNELS["budget_exact_grouped"].launches == before + 1
    _assert_budget_close(got, kernels.budget_exact_plain(
        q, vecs, rownorm, tiles, block_t=block_t), 1e-4)


@pytest.mark.parametrize("rows", (1, 7, 8, 32))
@pytest.mark.parametrize("d", (8, 24, 300))
@pytest.mark.parametrize("q_norm", (1.0, 10.0))
@pytest.mark.parametrize("block_t", (100, 256))
def test_budget_exact_grouped_tensor_core_edges(rows, d, q_norm, block_t):
    """K10's tensor-core product at one to four n-tiles of 8 slots (rows 1,
    7, 8, 32), row widths D = 8, 24 and 304 (D % 32 = 8, 24, 16: the last
    chunk zero-filled), a tile height that leaves the last 32-row task
    ragged (100), and queries of norm 10, where bf16 queries alone would
    miss 1e-4 by far and a two-part split by up to ~1.5x: the three-part
    split holds it."""
    q, vecs, rownorm, tiles = _exact_case(rows + d + block_t, 64, block_t,
                                          d=d, q_norm=q_norm)
    before = kernels.KERNELS["budget_exact_grouped"].launches
    got = kernels.budget_exact_grouped(q, vecs, rownorm, tiles,
                                       block_t=block_t, rows=rows)
    assert kernels.KERNELS["budget_exact_grouped"].launches == before + 1
    _assert_budget_close(got, kernels.budget_exact_plain(
        q, vecs, rownorm, tiles, block_t=block_t), 1e-4)


def test_budget_kernels_read_a_bad_tile_as_the_inf_tile():
    luts, codes_t, rowterm, tiles = _budget_case(7, 3, 12, 256, torch.uint8,
                                                 128)
    tiles[0, 0], tiles[1, 1] = -1, 10 ** 6
    for fn in (kernels.budget_adc, kernels.budget_adc_grouped):
        out = fn(luts, codes_t, rowterm, tiles, block_t=128)
        torch.cuda.synchronize()
        assert torch.isinf(out[0, :128]).all()
        assert torch.isinf(out[1, 128:256]).all()
    q, vecs, rownorm, t2 = _exact_case(8, 3, 128)
    t2[0, 0] = -5
    for fn in (kernels.budget_exact, kernels.budget_exact_grouped):
        out = fn(q, vecs, rownorm, t2, block_t=128)
        torch.cuda.synchronize()
        assert torch.isinf(out[0, :128]).all()


def test_budget_wrappers_raise_on_bad_input():
    luts, codes_t, rowterm, tiles = _budget_case(9, 2, 12, 256, torch.uint8,
                                                 128)
    with pytest.raises(ValueError):
        kernels.budget_adc(luts, codes_t.to(torch.int32), rowterm, tiles,
                           block_t=128)
    with pytest.raises(ValueError):
        kernels.budget_adc(luts, codes_t, rowterm, tiles, block_t=100)
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.budget_adc_grouped(luts, codes_t, rowterm.cpu(), tiles,
                                   block_t=128)
    q, vecs, rownorm, t2 = _exact_case(10, 2, 128)
    with pytest.raises(ValueError):
        kernels.budget_exact(q, vecs.float(), rownorm, t2, block_t=128)
    with pytest.raises(ValueError):
        kernels.budget_exact_grouped(q, vecs, rownorm, t2, block_t=128,
                                     rows=33)
    ql, sc = kernels.quantize_luts_int8(luts)
    with pytest.raises(ValueError):
        kernels.budget_adc_grouped_int8(ql.float(), sc, codes_t, rowterm,
                                        tiles, block_t=128)
    with pytest.raises(ValueError):
        kernels.adc_scan_int8(ql, sc[:1], codes_t)


def test_budget_adc_auto_int8_runs_k8_or_warns():
    """The join regime routes int8 to K8 and agrees with the int8 plain
    version; a sparse probe warns and runs K6 on float32 LUTs, as the JAX
    package does."""
    luts, codes_t, rowterm, tiles = _budget_case(11, 64, 30, 32, torch.uint8,
                                                 256, P=8)
    before = kernels.launch_counts()
    got = kernels.budget_adc_auto(luts, codes_t, rowterm, tiles, block_t=256,
                                  lut_dtype="int8")
    after = kernels.launch_counts()
    assert after["budget_adc_grouped_int8"] == (
        before["budget_adc_grouped_int8"] + 1)
    ql, sc = kernels.quantize_luts_int8(luts)
    _assert_budget_close(got, kernels.budget_adc_plain(
        ql, codes_t, rowterm, tiles, block_t=256, scale=sc), 0.0)
    sparse = tiles[:2, :1]
    with pytest.warns(UserWarning, match="no int8 variant"):
        out = kernels.budget_adc_auto(luts[:2], codes_t, rowterm, sparse,
                                      block_t=256, lut_dtype="int8")
    assert kernels.launch_counts()["budget_adc"] == after["budget_adc"] + 1
    _assert_budget_close(out, kernels.budget_adc_plain(
        luts[:2], codes_t, rowterm, sparse, block_t=256), 1e-5)


def test_probe_engine_on_cuda_matches_cpu(tmp_path, monkeypatch):
    """Slice 2 on the card: an IVFADC + IVPQ engine saved on the CPU and
    loaded onto the card answers like the CPU engine (plain versions) in
    the IVFADC batch family and the join's three methods, and each path
    launches its budget kernels."""
    import functools
    from postgres_word2vec_tpu_torch import Freddy, VectorStore

    rng = np.random.default_rng(1)
    c = rng.normal(size=(64, 48))
    v = (c[rng.integers(0, 64, 20000)]
         + 0.6 * rng.normal(size=(20000, 48))).astype(np.float32)
    store = VectorStore.from_arrays([f"w{i}" for i in range(len(v))], v,
                                    device="cpu")
    cpu = Freddy.build(store, with_pq=False, ivfadc_m=12, ivfadc_k=64,
                       k_coarse=64, ivpq_m=12, ivpq_k=16, ivpq_k_coarse=64,
                       ivpq_coarse_positions=1, train_size=None, iters=4)
    cpu.save(tmp_path)
    gpu = Freddy.load(tmp_path, device="cuda")
    assert gpu.ivfadc.codes_sorted.is_cuda and gpu.ivpq.codes.is_cuda
    words = [f"w{i}" for i in range(0, 512, 2)]
    kernels.reset_launch_counts()
    got = gpu.knn_batch(words, 10)
    launched = kernels.launch_counts()
    assert launched["budget_adc"] + launched["budget_adc_grouped"] > 0
    _same_rows(got, cpu.knn_batch(words, 10))
    targets = list(range(0, 20000, 3))
    for method, kernel in ((0, "budget_adc_grouped"), (1,
                           "budget_exact_grouped"), (2, "budget_adc_grouped")):
        for eng in (cpu, gpu):
            eng.set_alpha(50)
            eng.set_method_flag(method)
        before = kernels.launch_counts()[kernel]
        got = gpu.knn_in_ivpq_batch(words, 5, targets)
        assert kernels.launch_counts()[kernel] > before, (method, kernel)
        with monkeypatch.context() as mp:
            if method == 1:
                # the card scores method 1 on the budget tiles' bf16 rows;
                # the CPU's default dense round reads float32 rows, so hold
                # the card to the CPU's budget round on the same rows
                mp.setattr(cpu.ivpq, "search_join", functools.partial(
                    type(cpu.ivpq).search_join, cpu.ivpq, impl="budget"))
            want = cpu.knn_in_ivpq_batch(words, 5, targets)
        _same_rows(got, want, hit_floor=0.95, atol=1e-4)
    gpu.set_method_flag(1)
    before = kernels.launch_counts()["budget_exact"]
    assert gpu.knn_in_ivpq("w3", 5, targets)[0][0] == "w3"
    assert kernels.launch_counts()["budget_exact"] > before


def _same_rows(got, want, hit_floor=0.99, atol=1e-4):
    """Batch/join rows of the card and the CPU: the same words (up to the
    card's other summation order) and similarities within ``atol``."""
    assert len(got) == len(want)
    sims = {(q, w): s for q, w, s in want}
    hits = [(q, w) in sims for q, w, _ in got]
    assert sum(hits) / len(got) >= hit_floor
    for (q, w, s), hit in zip(got, hits):
        if hit:
            assert abs(s - sims[(q, w)]) <= atol


# ------------------------------------------------------ int8 LUTs (K3/K5/K8)

I8_BOOKS = ((12, 256, torch.uint8), (60, 16, torch.uint8),
            (12, 1024, torch.int16), (12, 16, torch.uint8),
            (30, 32, torch.uint8), (15, 1024, torch.int16))


def _i8_inputs(seed, B, m, k, n, dtype):
    luts, codes_t = _adc_inputs(seed, B, m, k, n, dtype)
    return (*kernels.quantize_luts_int8(luts), codes_t)


# K3 stages 64 queries a block at 12x256, 32 at 30x32 and 60x16
@pytest.mark.parametrize("n", N_EDGES)
@pytest.mark.parametrize("B", (1, 33, 63, 64, 65, 257))
@pytest.mark.parametrize("m,k,dtype", I8_BOOKS)
def test_adc_scan_int8_matches_plain(n, B, m, k, dtype):
    ql, sc, codes_t = _i8_inputs(3 * n + B + m, B, m, k, n, dtype)
    before = kernels.KERNELS["adc_scan_int8"].launches
    got = kernels.adc_scan_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    assert kernels.KERNELS["adc_scan_int8"].launches == before + 1
    assert torch.equal(got, kernels.adc_scan_plain(ql, codes_t, scale=sc))


@pytest.mark.parametrize("m", (12, 258, 259, 300))
def test_adc_scan_int8_packed_lanes_stay_exact(m):
    """K3 sums two biased bytes per 32-bit word while m·254 < 65536 (m ≤
    258) and one int32 per query past that. Query 0's LUT is all +127 and
    query 1's all −127 (the lanes' two extremes), the rest signed."""
    B, k, n = 70, 16, 2053
    g = torch.Generator(device="cuda").manual_seed(m)
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 8.0 - 4.0
    luts[0], luts[1] = 4.0, -4.0
    ql, sc = kernels.quantize_luts_int8(luts)
    assert int(ql[0].min()) == 127 and int(ql[1].max()) == -127
    codes_t = torch.randint(0, k, (m, n), generator=g,
                            device="cuda").to(torch.uint8)
    got = kernels.adc_scan_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.adc_scan_plain(ql, codes_t, scale=sc))


@pytest.mark.parametrize("qb", (64, 32, 16, 8, 4))
def test_adc_scan_int8_every_query_block_matches_plain(qb):
    """K3 at each queries-per-block through the sweep entry point (the
    wrapper chooses 64 at 12x256)."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k, n = 133, 12, 256, 3001
    ql, sc, codes_t = _i8_inputs(qb, B, m, k, n, torch.uint8)
    out = torch.full((B, n), float("nan"), device="cuda")
    err = _build.load().pw2v_adc_scan_int8_qb(
        ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(), 1, out.data_ptr(),
        B, m, k, n, qb, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, kernels.adc_scan_plain(ql, codes_t, scale=sc))


# K5 stages 64 queries a block at 12x256, as K3
@pytest.mark.parametrize("n", N_EDGES)
@pytest.mark.parametrize("B", (1, 33, 63, 64, 65, 257))
@pytest.mark.parametrize("m,k,dtype", I8_BOOKS)
def test_adc_scan_binned_int8_matches_plain(n, B, m, k, dtype):
    ql, sc, codes_t = _i8_inputs(4 * n + B + m, B, m, k, n, dtype)
    before = kernels.KERNELS["adc_scan_binned_int8"].launches
    mins, ids = kernels.adc_scan_binned_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    assert kernels.KERNELS["adc_scan_binned_int8"].launches == before + 1
    ref_mins, ref_ids = kernels.adc_scan_binned_plain(ql, codes_t, scale=sc)
    assert torch.equal(mins, ref_mins) and torch.equal(ids, ref_ids)
    dense = kernels.adc_scan_plain(ql, codes_t, scale=sc)
    kernels.verify_binned(mins, ids, ref_mins,
                          lambda i: torch.gather(dense, 1, i), block_n=2048,
                          bins=128, valid_n=n, atol=0.0)


def _binned_int8_equal(ql, sc, codes_t, mins, ids):
    """K5's output equals the plain version's (mins, ids, +inf / −1 slots)
    and meets the binned contract against the dense int8 scores."""
    n = codes_t.shape[1]
    ref_mins, ref_ids = kernels.adc_scan_binned_plain(ql, codes_t, scale=sc)
    assert torch.equal(mins, ref_mins) and torch.equal(ids, ref_ids)
    dense = kernels.adc_scan_plain(ql, codes_t, scale=sc)
    kernels.verify_binned(mins, ids, ref_mins,
                          lambda i: torch.gather(dense, 1, i), block_n=2048,
                          bins=128, valid_n=n, atol=0.0)


@pytest.mark.parametrize("m", (12, 258, 259, 300))
def test_adc_scan_binned_int8_packed_lanes_stay_exact(m):
    """K5 keeps K3's lanes: two biased bytes per 32-bit word while m ≤ 258,
    one int32 per query past that, and its bin min over them. Query 0's LUT
    is all +127 and query 1's all −127 (the lanes' two extremes)."""
    B, k, n = 70, 16, 2053
    g = torch.Generator(device="cuda").manual_seed(m + 1)
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 8.0 - 4.0
    luts[0], luts[1] = 4.0, -4.0
    ql, sc = kernels.quantize_luts_int8(luts)
    codes_t = torch.randint(0, k, (m, n), generator=g,
                            device="cuda").to(torch.uint8)
    mins, ids = kernels.adc_scan_binned_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    _binned_int8_equal(ql, sc, codes_t, mins, ids)


@pytest.mark.parametrize("m,k,dtype", ((12, 256, torch.uint8),
                                       (12, 1024, torch.int16)))
def test_adc_scan_binned_int8_takes_unaligned_codes(m, k, dtype):
    """K5 copies the codes without cp.async when a subspace's run is not
    16-byte aligned (the table starts one element into its buffer)."""
    n, B = 4096 + 5, 33
    codes_t = _misaligned_codes(n + m + 1, m, k, n, dtype)
    luts = torch.rand(B, m, k, generator=torch.Generator(
        device="cuda").manual_seed(m + 1), device="cuda") * 4.0
    ql, sc = kernels.quantize_luts_int8(luts)
    mins, ids = kernels.adc_scan_binned_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    _binned_int8_equal(ql, sc, codes_t, mins, ids)


def test_adc_scan_binned_int8_takes_the_lowest_id_on_ties():
    """Code 0 is the smallest entry of every subspace for every query and
    the only rows with all-zero codes are 3 + 5·128, 3 + 9·128 and
    3 + 12·128, so bin 3 of tile 0 holds a three-way tie at its minimum:
    its id is the lowest, 643. N = 2053 leaves bins 5..127 of tile 1
    without a row: +inf with id −1."""
    B, m, k, n = 70, 12, 256, 2053
    g = torch.Generator(device="cuda").manual_seed(3)
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 3.0 + 1.0
    luts[:, :, 0] = 0.0
    ql, sc = kernels.quantize_luts_int8(luts)
    codes_t = torch.randint(1, k, (m, n), generator=g,
                            device="cuda").to(torch.uint8)
    codes_t[:, [3 + 5 * 128, 3 + 9 * 128, 3 + 12 * 128]] = 0
    mins, ids = kernels.adc_scan_binned_int8(ql, sc, codes_t)
    torch.cuda.synchronize()
    assert bool((ids[:, 3] == 3 + 5 * 128).all())
    assert bool((mins[:, 3] == 0.0).all())
    assert bool((ids[:, 128 + 5:] == -1).all())
    assert bool(torch.isinf(mins[:, 128 + 5:]).all())
    _binned_int8_equal(ql, sc, codes_t, mins, ids)


@pytest.mark.parametrize("qb", (64, 32, 16, 8, 4))
def test_adc_scan_binned_int8_every_query_block_matches_plain(qb):
    """K5 at each queries-per-block through the sweep entry point (the
    wrapper chooses 64 at 12x256)."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k, n = 133, 12, 256, 3001
    ql, sc, codes_t = _i8_inputs(qb + 1, B, m, k, n, torch.uint8)
    width = -(-n // 2048) * 128
    mins = torch.full((B, width), float("nan"), device="cuda")
    ids = torch.full((B, width), -7, dtype=torch.int32, device="cuda")
    err = _build.load().pw2v_adc_scan_binned_int8_qb(
        ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(), 1, mins.data_ptr(),
        ids.data_ptr(), B, m, k, n, 2048, 128, qb,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _binned_int8_equal(ql, sc, codes_t, mins, ids)


def test_adc_scan_binned_int8_takes_only_128_bins_on_the_card():
    ql, sc, codes_t = _i8_inputs(5, 3, 12, 256, 4096, torch.uint8)
    with pytest.raises(ValueError, match="bins=128"):
        kernels.adc_scan_binned_int8(ql, sc, codes_t, block_n=2048, bins=64)
    with pytest.raises(ValueError, match="bins=128"):
        kernels.adc_scan_binned(ql.float(), codes_t, block_n=2048, bins=256,
                                lut_dtype="int8")


@pytest.mark.parametrize("block_t", BLOCKS)
@pytest.mark.parametrize("B", B_EDGES)
@pytest.mark.parametrize("m,k,dtype", BUDGET_BOOKS + ((12, 16, torch.uint8),))
@pytest.mark.parametrize("rows", (8, 32))
def test_budget_adc_grouped_int8_matches_plain(block_t, B, m, k, dtype, rows):
    luts, codes_t, rowterm, tiles = _budget_case(3 * block_t + B + m, B, m,
                                                 k, dtype, block_t)
    ql, sc = kernels.quantize_luts_int8(luts)
    before = kernels.KERNELS["budget_adc_grouped_int8"].launches
    got = kernels.budget_adc_grouped_int8(ql, sc, codes_t, rowterm, tiles,
                                          block_t=block_t, rows=rows)
    assert kernels.KERNELS["budget_adc_grouped_int8"].launches == before + 1
    _assert_budget_close(got, kernels.budget_adc_plain(
        ql, codes_t, rowterm, tiles, block_t=block_t, scale=sc), 0.0)


# K8's staged widths, lanes and routes

GROUP_SIZES = (1, 7, 8, 9, 16, 17, 32)


def _sized_groups_case(seed, m, k, dtype, block_t, sizes=GROUP_SIZES):
    """One slot per query; tile t is probed by sizes[t] queries, so with
    rows = 32 group t holds exactly that many real slots."""
    B = sum(sizes)
    luts, codes_t, rowterm, _ = _budget_case(seed, B, m, k, dtype, block_t,
                                             nt=len(sizes), P=1)
    tiles = torch.repeat_interleave(
        torch.arange(len(sizes), device="cuda"),
        torch.tensor(sizes, device="cuda")).to(torch.int32)[:, None]
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(seed))
    return luts, codes_t, rowterm, tiles[perm.cuda()].contiguous()


def _k8_at_width(ql, sc, codes_t, rowterm, tiles, block_t, rows, wmax):
    """K8 through the entry point that takes the staged width → (CUDA
    error code, result)."""
    from postgres_word2vec_tpu_torch.ops import _build

    B, m, k = ql.shape
    na = codes_t.shape[1]
    qidx, tog, row = kernels._grouped_layout(tiles, na // block_t, rows)
    out = torch.full((tog.shape[0] * rows, block_t), float("nan"),
                     device="cuda")
    err = _build.load().pw2v_budget_adc_grouped_int8_w(
        ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(),
        codes_t.element_size(), rowterm.data_ptr(), qidx.data_ptr(),
        tog.data_ptr(), out.data_ptr(), B, m, k, na, tog.shape[0], rows,
        block_t, wmax, torch.cuda.current_stream().cuda_stream)
    return err, kernels._reassemble(out, row, tiles)


@pytest.mark.parametrize("wmax", (0, 4, 8, 16, 32))
@pytest.mark.parametrize("m,k,dtype", ((30, 32, torch.uint8),
                                       (12, 1024, torch.int16)))
def test_budget_adc_grouped_int8_every_group_size_and_width(wmax, m, k,
                                                            dtype):
    """Groups of 1, 7, 8, 9, 16, 17 and 32 real queries at every staged
    width: each group takes the least width that holds it (or several
    passes of ``wmax`` slots); a width whose LUTs do not fit beside the
    tile is refused."""
    luts, codes_t, rowterm, tiles = _sized_groups_case(wmax + m, m, k, dtype,
                                                       256)
    ql, sc = kernels.quantize_luts_int8(luts)
    err, got = _k8_at_width(ql, sc, codes_t, rowterm, tiles, 256, 32, wmax)
    if wmax * m * k + m * 256 * codes_t.element_size() > 226 * 1024:
        assert err != 0    # 32 LUTs of 12x1024: over a block's shared memory
        return
    assert err == 0
    _assert_budget_close(got, kernels.budget_adc_plain(
        ql, codes_t, rowterm, tiles, block_t=256, scale=sc), 0.0)


def test_budget_adc_grouped_int8_leaves_unused_slots_unwritten():
    from postgres_word2vec_tpu_torch.ops import _build

    luts, codes_t, rowterm, tiles = _sized_groups_case(5, 30, 32, torch.uint8,
                                                       256)
    ql, sc = kernels.quantize_luts_int8(luts)
    qidx, tog, _ = kernels._grouped_layout(tiles, codes_t.shape[1] // 256, 32)
    out = torch.full((tog.shape[0] * 32, 256), float("nan"), device="cuda")
    err = _build.load().pw2v_budget_adc_grouped_int8(
        ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(), 1,
        rowterm.data_ptr(), qidx.data_ptr(), tog.data_ptr(), out.data_ptr(),
        ql.shape[0], 30, 32, codes_t.shape[1], tog.shape[0], 32, 256,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    real = (qidx.reshape(-1) < ql.shape[0])
    assert int(real.sum()) == sum(GROUP_SIZES)
    assert not torch.isnan(out[real]).any()
    assert torch.isnan(out[~real]).all()


@pytest.mark.parametrize("m", (12, 258, 259, 300))
@pytest.mark.parametrize("rows", (8, 32, 40))
def test_budget_adc_grouped_int8_packed_lanes_stay_exact(m, rows):
    """K8 sums two biased bytes per 32-bit word while m ≤ 258 and one int32
    per query past that. Query 0's LUT is all +127 and query 1's all −127
    (the lanes' two extremes), the rest signed. rows = 40 takes two loads
    of slot ids per group and a second pass of 8 slots."""
    B, k, block_t = 70, 16, 128
    _, codes_t, rowterm, tiles = _budget_case(m + rows, B, m, k, torch.uint8,
                                              block_t)
    g = torch.Generator(device="cuda").manual_seed(m)
    luts = torch.rand(B, m, k, generator=g, device="cuda") * 8.0 - 4.0
    luts[0], luts[1] = 4.0, -4.0
    ql, sc = kernels.quantize_luts_int8(luts)
    assert int(ql[0].min()) == 127 and int(ql[1].max()) == -127
    got = kernels.budget_adc_grouped_int8(ql, sc, codes_t, rowterm, tiles,
                                          block_t=block_t, rows=rows)
    _assert_budget_close(got, kernels.budget_adc_plain(
        ql, codes_t, rowterm, tiles, block_t=block_t, scale=sc), 0.0)


@pytest.mark.parametrize("route", ("aligned", "block_t", "codes", "luts"))
@pytest.mark.parametrize("m,k,dtype", ((3, 12, torch.uint8),
                                       (5, 6, torch.uint8),
                                       (7, 9, torch.uint8),
                                       (12, 256, torch.uint8),
                                       (15, 1024, torch.int16)))
def test_budget_adc_grouped_int8_takes_unaligned_inputs(route, m, k, dtype):
    """K8's routes without wide loads: LUTs whose m·k is not a multiple of
    16 (36: 32-bit words) or of 4 (30, 63: bytes), a LUT tensor one byte
    into its buffer (bytes), and code tiles copied without cp.async
    (block_t = 100; a table one element into its buffer)."""
    block_t = 100 if route == "block_t" else 128
    luts, codes_t, rowterm, tiles = _budget_case(m + k + block_t, 45, m, k,
                                                 dtype, block_t)
    ql, sc = kernels.quantize_luts_int8(luts)
    if route == "codes":
        buf = torch.zeros(codes_t.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = codes_t.reshape(-1)
        codes_t = buf[1:].view(m, -1)
        assert codes_t.data_ptr() % 16 != 0
    if route == "luts":
        buf = torch.zeros(ql.numel() + 1, dtype=torch.int8, device="cuda")
        buf[1:] = ql.reshape(-1)
        ql = buf[1:].view(ql.shape)
        assert ql.data_ptr() % 4 != 0 and ql.is_contiguous()
    got = kernels.budget_adc_grouped_int8(ql, sc, codes_t, rowterm, tiles,
                                          block_t=block_t, rows=32)
    _assert_budget_close(got, kernels.budget_adc_plain(
        ql, codes_t, rowterm, tiles, block_t=block_t, scale=sc), 0.0)


def test_int8_kernels_read_a_bad_tile_as_the_inf_tile():
    luts, codes_t, rowterm, tiles = _budget_case(17, 3, 12, 256, torch.uint8,
                                                 128)
    tiles[0, 0], tiles[1, 1] = -1, 10 ** 6
    out = kernels.budget_adc_grouped(luts, codes_t, rowterm, tiles,
                                     block_t=128, lut_dtype="int8")
    torch.cuda.synchronize()
    assert torch.isinf(out[0, :128]).all()
    assert torch.isinf(out[1, 128:256]).all()


def test_exact_int8_on_cuda_matches_cpu():
    """torch._int_mm on the card (rows and width padded to its multiples
    of 8) gives the CPU's exact int32 products: the same scores."""
    from postgres_word2vec_tpu_torch.models.exact import ExactIndex

    rng = np.random.default_rng(5)
    v = rng.normal(size=(5003, 300)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[:7]
    cpu = ExactIndex(torch.as_tensor(v), "int8")
    gpu = ExactIndex(torch.as_tensor(v, device="cuda"), "int8")
    d_c, i_c = cpu.search(torch.as_tensor(q), 10)
    d_g, i_g = gpu.search(torch.as_tensor(q, device="cuda"), 10)
    torch.testing.assert_close(d_g.cpu(), d_c, atol=1e-5, rtol=0)
    assert (i_g.cpu()[:, 0] == torch.arange(7)).all()
    grown = gpu.extended(gpu.vectors, torch.as_tensor(q, device="cuda"))
    d_e, i_e = grown.search(torch.as_tensor(q, device="cuda"), 2)
    assert set(i_e[:, :2].flatten().tolist()) >= set(range(5003, 5010))


# ------------------------------------------------ slice 9: K2's new sites

@pytest.mark.parametrize("T", (1, 2, 3, 17, 255, 1000, 4097))
@pytest.mark.parametrize("m,k,dtype", DENSE_BOOKS)
def test_adc_scan_on_gathered_target_columns_matches_plain(T, m, k, dtype):
    """``PQIndex.search_in``'s table: a target set's columns gathered from
    the (m, N) layout, T not a multiple of any block."""
    luts, codes_t = _adc_inputs(T + m, 5, m, k, 9000, dtype)
    g = torch.Generator(device="cuda").manual_seed(T)
    tids = torch.randint(0, 9000, (T,), generator=g, device="cuda")
    table = codes_t.index_select(1, tids)
    assert table.is_contiguous() and table.shape == (m, T)
    before = kernels.KERNELS["adc_scan"].launches
    got = kernels.adc_scan(luts, table)
    torch.cuda.synchronize()
    assert kernels.KERNELS["adc_scan"].launches == before + 1
    assert torch.equal(got, kernels.adc_scan_plain(luts, table))


@pytest.fixture(scope="module")
def engine_dirs(tmp_path_factory):
    """A small port engine (OPQ PQ, IVFADC, IVPQ) built on the CPU and
    saved; the tests load it on the card and on the CPU."""
    from postgres_word2vec_tpu_torch import Freddy, VectorStore

    g = torch.Generator().manual_seed(9)
    c = torch.randn(48, 48, generator=g)
    x = c[torch.randint(0, 48, (6000,), generator=g)] + 0.6 * torch.randn(
        6000, 48, generator=g)
    store = VectorStore.from_arrays([f"w{i}" for i in range(6000)], x,
                                    device="cpu")
    eng = Freddy.build(store, pq_m=12, pq_k=16, ivfadc_m=12, ivfadc_k=16,
                       k_coarse=24, ivpq_m=12, ivpq_k=16, ivpq_k_coarse=8,
                       train_size=None, iters=4, opq_iters=2)
    path = tmp_path_factory.mktemp("engine")
    eng.save(path)
    return path


def _engines(path):
    from postgres_word2vec_tpu_torch import Freddy
    return Freddy.load(path, device="cuda"), Freddy.load(path, device="cpu")


@pytest.mark.parametrize("k", (1, 5, 300))
def test_pq_search_in_on_the_card_matches_the_cpu(engine_dirs, k):
    from test_torch_parity_util import assert_same_top_k

    gpu, cpu = _engines(engine_dirs)
    tids = torch.randperm(6000, generator=torch.Generator().manual_seed(k))
    tids = tids[:257]
    mask = torch.ones(257, dtype=torch.bool)
    mask[5] = False
    q = cpu.store.vectors_norm[10:30]
    kernels.reset_launch_counts()
    got = gpu.pq.search_in(q.cuda(), k, tids.cuda(), mask.cuda())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["adc_scan"] == 1
    want = cpu.pq.search_in(q, k, tids, mask)
    assert_same_top_k(got[0], got[1], want[0], want[1], atol=1e-5)
    assert not (got[1] == tids[5].cuda()).any()


def test_knn_in_pq_batch_on_the_card_launches_k2_per_chunk(engine_dirs):
    gpu, cpu = _engines(engine_dirs)
    words = [f"w{i}" for i in range(0, 6000, 5)]        # 1200: 3 chunks
    targets = [f"w{i}" for i in range(0, 6000, 3)]
    kernels.reset_launch_counts()
    got = gpu.knn_in_pq_batch(words, 3, targets)
    assert kernels.launch_counts()["adc_scan"] == 3
    want = cpu.knn_in_pq_batch(words, 3, targets)
    agree = np.mean([a[1] == b[1] for a, b in zip(got, want)])
    assert len(got) == len(want) and agree >= 0.99


def test_grouping_func_pq_on_the_card_matches_the_cpu(engine_dirs):
    gpu, cpu = _engines(engine_dirs)
    toks = [f"w{i}" for i in range(0, 6000, 2)]
    groups = [f"w{i}" for i in range(1, 6000, 300)]
    kernels.reset_launch_counts()
    got = gpu.grouping_func_pq(toks, groups)
    assert kernels.launch_counts()["adc_scan"] == 1
    want = cpu.grouping_func_pq(toks, groups)
    assert [t for t, _ in got] == [t for t, _ in want] == toks
    assert np.mean([a == b for a, b in zip(got, want)]) >= 0.99


@pytest.mark.parametrize("method", (0, 1, 2))
def test_pregathered_join_on_the_card_matches_the_cpu(engine_dirs, method):
    from test_torch_parity_util import assert_same_top_k

    gpu, cpu = _engines(engine_dirs)
    tids = torch.randperm(6000, generator=torch.Generator().manual_seed(1))
    tids = tids[:2500]
    out = []
    for eng in (gpu, cpu):
        x = eng.store.vectors_norm
        t = tids.to(x.device)
        ph = eng.ivpq.prepare_join(t, vectors=x[t], vecs_pregathered=True)
        out.append(eng.ivpq.search_join(x[:40], 5, prepared=ph, alpha=20,
                                        method=method, pvf=4,
                                        impl="budget"))
    assert_same_top_k(out[0][0], out[0][1], out[1][0], out[1][1], atol=1e-4)


# ------------------------------------- serving, builders, aniso on the card

@pytest.mark.parametrize("family,kernel", (
    ("k_nearest_neighbour_pq", ("adc_scan",)),
    ("k_nearest_neighbour_pq_pv", ("adc_scan_binned",)),
    # the probe's shape picks the per-query or the grouped kernel
    ("k_nearest_neighbour_ivfadc_pv", ("budget_adc",
                                       "budget_adc_grouped"))))
@pytest.mark.parametrize("front", ("async", "threaded"))
def test_served_knn_on_the_card_matches_the_engine(engine_dirs, family,
                                                   kernel, front):
    """Concurrent /knn requests coalesce into pinned-copy batches on the
    card (the event-waiting completion path) and answer as the card
    engine's direct calls do (its PQ + post-verify shortlist is the binned
    scan's bin survivors, so the CPU engine, with the exact shortlist, is
    not the reference)."""
    import threading

    from postgres_word2vec_tpu_torch.server import QueryServer
    from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer
    from test_torch_parity_util import assert_same_rows, http_call

    gpu, _ = _engines(engine_dirs)
    gpu.set_knn_function(family)
    cls = AsyncQueryServer if front == "async" else QueryServer
    srv = cls(gpu, port=0, batch_window_ms=20.0).start()
    try:
        srv.warmup(k=5)
        kernels.reset_launch_counts()
        res = [None] * 12

        def one(j):
            res[j] = http_call(srv.port, "/knn",
                               {"query": f"w{7 * j}", "k": 5})

        threads = [threading.Thread(target=one, args=(j,))
                   for j in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        launched = kernels.launch_counts()
        for j, (code, r) in enumerate(res):
            assert code == 200, r
        assert any(launched[name] for name in kernel), launched
        for j, (code, r) in enumerate(res):
            want = [list(x) for x in gpu.knn(f"w{7 * j}", 5)]
            assert_same_rows(r["result"], want, 1e-4, f"w{7 * j}")
    finally:
        srv.stop()


def test_served_knn_in_on_the_card_matches_the_cpu(engine_dirs):
    from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer
    from test_torch_parity_util import assert_same_rows, http_call

    gpu, cpu = _engines(engine_dirs)
    targets = list(range(0, 6000, 4))
    for e in (gpu, cpu):
        e.set_knn_in_function("knn_in_pq")
    srv = AsyncQueryServer(gpu, port=0).start()
    try:
        kernels.reset_launch_counts()
        code, r = http_call(srv.port, "/knn_in",
                            {"query": "w3", "k": 5, "targets": targets})
        assert code == 200 and kernels.launch_counts()["adc_scan"] == 1
        want = [list(x) for x in cpu.knn_in("w3", 5, targets)]
        assert_same_rows(r["result"], want, 1e-4, "knn_in")
    finally:
        srv.stop()


def test_streaming_builders_on_the_card_match_the_cpu(engine_dirs):
    from postgres_word2vec_tpu_torch.models import builders
    from postgres_word2vec_tpu_torch.models.pq import PQCodebook

    gpu, cpu = _engines(engine_dirs)
    x = cpu.store.vectors_norm
    out = []
    for dev in ("cuda", "cpu"):
        pq = builders.PQIndexCreator(PQCodebook(
            *(t.to(dev) for t in cpu.pq.codebook)))
        ivf = builders.IVFADCIndexCreator(
            cpu.ivfadc.coarse.centroids.to(dev),
            PQCodebook(*(t.to(dev) for t in cpu.ivfadc.codebook)))
        for batch, _ in builders.VectorFeeder(x.to(dev), batch_size=1024):
            pq.index_batch(batch)
            ivf.index_batch(batch)
        out.append((pq.finalize().codes.cpu(), ivf.finalize().row_ids.cpu()))
    assert (out[0][0] == out[1][0]).float().mean() >= 0.999
    assert (out[0][1] == out[1][1]).float().mean() >= 0.999


def test_anisotropic_refine_on_the_card_matches_the_cpu():
    from postgres_word2vec_tpu_torch.ops import kmeans

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5000, 25, generator=g)
    c0 = x[:, :64].clone()
    got = kmeans.anisotropic_refine(x.cuda(), c0.cuda(), 4.0, iters=4)
    want = kmeans.anisotropic_refine(x, c0, 4.0, iters=4)
    # a point that ties between two centroids may fall either way
    close = (got.cpu() - want).abs().amax(-1) <= 1e-3
    assert close.float().mean() >= 0.95


# ------------------------------- row sharding: R shards on the one card

def _meshes():
    from postgres_word2vec_tpu_torch.parallel.sharding import make_mesh
    return (make_mesh([torch.device("cuda:0")] * 4, rows=4),
            make_mesh(["cpu"] * 4, rows=4))


@pytest.mark.parametrize("lut_dtype,kernel", (("bf16", "adc_scan"),
                                              ("int8", "adc_scan_int8")))
def test_sharded_pq_on_the_card_launches_its_scan_per_shard(engine_dirs,
                                                            lut_dtype,
                                                            kernel):
    """A sharded PQ call launches K2 (K3 for int8 LUTs) once per shard,
    each over its (m, S) codes and equal to the plain version there; the
    float path returns the CPU mesh engine's results."""
    from postgres_word2vec_tpu_torch import Freddy
    from test_torch_parity_util import assert_same_top_k

    gmesh, cmesh = _meshes()
    gpu = Freddy.load(engine_dirs, device="cuda", mesh=gmesh)
    cpu = Freddy.load(engine_dirs, device="cpu", mesh=cmesh)
    gpu.set_pq_lut_dtype(lut_dtype)
    q = gpu.store.vectors_norm[:257]
    kernels.reset_launch_counts()
    got = gpu._pq_knn_core(q, 10)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kernel] == 4
    codes_t = gpu._shard["pq_codes"].local(2)
    assert codes_t.shape == (12, 1500) and codes_t.is_contiguous()
    luts = gpu._mesh_luts(gpu.pq, q)
    if lut_dtype == "int8":
        ql, sc = kernels.quantize_luts_int8(luts)
        assert torch.equal(kernels.adc_scan_int8(ql, sc, codes_t),
                           kernels.adc_scan_plain(ql, codes_t, scale=sc))
    else:
        assert torch.equal(kernels.adc_scan(luts, codes_t),
                           kernels.adc_scan_plain(luts, codes_t))
        want = cpu._pq_knn_core(q.cpu(), 10)
        assert_same_top_k(got[0], got[1], want[0], want[1], atol=1e-5)


@pytest.mark.parametrize("B,method", ((64, 0), (1024, 0), (64, 1),
                                      (1024, 1)))
def test_sharded_budget_join_kernels_match_plain_at_block_t_128(engine_dirs,
                                                                B, method):
    """The budget join's kernels on one shard's tiles at ``block_t = 128``
    (``shard_join_tiles``), planned with the whole set's counts: K6 or K7
    equal to the plain version, K9 or K10 within 1e-4; the sharded join on
    the card returns the CPU mesh's up to ties."""
    from postgres_word2vec_tpu_torch import Freddy
    from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
    from postgres_word2vec_tpu_torch.models.ivfadc import plan_probe_tiles
    from postgres_word2vec_tpu_torch.ops import lut
    from postgres_word2vec_tpu_torch.parallel import sharding
    from test_torch_parity_util import assert_same_top_k

    gmesh, cmesh = _meshes()
    out = []
    for eng, mesh in ((Freddy.load(engine_dirs, device="cuda"), gmesh),
                      (Freddy.load(engine_dirs, device="cpu"), cmesh)):
        x = eng.store.vectors_norm
        tids = torch.arange(0, 6000, 2, device=x.device)
        q = x[1:2 * B:2]
        kernels.reset_launch_counts()
        out.append(sharding.sharded_ivpq_join(
            mesh, eng.ivpq, q, 5, tids, vectors=x, alpha=20, pvf=4,
            method=method, impl="budget"))
        counts = kernels.launch_counts()
        if x.is_cuda:
            names = (("budget_adc", "budget_adc_grouped") if method == 0
                     else ("budget_exact", "budget_exact_grouped"))
            assert sum(counts[n] for n in names) >= 4, counts
            ivpq, q_g = eng.ivpq, q
            bundle = sharding.shard_join_tiles(
                ivpq, tids, torch.ones_like(tids, dtype=torch.bool),
                x[tids] if method == 1 else None, gmesh,
                with_vecs=method == 1)
    assert_same_top_k(out[0][0], out[0][1], out[1][0], out[1][1],
                      atol=1e-2 if method == 1 else 1e-5)
    jt = bundle["jt"][1][torch.device("cuda", 0)]
    assert jt.block_t == 128
    stats = ivpq_mod.uniform_statistics(ivpq.coarse.cell_counts)
    start, cnt, *_ = ivpq_mod.select_tiles(
        q_g, ivpq.coarse.centroids, stats, jt, 5, 20, 0.8,
        bundle["t_real"], bundle["cell_counts"])
    tiles, _ = plan_probe_tiles(16, start, cnt, jt.inf_tile)
    if method == 0:
        luts = lut.build_luts(q_g, ivpq.codebook.centroids)
        want = kernels.budget_adc_plain(luts, jt.codes_t, jt.rowterm, tiles,
                                        block_t=128)
        for got in (kernels.budget_adc(luts, jt.codes_t, jt.rowterm, tiles,
                                       block_t=128),
                    kernels.budget_adc_grouped(luts, jt.codes_t, jt.rowterm,
                                               tiles, block_t=128, rows=32)):
            _assert_budget_close(got, want, 0.0)
    else:
        want = kernels.budget_exact_plain(q_g, jt.vecs, jt.rownorm, tiles,
                                          block_t=128)
        for got in (kernels.budget_exact(q_g, jt.vecs, jt.rownorm, tiles,
                                         block_t=128),
                    kernels.budget_exact_grouped(q_g, jt.vecs, jt.rownorm,
                                                 tiles, block_t=128,
                                                 rows=32)):
            _assert_budget_close(got, want, 1e-4)


def test_sharded_engine_on_the_card_matches_the_cpu_mesh(engine_dirs):
    """Every routed family of an engine loaded on the card with a mesh of
    four shards of ``cuda:0`` against the same engine on a CPU mesh."""
    from postgres_word2vec_tpu_torch import Freddy
    from test_torch_parity_util import assert_same_top_k

    gmesh, cmesh = _meshes()
    gpu = Freddy.load(engine_dirs, device="cuda", mesh=gmesh)
    cpu = Freddy.load(engine_dirs, device="cpu", mesh=cmesh)
    q = cpu.store.vectors_norm[:40]
    tids = torch.arange(1, 6000, 3)
    mask = torch.ones(tids.shape, dtype=torch.bool)
    for core, args, atol in (
            ("_exact_knn_core", (), 1e-5), ("_pq_pv_knn_core", (), 1e-5),
            ("_ivfadc_knn_core", (), 1e-4), ("_ivfadc_pv_knn_core", (), 1e-5),
            ("_exact_in_core", (tids, mask), 1e-5),
            ("_pq_in_core", (tids, mask), 1e-5)):
        got = getattr(gpu, core)(q.cuda(), 7, *(a.cuda() for a in args))
        want = getattr(cpu, core)(q, 7, *args)
        assert_same_top_k(got[0], got[1], want[0], want[1], atol=atol)
    gpu.set_alpha(20)
    cpu.set_alpha(20)
    words = [f"w{i}" for i in range(40)]
    targets = [f"w{i}" for i in range(0, 6000, 4)]
    got = gpu.knn_in_ivpq_batch(words, 5, targets)
    want = cpu.knn_in_ivpq_batch(words, 5, targets)
    assert [(a, w) for a, w, _ in got] == [(a, w) for a, w, _ in want]


# -------------------------------------------- the kernel sweeps, graft entry

@pytest.mark.parametrize("block_n,qb", [(2048, 16), (2048, 4), (4096, 8),
                                        (8192, 4)])
def test_probe_sweep_point_equals_plain(block_n, qb):
    """The ADC probe's ``--sweep`` launch (K4 at forced queries per block)
    equals the plain binned scan, mins and ids, and counts as one K4."""
    from postgres_word2vec_tpu_torch.cli.evaluation import adc_kernel_probe

    g = torch.Generator("cuda").manual_seed(5)
    luts = torch.rand(37, 12, 256, generator=g, device="cuda")
    codes_t = torch.randint(0, 256, (12, 3 * 8192), generator=g,
                            device="cuda", dtype=torch.uint8)
    kernels.reset_launch_counts()
    mins, ids = adc_kernel_probe.binned_at(luts, codes_t, block_n=block_n,
                                           bins=128, qb=qb)
    assert kernels.launch_counts()["adc_scan_binned"] == 1
    want = kernels.adc_scan_binned_plain(luts, codes_t, block_n=block_n)
    assert torch.equal(mins, want[0]) and torch.equal(ids, want[1])


def test_probe_sweep_refuses_bins_256_before_a_launch():
    from postgres_word2vec_tpu_torch.cli.evaluation import adc_kernel_probe

    luts = torch.rand(4, 12, 256, device="cuda")
    codes_t = torch.zeros(12, 8192, dtype=torch.uint8, device="cuda")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="bins=128"):
        adc_kernel_probe.binned_at(luts, codes_t, block_n=4096, bins=256,
                                   qb=16)
    assert kernels.launch_counts()["adc_scan_binned"] == 0


def test_budget_sweep_reads_the_launch_grids():
    """``launch_blocks``: K7 runs a block per group, ⌈B·P/rows⌉ + the
    table's tiles; K6 at least one block per query."""
    from postgres_word2vec_tpu_torch.cli.evaluation import (
        budget_kernel_sweep as bks)

    luts, codes, rowterm, tiles = (torch.from_numpy(a).cuda() for a in
                                   bks.draws(64, 8, 128, 20, 30, 32, 1.1))
    grouped = bks.launch_blocks(lambda: kernels.budget_adc_grouped(
        luts, codes, rowterm, tiles, block_t=128, rows=16),
        "budget_adc_grouped_kernel")
    assert grouped == -(-64 * 8 // 16) + 21
    per_query = bks.launch_blocks(lambda: kernels.budget_adc(
        luts, codes, rowterm, tiles, block_t=128), "budget_adc_kernel")
    assert 64 <= per_query <= 64 * 8


def test_graft_forward_on_the_card_launches_k2_once():
    from postgres_word2vec_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    kernels.reset_launch_counts()
    vals, ids, retrieved = fn(*args)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "adc_scan": 1}
    assert vals.is_cuda and vals.shape == (16, 5) and retrieved.shape == (16,)


def test_bench_section_that_raises_exits_non_zero_on_the_card(tmp_path):
    """``cli.bench`` on the card (no ``--device``) with its PQ section
    raising: the exact rows run (K1 launched), then the process exits
    non-zero and writes no record and no line."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from postgres_word2vec_tpu_torch.cli import bench\n"
        "from postgres_word2vec_tpu_torch.ops import kernels\n"
        "def boom(*a, **kw):\n"
        "    print('K1', kernels.launch_counts()['fused_exact_scan'],\n"
        "          file=sys.stderr)\n"
        "    raise RuntimeError('pq256 failed')\n"
        "bench.N_SMALL, bench.D = 16384, 60\n"
        "bench.pq256_section = boom\n"
        "bench.main(sys.argv[1:])\n")
    out = tmp_path / "bench.json"
    proc = subprocess.run(
        [sys.executable, "-c", code, "--small", "--out", str(out)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=600)
    assert proc.returncode != 0
    assert "pq256 failed" in proc.stderr
    assert "K1 17" in proc.stderr
    assert proc.stdout == "" and not out.exists()
