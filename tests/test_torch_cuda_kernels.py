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
- K6 / K7 budget ADC: atol 1e-5 on the finite entries and the same +inf
  entries (subspaces summed in the plain version's order, then the row
  term: they agree bit for bit in practice);
- K9 / K10 budget exact: atol 1e-4 on the finite shifted scores and the
  same +inf entries (float32 queries, bf16 rows widened exactly, float32
  sums over 304 products in another order than the plain matmul's; K10
  splits each query value into three bf16 parts, which hold it exactly,
  for the tensor cores, so queries of norm 10 hold 1e-4 too);
- K3 / K5 / K8 over int8 LUTs: exact integer sums (K3's and K5's packed
  16-bit lanes too, at m up to 258, and their unpacked sums past it) and
  the plain version's rounding of the rescale (and of K8's row-term add),
  so K3 and K5 are held to equality (mins, ids and +inf / −1 slots) and
  K8 to atol 1e-5 on the finite entries with the same +inf entries.
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
        luts, codes_t, rowterm, tiles, block_t=block_t), 1e-5)


def _exact_case(seed, B, block_t, d=300, nt=6, P=5, q_norm=1.0):
    """Unit rows of width d in a (NA, D) bf16 table, D = d rounded up to a
    multiple of 8, pad rows in tile 1 and the inf tile; queries are rows of
    tile 0 scaled to norm ``q_norm``."""
    rng = np.random.default_rng(seed)
    na = (nt + 1) * block_t
    v = rng.normal(size=(na, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[block_t + block_t // 2:2 * block_t] = 0.0       # pad rows
    v[nt * block_t:] = 0.0                             # the inf tile
    vt = torch.as_tensor(v, device="cuda")
    vecs = torch.zeros(na, -(-d // 8) * 8, dtype=torch.bfloat16,
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
        ql, codes_t, rowterm, tiles, block_t=256, scale=sc), 1e-5)
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
        ql, codes_t, rowterm, tiles, block_t=block_t, scale=sc), 1e-5)


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
