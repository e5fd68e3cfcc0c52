"""The scan kernels' plain versions (ops/kernels.py) against the JAX
package's Pallas kernels run in interpret mode on the CPU, and the
wrappers' CPU behaviour.

Tolerances:
- dense ADC: ``m·max(lut)·2⁻⁸`` per element, because the Pallas kernel
  casts LUTs to bf16 (relative rounding ≤ 2⁻⁹ per lookup) and the port
  keeps them float32;
- binned ADC: the same bound plus 2⁻¹⁷ relative for the TPU kernel's
  argmin packed into the min's low mantissa bits; ids are checked by the
  contract (own bin, points at a row scoring the bin min), not bit for bit;
- fused exact: atol 1e-4 (bf16 operands on both sides, float32 sums in
  another order), same id contract;
- budget ADC (K6/K7): the dense bound ``m·max(lut)·2⁻⁸`` — the Pallas
  kernels cast LUTs to bf16, the port's keep float32 — with the same +inf
  entries;
- budget exact (K9/K10): ``2⁻⁷·max‖q‖·max‖v‖`` — the Pallas kernels round
  the queries to bf16 (relative 2⁻⁹ per value, at most 2⁻⁸·Σ|q||v| on the
  dot product, doubled in ``norm − 2·q·v``), the port keeps them float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from postgres_word2vec_tpu.ops import adc as jadc
from postgres_word2vec_tpu.ops import lut as jlut
from postgres_word2vec_tpu.ops import pallas_kernels as pk

from postgres_word2vec_tpu_torch.ops import kernels

from test_torch_parity_util import (assert_binned_contract,
                                    assert_same_top_k, np_, to_jax, to_torch)


def _adc_case(rng, B, m, k, n):
    """LUTs of B queries of width m·(48 // m) (48 at m = 12) and random
    codes, uint8 for k ≤ 256, else int16."""
    cb = rng.normal(size=(m, k, max(1, 48 // m))).astype(np.float32)
    q = rng.normal(size=(B, m * max(1, 48 // m))).astype(np.float32)
    codes = rng.integers(0, k, size=(n, m)).astype(
        np.uint8 if k <= 256 else np.int16)
    luts = np_(jlut.build_luts(to_jax(q), to_jax(cb)))
    return luts, codes


# the PQ codebooks at m = 12, and the IVPQ join's dense round: its fine
# 30×32 codebook and its fused-pair 15×1024 LUTs over int16 codes
@pytest.mark.parametrize("m,k", [(12, 16), (12, 256), (30, 32), (15, 1024)],
                         ids=["16", "256", "m30-k32", "m15-k1024"])
def test_plain_dense_adc_matches_pallas_interpret(rng, m, k):
    luts, codes = _adc_case(rng, 5, m, k, 4096)
    got = np_(kernels.adc_scan_plain(to_torch(luts), to_torch(codes.T)))
    want = np_(pk.adc_scan_pallas(to_jax(luts), to_jax(codes.T),
                                  block_n=2048, interpret=True))
    bound = m * luts.max() * 2.0 ** -8
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("k", [16, 256])
def test_plain_binned_adc_matches_pallas_interpret(rng, k):
    m = 12
    luts, codes = _adc_case(rng, 5, m, k, 4096)
    mins, ids = kernels.adc_scan_binned_plain(to_torch(luts),
                                              to_torch(codes.T))
    jm, ji = pk.adc_scan_binned_pallas(to_jax(luts), to_jax(codes.T),
                                       block_n=2048, bins=128,
                                       interpret=True)
    dense = np_(jadc.adc_distances(to_jax(luts), to_jax(codes)))
    bound = m * luts.max() * 2.0 ** -8
    # port vs TPU kernel: same bins, mins within the bf16 + packing bound
    assert_binned_contract(mins, ids, jm, dense, block_n=2048, bins=128,
                           atol=bound, mins_rtol=2.0 ** -17)
    # the TPU kernel's own ids satisfy the same contract
    assert_binned_contract(jm, ji, mins, dense, block_n=2048, bins=128,
                           atol=bound, mins_rtol=2.0 ** -17)
    # the port's plain ids point at exact float32 bin minima
    assert_binned_contract(mins, ids, mins, np_(kernels.adc_scan_plain(
        to_torch(luts), to_torch(codes.T))), block_n=2048, bins=128,
        atol=0.0)


@pytest.mark.parametrize("block_n", [1024, 8192])
def test_plain_fused_exact_matches_pallas_interpret(rng, block_n):
    n, d, B = 3000, 48, 6
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[rng.integers(0, n, B)]
    table, norms, valid = kernels.tile_table(to_torch(v), block_n=block_n)
    qb = kernels.pad_queries(to_torch(q), table.shape[1])
    mins, ids = kernels.fused_exact_scan_plain(qb, table, norms,
                                               block_n=block_n)
    jt, jn, jvalid = pk.tile_table(to_jax(v), block_n=block_n)
    jm, ji = pk.fused_exact_scan_pallas(to_jax(q), jt, jn, bins=128,
                                        interpret=True)
    assert valid == jvalid == n
    qf = qb.float()
    dense = np_(norms[None, :n] - 2.0 * (qf @ table[:n].float().t()))
    assert_binned_contract(mins, ids, jm, dense, block_n=block_n, bins=128,
                           atol=1e-4)
    assert_binned_contract(jm, ji, mins, dense, block_n=block_n, bins=128,
                           atol=1e-4)


def test_tile_table_matches_jax(rng):
    v = rng.normal(size=(1000, 300)).astype(np.float32)
    table, norms, valid = kernels.tile_table(to_torch(v), block_n=512)
    jt, jn, _ = pk.tile_table(to_jax(v), block_n=512)
    assert valid == 1000 and table.shape == (1024, 304)
    assert table.dtype == torch.bfloat16
    # the JAX layout is (n_tiles, d, block_n); the port's is row-major
    jrows = np.moveaxis(np.asarray(jt.astype(jnp.float32)), 1, 2).reshape(
        1024, 300)
    np.testing.assert_array_equal(np_(table.float())[:, :300], jrows)
    assert not table[:, 300:].any() and not table[1000:].any()
    np.testing.assert_allclose(np_(norms), np.asarray(jn), rtol=1e-6)
    assert torch.isinf(norms[1000:]).all()


def test_wrappers_take_the_plain_path_on_cpu_without_counting(rng):
    luts, codes = _adc_case(rng, 3, 12, 16, 2049)
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    kernels.reset_launch_counts()
    torch.testing.assert_close(kernels.adc_scan(lt, ct),
                               kernels.adc_scan_plain(lt, ct))
    got = kernels.adc_scan_binned(lt, ct)
    want = kernels.adc_scan_binned_plain(lt, ct)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    v = to_torch(rng.normal(size=(300, 48)).astype(np.float32))
    table, norms, _ = kernels.tile_table(v, block_n=256)
    qb = kernels.pad_queries(v[:2], table.shape[1])
    got = kernels.fused_exact_scan(qb, table, norms, block_n=256)
    want = kernels.fused_exact_scan_plain(qb, table, norms, block_n=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    assert not kernels.supports_hopper()


def test_ragged_binned_scan_masks_the_tail(rng):
    """N = 2049: the second tile has one real row; its other bins hold
    +inf, and the top-k wrapper reports them as id −1."""
    luts, codes = _adc_case(rng, 2, 12, 16, 2049)
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    mins, ids = kernels.adc_scan_binned(lt, ct)
    assert mins.shape == (2, 256)
    assert torch.isfinite(mins[:, 128]).all() and ids[0, 128] == 2048
    assert torch.isinf(mins[:, 129:]).all()
    d, i = kernels.adc_top_k_binned(lt, ct, 300, valid_n=2049)
    assert (i[:, 129:] == -1).all() and torch.isinf(d[:, 129:]).all()
    assert int(i.max()) < 2049


def test_mixed_devices_raise(rng):
    luts, codes = _adc_case(rng, 2, 12, 16, 100)
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.adc_scan(to_torch(luts).to("meta"),
                         to_torch(codes.T).contiguous())


def test_adc_top_k_wrappers_match_jax(rng):
    luts, codes = _adc_case(rng, 4, 12, 256, 4096)
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    got = kernels.adc_top_k(lt, ct, 10, valid_n=4000)
    want = pk.adc_top_k_pallas(to_jax(luts), to_jax(codes.T), 10,
                               valid_n=4000, approx=False, interpret=True)
    # bf16 LUTs on the TPU side: distances within the dense bound
    bound = 12 * luts.max() * 2.0 ** -8
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), atol=bound)
    exact = jadc.adc_top_k(to_jax(luts), to_jax(codes[:4000]), 10)
    assert_same_top_k(*got, *exact, atol=1e-5)
    got_b = kernels.adc_top_k_binned(lt, ct, 10, valid_n=4000)
    # every binned survivor top-k entry is a real row at its exact distance
    dense = np_(kernels.adc_scan_plain(lt, ct))
    ids = np_(got_b[1])
    np.testing.assert_allclose(np.take_along_axis(dense, ids, 1),
                               np_(got_b[0]), atol=1e-6)
    assert ids.max() < 4000


def test_fused_exact_top_k_matches_jax(rng):
    n, d = 5000, 48
    v = rng.normal(size=(n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[:4]
    table, norms, valid = kernels.tile_table(to_torch(v), block_n=1024)
    got = kernels.fused_exact_top_k(to_torch(q), table, norms, 10,
                                    valid_n=valid, block_n=1024)
    jt, jn, jvalid = pk.tile_table(to_jax(v), block_n=1024)
    want = pk.fused_exact_top_k(to_jax(q), jt, jn, 10, valid_n=jvalid,
                                interpret=True)
    assert_same_top_k(*got, *want, atol=1e-4)
    assert (np_(got[1])[:, 0] == np.arange(4)).all()


# ------------------------------------------------ K6/K7/K9/K10 budget probes

def _budget_case(rng, B=12, m=6, k=32, block_t=128, nt=5, P=4, d=30):
    """The JAX package's test layout (tests/test_pallas.py): tile ids with
    an inf-tile slot and a query that probes one tile in every slot."""
    cb = rng.normal(size=(m, k, d // m)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    na = (nt + 1) * block_t
    codes = rng.integers(0, k, size=(na, m)).astype(np.uint8)
    rowterm = rng.normal(size=(na,)).astype(np.float32)
    rowterm[2 * block_t + 100:3 * block_t] = np.inf
    rowterm[nt * block_t:] = np.inf
    luts = np_(jlut.build_luts(to_jax(q), to_jax(cb)))
    tiles = rng.integers(0, nt, size=(B, P)).astype(np.int32)
    tiles[3, 2] = nt
    tiles[7, :] = 0
    return q, luts, codes, rowterm, tiles, block_t


def _close_with_inf(got, want, atol):
    got, want = np_(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= atol


@pytest.mark.parametrize("rows", [8, 32])
def test_group_probe_layout_matches_jax(rng, rows):
    B, P, nt = 40, 6, 4
    tiles = rng.integers(0, nt + 1, size=(B, P)).astype(np.int32)
    groups = -(-B * P // rows) + nt + 1
    got = kernels._group_probe_layout(to_torch(tiles), B, P, groups, nt, rows)
    want = pk._group_probe_layout(to_jax(tiles), B, P, groups, nt, rows)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_grouped_layout_reassembles_the_contract(rng, rows):
    """The grouped kernels' glue: every (query, slot) pair lands in a
    group of its own tile, in a slot naming its query, and the reassembly
    gather of those grouped rows gives back the (B, P·block_t) contract."""
    _, luts, codes, rowterm, tiles, bt = _budget_case(rng, B=40, P=6)
    t = to_torch(tiles)
    want = kernels.budget_adc_plain(to_torch(luts),
                                    to_torch(codes.T).contiguous(),
                                    to_torch(rowterm), t, block_t=bt)
    B, P = tiles.shape
    qidx, tog, row = kernels._grouped_layout(t, codes.shape[0] // bt, rows)
    assert tog.shape[0] == -(-B * P // rows) + codes.shape[0] // bt
    np.testing.assert_array_equal(np_(tog[row // rows]), tiles.reshape(-1))
    np.testing.assert_array_equal(np_(qidx.reshape(-1)[row]),
                                  np.arange(B * P) // P)
    grouped = torch.full((qidx.numel(), bt), float("nan"))
    grouped[row] = want.reshape(B * P, bt)
    assert torch.equal(kernels._reassemble(grouped, row, t), want)


@pytest.mark.parametrize("rows", [8, 32])
def test_pair_layout_plain_matches_jax(rng, rows):
    """K7's pair layout, plain version, against the JAX
    ``_group_probe_layout`` on a plan whose queries end in inf-tile
    padding: the same tile per group and the same real slots; every real
    slot holds a pair of the group's query (``pairs // P == qidx``) whose
    grouped row is that slot (``row[pairs] == slot``); every pair appears
    exactly once."""
    B, P, nt = 40, 6, 4                  # tiles 0..nt-1 and the inf tile nt
    tiles = rng.integers(0, nt, size=(B, P)).astype(np.int32)
    cut = rng.integers(1, P + 1, size=B)
    tiles[np.arange(P)[None, :] >= cut[:, None]] = nt
    groups = -(-B * P // rows) + nt + 1
    pairs, tog = kernels.budget_pair_layout_plain(to_torch(tiles), nt + 1,
                                                  rows)
    qidx, jtog, row = (np.asarray(a) for a in pk._group_probe_layout(
        to_jax(tiles), B, P, groups, nt, rows))
    pairs = np_(pairs)
    assert pairs.shape == (groups, rows)
    np.testing.assert_array_equal(np_(tog), jtog)
    real = pairs >= 0
    np.testing.assert_array_equal(real, qidx < B)
    np.testing.assert_array_equal(pairs[real] // P, qidx[real])
    slots = np.arange(groups * rows).reshape(groups, rows)
    np.testing.assert_array_equal(row[pairs[real]], slots[real])
    np.testing.assert_array_equal(np.sort(pairs[real]), np.arange(B * P))


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_pair_layout_scatter_rebuilds_the_contract(rng, rows):
    """K7's write-through, on the CPU: each real slot's row (the plain sums
    of its pair's query over its group's tile, +inf for the bucket of ids
    outside the table) written to row ``pairs`` of the output rebuilds
    ``budget_adc_plain``'s (B, P·block_t) contract."""
    _, luts, codes, rowterm, tiles, bt = _budget_case(rng, B=40, P=6)
    n_tiles = codes.shape[0] // bt
    tiles[5, 1], tiles[9, 0] = -2, 99                 # ids outside the table
    B, P = tiles.shape
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    rt = to_torch(rowterm)
    inside = np.where((tiles >= 0) & (tiles < n_tiles), tiles, n_tiles - 1)
    want = kernels.budget_adc_plain(lt, ct, rt, to_torch(inside), block_t=bt)
    pairs, tog = kernels.budget_pair_layout_plain(to_torch(tiles), n_tiles,
                                                  rows)
    real = pairs >= 0
    g = torch.arange(pairs.shape[0])[:, None].expand_as(pairs)[real]
    p = pairs[real].long()
    t = torch.clamp_max(tog[g], n_tiles - 1)[:, None]  # bad ids: the inf tile
    per_pair = kernels.budget_adc_plain(lt[p // P], ct, rt, t, block_t=bt)
    out = torch.full((B * P, bt), float("nan"))
    out[p] = per_pair
    assert torch.equal(out.reshape(B, P * bt), want)


def test_plain_budget_adc_matches_pallas_interpret(rng):
    _, luts, codes, rowterm, tiles, bt = _budget_case(rng)
    args = (to_torch(luts), to_torch(codes.T).contiguous(),
            to_torch(rowterm), to_torch(tiles))
    jargs = (to_jax(luts), to_jax(codes.T), to_jax(rowterm), to_jax(tiles))
    bound = 6 * luts.max() * 2.0 ** -8
    got = kernels.budget_adc_plain(*args, block_t=bt)
    _close_with_inf(got, pk.budget_adc_pallas(*jargs, block_t=bt,
                                              interpret=True), bound)
    # the grouped TPU kernel has the same contract, so the same plain twin
    _close_with_inf(kernels.budget_adc_grouped(*args, block_t=bt, rows=8),
                    pk.budget_adc_grouped_pallas(*jargs, block_t=bt,
                                                 interpret=True), bound)


@pytest.mark.parametrize("grouped", [False, True])
def test_budget_adc_plan_of_inf_tiles_matches_pallas(rng, grouped):
    """A plan that names nothing but the inf tile (a query whose cells hold
    no target): +inf everywhere, in the port as in the JAX kernels."""
    _, luts, codes, rowterm, tiles, bt = _budget_case(rng)
    tiles[:] = codes.shape[0] // bt - 1
    args = (to_torch(luts), to_torch(codes.T).contiguous(),
            to_torch(rowterm), to_torch(tiles))
    jargs = (to_jax(luts), to_jax(codes.T), to_jax(rowterm), to_jax(tiles))
    if grouped:
        got = kernels.budget_adc_grouped(*args, block_t=bt, rows=8)
        want = pk.budget_adc_grouped_pallas(*jargs, block_t=bt,
                                            interpret=True)
    else:
        got = kernels.budget_adc(*args, block_t=bt)
        want = pk.budget_adc_pallas(*jargs, block_t=bt, interpret=True)
    assert got.shape == want.shape
    assert bool(torch.isinf(got).all()) and bool((got > 0).all())
    assert np.isposinf(np.asarray(want)).all()


def test_plain_budget_exact_matches_pallas_interpret(rng):
    q, _, _, rownorm, tiles, bt = _budget_case(rng)
    na = rownorm.shape[0]
    vecs = rng.normal(size=(na, 30)).astype(np.float32)
    vecs[~np.isfinite(rownorm)] = 0.0
    rownorm = np.where(np.isfinite(rownorm), (vecs * vecs).sum(1), np.inf)
    table = torch.zeros(na, 32, dtype=torch.bfloat16)
    table[:, :30] = to_torch(vecs).to(torch.bfloat16)
    jvecs_t = to_jax(np_(table.float())[:, :30].T)
    bound = (2.0 ** -7 * np.linalg.norm(q, axis=1).max()
             * np.linalg.norm(vecs, axis=1).max())
    got = kernels.budget_exact_plain(to_torch(q), table, to_torch(rownorm),
                                     to_torch(tiles), block_t=bt)
    _close_with_inf(got, pk.budget_exact_pallas(
        to_jax(q), jvecs_t, to_jax(rownorm), to_jax(tiles), block_t=bt,
        interpret=True), bound)
    grouped = kernels.budget_exact_grouped(
        to_torch(q), table, to_torch(rownorm), to_torch(tiles), block_t=bt,
        rows=8)
    _close_with_inf(grouped, pk.budget_exact_grouped_pallas(
        to_jax(q), jvecs_t, to_jax(rownorm), to_jax(tiles), block_t=bt,
        interpret=True), bound)


def test_split_bf16_queries_hold_budget_exact_plain(rng):
    """K10's reason for its hi/lo split, on the CPU: at d = 300, scores from
    the two bf16 parts of each float32 query, ``hi = bf16(q)`` and ``lo =
    bf16(q − hi)``, against bf16 rows with float32 sums, stay within 1e-5
    of :func:`kernels.budget_exact_plain`; ``hi`` alone (the TPU kernel's
    bf16 queries) does not. The kernel takes a third part, ``bf16(q − hi −
    lo)``, and the three hold every float32 value exactly, at any norm."""
    d, D, block_t, nt, B, P = 300, 304, 128, 4, 16, 3
    na = (nt + 1) * block_t
    v = rng.normal(size=(na, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[nt * block_t:] = 0.0                              # the inf tile
    table = torch.zeros(na, D, dtype=torch.bfloat16)
    table[:, :d] = to_torch(v).to(torch.bfloat16)
    rownorm = to_torch((v * v).sum(1))
    rownorm[nt * block_t:] = float("inf")
    q = rng.normal(size=(B, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tiles = rng.integers(0, nt, size=(B, P)).astype(np.int64)
    tiles[0, -1] = nt
    want = kernels.budget_exact_plain(to_torch(q), table, rownorm,
                                      to_torch(tiles), block_t=block_t)
    qf = torch.nn.functional.pad(to_torch(q), (0, D - d))
    hi = qf.to(torch.bfloat16)
    lo = (qf - hi.float()).to(torch.bfloat16)
    rows = table.float().reshape(nt + 1, block_t, D)[to_torch(tiles)]
    norms = rownorm.reshape(nt + 1, block_t)[to_torch(tiles)]

    def scores(*parts):
        dot = sum(torch.einsum("bptd,bd->bpt", rows, p.float())
                  for p in parts)
        return (norms - 2.0 * dot).reshape(B, P * block_t)

    _close_with_inf(scores(hi, lo), want, 1e-5)
    fin = torch.isfinite(want)
    assert float((scores(hi) - want)[fin].abs().max()) > 1e-5
    q10 = qf * 10.0
    parts = []
    for _ in range(3):
        parts.append(q10.to(torch.bfloat16))
        q10 = q10 - parts[-1].float()
    assert not q10.any()


def test_budget_dispatch_rule_is_the_jax_rule(rng):
    assert kernels.GROUPED_ROWS_DEFAULT == pk.GROUPED_ROWS_DEFAULT
    for bp, n_tiles, rows, slot in ((8192, 1416, 32, 1920),
                                    (15360, 4000, 32, 6144),
                                    (16384, 13025, 32, 1920),
                                    (16, 1416, 32, 600), (512, 6, 8, 64)):
        assert (kernels._grouped_wins(bp, n_tiles, rows, slot)
                == pk._grouped_wins(bp, n_tiles, rows, slot))
    # the join regime runs grouped, a sparse probe per query (JAX's test)
    _, luts, codes, rowterm, tiles, bt = _budget_case(rng, B=64, P=8)
    args = (to_torch(luts), to_torch(codes.T).contiguous(),
            to_torch(rowterm), to_torch(tiles))
    _close_with_inf(kernels.budget_adc_auto(*args, block_t=bt),
                    kernels.budget_adc_plain(*args, block_t=bt), 0.0)
    with pytest.raises(ValueError, match="lut_dtype"):
        kernels.budget_adc_auto(*args, block_t=bt, lut_dtype="fp8")


def test_budget_wrappers_take_the_plain_path_on_cpu(rng):
    q, luts, codes, rowterm, tiles, bt = _budget_case(rng)
    args = (to_torch(luts), to_torch(codes.T).contiguous(),
            to_torch(rowterm), to_torch(tiles))
    kernels.reset_launch_counts()
    assert torch.equal(kernels.budget_adc(*args, block_t=bt),
                       kernels.budget_adc_plain(*args, block_t=bt))
    assert torch.equal(kernels.budget_adc_grouped(*args, block_t=bt),
                       kernels.budget_adc_plain(*args, block_t=bt))
    table = torch.zeros(rowterm.shape[0], 32, dtype=torch.bfloat16)
    eargs = (to_torch(q), table, to_torch(rowterm), to_torch(tiles))
    assert torch.equal(kernels.budget_exact(*eargs, block_t=bt),
                       kernels.budget_exact_plain(*eargs, block_t=bt))
    assert torch.equal(kernels.budget_exact_grouped(*eargs, block_t=bt),
                       kernels.budget_exact_plain(*eargs, block_t=bt))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
