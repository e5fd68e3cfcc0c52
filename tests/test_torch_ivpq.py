"""The port's IVPQ join against the JAX package's (CPU): an index built and
saved by the JAX package loads through ``ivpq_from_numpy``; the cell
selection, statistics and join tiling match; and ``search_join`` returns
the same ids up to ties on both rounds ("dense" and "budget"), for the
three distance methods, with alpha escalation over several rounds and with
the fused-pair LUTs.

Tolerances: confidence 1e-6 (float32 erf on both sides); ADC and exact
distances 1e-4 (float32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from postgres_word2vec_tpu.models import ivpq as jivpq

from postgres_word2vec_tpu_torch.models import ivpq
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex

from test_torch_parity_util import assert_same_top_k, np_, to_jax, to_torch

N, D = 3000, 48


def _clustered(rng, n=N, d=D, centers=64):
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.6 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def join_case(tmp_path_factory):
    """(vectors, JAX index, port index, target ids, JAX and port domain
    statistics). Two coarse positions × 8 centroids = 64 cells."""
    x = _clustered(np.random.default_rng(12))
    jidx = jivpq.IVPQIndex.build(jax.random.PRNGKey(1), jnp.asarray(x),
                                 m=12, k=16, k_coarse=8, coarse_positions=2,
                                 train_size=None, iters=5)
    path = tmp_path_factory.mktemp("ivpq") / "ivpq.npz"
    jidx.save(path)
    idx = IVPQIndex.load(path, device="cpu")
    tids = np.arange(0, N, 2).astype(np.int32)
    jstats = jivpq.build_statistics(jidx.cell_of, to_jax(tids),
                                    jidx.num_cells)
    stats = ivpq.build_statistics(idx.cell_of, to_torch(tids), idx.num_cells)
    return x, jidx, idx, tids, jstats, stats


def test_cross_load_and_statistics(join_case):
    _, jidx, idx, tids, jstats, stats = join_case
    np.testing.assert_array_equal(np_(idx.codes), np.asarray(jidx.codes))
    np.testing.assert_array_equal(np_(idx.cell_of), np.asarray(jidx.cell_of))
    assert idx.num_cells == jidx.num_cells == 64
    np.testing.assert_allclose(np_(stats), np.asarray(jstats), rtol=1e-6)
    np.testing.assert_allclose(
        np_(ivpq.uniform_statistics(idx.coarse.cell_counts)),
        np.asarray(jivpq.uniform_statistics(jidx.coarse.cell_counts)),
        rtol=1e-6)


def test_confidence_models_match_jax():
    size = np.array([0.0, 10.0, 500.0, 5000.0], np.float32)[:, None]
    p = np.linspace(0.0, 1.0, 11, dtype=np.float32)[None, :]
    for expect in (0.0, 3.0, 40.0, 900.0):
        got = ivpq.confidence_hyp(expect, to_torch(size), to_torch(p), 6000.0)
        want = jivpq.confidence_hyp(expect, to_jax(size), to_jax(p), 6000.0)
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6)
        got = ivpq.confidence_bin(expect, to_torch(size), to_torch(p))
        want = jivpq.confidence_bin(expect, to_jax(size), to_jax(p))
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6)


def test_assignment_and_cell_distances_match_jax(join_case):
    x, jidx, idx, *_ = join_case
    got = ivpq.assign_cells(to_torch(x), idx.coarse.centroids,
                            chunk_size=700)
    np.testing.assert_array_equal(np_(got), np.asarray(jidx.cell_of))
    cd = ivpq.cell_distances(to_torch(x[:5]), idx.coarse.centroids)
    jcd = jivpq.cell_distances(to_jax(x[:5]), jidx.coarse.centroids)
    np.testing.assert_allclose(np_(cd), np.asarray(jcd), atol=1e-5)


@pytest.mark.parametrize("alpha", [1, 30])
def test_select_cells_matches_jax(join_case, alpha):
    x, jidx, idx, tids, jstats, stats = join_case
    counts = np.bincount(np.asarray(jidx.cell_of)[tids],
                         minlength=64).astype(np.float32)
    t_real = np.int32(len(tids))
    got = ivpq._select_cells(to_torch(x[:20]), idx.coarse.centroids, stats,
                             to_torch(counts), torch.tensor(t_real), 5,
                             alpha, 0.8)
    want = jivpq._select_cells(to_jax(x[:20]), jidx.coarse.centroids, jstats,
                               to_jax(counts), jnp.asarray(t_real), 5, alpha,
                               jnp.float32(0.8))
    for a, b in zip(got[:3], want[:3]):              # order, n_sel, exhausted
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    for a, b in zip(got[3:], want[3:]):              # predicted, retrieved
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("with_vecs", [False, True])
def test_build_join_tiles_matches_jax(join_case, with_vecs):
    x, jidx, idx, tids, *_ = join_case
    mask = np.ones(len(tids), bool)
    mask[7] = False                                  # a padded target
    tc, cells = np.asarray(jidx.codes)[tids], np.asarray(jidx.cell_of)[tids]
    jt = jivpq.build_join_tiles(to_jax(tc), to_jax(cells), to_jax(mask),
                                to_jax(x[tids]), block_t=128, num_cells=64,
                                with_vecs=with_vecs)
    t = ivpq.build_join_tiles(to_torch(tc), to_torch(cells), to_torch(mask),
                              to_torch(tids), to_torch(x), block_t=128,
                              num_cells=64, with_vecs=with_vecs,
                              chunk_rows=500)
    assert t.inf_tile == int(jt.inf_tile)
    lids = np.asarray(jt.local_ids)
    real = lids >= 0
    np.testing.assert_array_equal(np_(t.local_ids), lids)
    np.testing.assert_array_equal(np_(t.codes_t)[:, real],
                                  np.asarray(jt.codes_t)[:, real])
    np.testing.assert_array_equal(np_(t.rowterm), np.asarray(jt.rowterm))
    for name in ("tile_start", "tile_cnt", "tile_rows", "cell_sizes"):
        np.testing.assert_array_equal(np_(getattr(t, name)),
                                      np.asarray(getattr(jt, name)))
    assert int(t.t_real) == int(jt.t_real) == len(tids) - 1
    if with_vecs:
        # row-major (NA, D) in the port, (d, NA) in JAX; the port's pad
        # rows are zero (JAX parks the padded target's row on the inf tile)
        vecs = np_(t.vecs.float())
        np.testing.assert_array_equal(
            vecs[real, :D], np.asarray(jt.vecs_t.T.astype(jnp.float32))[real])
        assert not vecs[~real].any()
        np.testing.assert_allclose(np_(t.rownorm), np.asarray(jt.rownorm),
                                   rtol=1e-6)
    else:
        assert t.vecs is None


def _both_joins(join_case, k, **kw):
    x, jidx, idx, tids, jstats, stats = join_case
    q = x[1:60:4]
    got = idx.search_join(to_torch(q), k, to_torch(tids), vectors=to_torch(x),
                          statistics=stats, return_info=True, **kw)
    want = jidx.search_join(to_jax(q), k, to_jax(tids), vectors=to_jax(x),
                            statistics=jstats, return_info=True, **kw)
    assert_same_top_k(got[0], got[1], want[0], want[1], atol=1e-4)
    assert got[2]["rounds"] == want[2]["rounds"]
    assert got[2]["final_alpha"] == want[2]["final_alpha"]
    np.testing.assert_array_equal(np_(got[2]["retrieved"]),
                                  np.asarray(want[2]["retrieved"]))
    return got


@pytest.mark.parametrize("impl", ["dense", "budget"])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_search_join_matches_jax(join_case, impl, method):
    _both_joins(join_case, 5, impl=impl, method=method, alpha=20, pvf=5)


@pytest.mark.parametrize("method", [0, 1, 2])
def test_search_join_escalates_like_jax(join_case, method):
    """A one-tile budget leaves queries short of k = 30 candidates, so alpha
    doubles over the three rounds allowed."""
    got = _both_joins(join_case, 30, impl="budget", method=method, alpha=3,
                      pvf=3, budget_tiles=1, max_rounds=3)
    assert got[2]["rounds"] == 3 and got[2]["final_alpha"] == 12


@pytest.mark.parametrize("impl", ["dense", "budget"])
def test_search_join_fused_pair_luts_match_jax(join_case, impl):
    """alpha·k over ``long_codes_threshold`` switches to the (m/2)×k²
    "short codes" tables."""
    _both_joins(join_case, 5, impl=impl, method=0, alpha=20,
                long_codes_threshold=50)


def test_prepared_join_equals_the_ad_hoc_join(join_case):
    x, _, idx, tids, _, stats = join_case
    q = to_torch(x[:9])
    ph = idx.prepare_join(to_torch(tids), vectors=to_torch(x))
    assert ph.size == len(tids) and ph.build_s >= 0.0
    for method in (0, 1, 2):
        a = idx.search_join(q, 5, prepared=ph, statistics=stats, alpha=10,
                            method=method, impl="budget")
        b = idx.search_join(q, 5, to_torch(tids), vectors=to_torch(x),
                            statistics=stats, alpha=10, method=method,
                            impl="budget", query_chunk=4)
        # query chunks of another size round the LUT matmuls differently
        assert torch.equal(a[1], b[1])
        torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "budget"])
def test_prepared_join_builds_its_code_tables_once(join_case, impl):
    """The transposed and fused-pair code tables of a prepared target set
    are built on first use and reused by later rounds and calls."""
    from postgres_word2vec_tpu_torch.ops import lut

    x, _, idx, tids, _, stats = join_case
    q = to_torch(x[:9])
    ph = idx.prepare_join(to_torch(tids), vectors=to_torch(x))
    runs = [idx.search_join(q, 5, prepared=ph, statistics=stats, alpha=20,
                            impl=impl, long_codes_threshold=50)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    fused = lut.fuse_codes(ph.target_codes, 16)
    if impl == "dense":
        assert set(ph._codes_t) == {16}
        table = ph.codes_t(16)
        assert table is ph.codes_t(16)
        assert table.is_contiguous() and torch.equal(table, fused.t())
    else:
        jt = ph.tiles(with_vecs=False)
        assert set(jt.cache) == {16}
        table = jt.fused_codes_t(16)
        assert table is jt.fused_codes_t(16)
        assert table.is_contiguous()
        assert torch.equal(table, lut.fuse_codes(jt.codes_t.t(), 16).t())
        assert not ph._codes_t


def test_search_join_argument_checks(join_case):
    x, _, idx, tids, _, _ = join_case
    q = to_torch(x[:2])
    with pytest.raises(ValueError, match="target_ids or prepared"):
        idx.search_join(q, 5)
    with pytest.raises(ValueError, match="raw vectors"):
        idx.search_join(q, 5, to_torch(tids), method=1)
    with pytest.raises(ValueError, match="lut_dtype"):
        idx.search_join(q, 5, to_torch(tids), lut_dtype="fp8")
    # two queries probe sparsely: the per-query kernel has no int8 twin, so
    # the round warns and keeps float32 LUTs, as in the JAX package
    with pytest.warns(UserWarning, match="no int8 variant"):
        a = idx.search_join(q, 5, to_torch(tids), lut_dtype="int8",
                            impl="budget")
    b = idx.search_join(q, 5, to_torch(tids), impl="budget")
    assert torch.equal(a[1], b[1])


def test_save_round_trips_through_jax(join_case, tmp_path):
    _, jidx, idx, *_ = join_case
    idx.save(tmp_path / "port.npz")
    back = jivpq.IVPQIndex.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(back.codes),
                                  np.asarray(jidx.codes))
    np.testing.assert_array_equal(np.asarray(back.cell_of),
                                  np.asarray(jidx.cell_of))
    assert np.asarray(back.cell_of).dtype == np.int32


def test_build_in_the_port(rng):
    x = to_torch(_clustered(rng, n=2000))
    g = torch.Generator().manual_seed(0)
    idx = IVPQIndex.build(g, x, m=12, k=16, k_coarse=16, coarse_positions=1,
                          train_size=1500, iters=4)
    assert idx.num_cells == 16 and int(idx.coarse.cell_counts.sum()) == 2000
    tids = torch.arange(0, 2000, 2)
    _, ids = idx.search_join(x[:64:2], 5, tids, vectors=x, alpha=20,
                             method=1)
    assert (ids[:, 0] == torch.arange(0, 64, 2)).float().mean() >= 0.9
    grown = idx.add(x[:2])
    assert grown.size == 2002 and int(grown.coarse.cell_counts.sum()) == 2002
