"""The port's IVFADC model against the JAX package's (CPU): an index built
and saved by the JAX package loads through ``ivfadc_from_numpy``, its
layout and probe plan match field by field, and ``search``,
``search_adaptive`` and ``search_pv`` return the same ids up to ties.

Tolerances: distances 1e-4 (the IVFADC decomposition adds float32 terms
of order 1 in another order); post-verified distances 1e-5 (exact
float32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from postgres_word2vec_tpu.models import ivfadc as jivfadc

from postgres_word2vec_tpu_torch.models import ivfadc
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.utils.convert import ivfadc_from_numpy

from test_torch_parity_util import assert_same_top_k, np_, to_jax, to_torch

N, D = 3000, 48


def _clustered(rng, n=N, d=D, centers=64):
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.6 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """(vectors, JAX index, port index loaded from the JAX index's file)."""
    x = _clustered(np.random.default_rng(11))
    jidx = jivfadc.IVFADCIndex.build(jax.random.PRNGKey(0), jnp.asarray(x),
                                     m=12, k=16, k_coarse=24,
                                     train_size=None, iters=5)
    path = tmp_path_factory.mktemp("ivf") / "ivfadc.npz"
    jidx.save(path)
    return x, jidx, IVFADCIndex.load(path, device="cpu")


def test_cross_load_keeps_every_field(indexes):
    _, jidx, idx = indexes
    assert idx.codes_sorted.dtype == torch.uint8
    for name in ("cell_offsets", "codes_sorted", "row_ids", "assignments"):
        np.testing.assert_array_equal(np_(getattr(idx, name)),
                                      np.asarray(getattr(jidx, name)))
    assert idx.list_cap == jidx.list_cap and idx.num_cells == 24


def test_tiled_layout_matches_jax(indexes):
    _, jidx, idx = indexes
    t, jt = idx.tiled(), jidx.tiled()
    assert t.block_t == jt.block_t == 128 and t.inf_tile == jt.inf_tile
    np.testing.assert_array_equal(np_(t.codes_t), np.asarray(jt.codes_t))
    np.testing.assert_array_equal(np_(t.row_ids), np.asarray(jt.row_ids))
    for name in ("tile_start", "tile_cnt", "tile_rows", "cell_sizes"):
        np.testing.assert_array_equal(np_(getattr(t, name)),
                                      np.asarray(getattr(jt, name)))
    fin = np.isfinite(np.asarray(jt.rowterm))
    np.testing.assert_array_equal(np.isfinite(np_(t.rowterm)), fin)
    np.testing.assert_allclose(np_(t.rowterm)[fin],
                               np.asarray(jt.rowterm)[fin], atol=1e-5)
    assert (t.max_tile_cnt, t.avg_tile_cnt) == (jt.max_tile_cnt,
                                                pytest.approx(jt.avg_tile_cnt))


def test_plan_probe_tiles_matches_jax(rng):
    start = rng.integers(0, 50, size=(6, 4)).astype(np.int32)
    cnt = rng.integers(0, 4, size=(6, 4)).astype(np.int32)
    cnt[2] = 0                                   # a query with nothing
    for p in (1, 5, 16):
        got = ivfadc.plan_probe_tiles(p, to_torch(start), to_torch(cnt), 99)
        want = jivfadc.plan_probe_tiles(p, to_jax(start), to_jax(cnt), 99)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np_(a), np.asarray(b))


def test_compute_rowterm_matches_jax(indexes):
    _, jidx, idx = indexes
    cells = np.asarray(jidx.assignments)[np.asarray(jidx.row_ids)]
    got = ivfadc._compute_rowterm(idx.coarse.centroids,
                                  idx.codebook.centroids, to_torch(cells),
                                  idx.codes_sorted, chunk_size=1000)
    want = jivfadc._compute_rowterm(jidx.coarse.centroids,
                                    jidx.codebook.centroids,
                                    to_jax(cells), jidx.codes_sorted)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("w,budget", [(1, None), (3, None), (3, 2)])
def test_search_matches_jax(indexes, w, budget):
    x, jidx, idx = indexes
    q = x[::301]
    got = idx.search(to_torch(q), 10, w=w, budget_tiles=budget,
                     return_info=True)
    want = jidx.search(to_jax(q), 10, w=w, budget_tiles=budget,
                       return_info=True)
    assert_same_top_k(got[0], got[1], want[0], want[1], atol=1e-4)
    for key in ("found", "needed"):
        np.testing.assert_array_equal(np_(got[2][key]),
                                      np.asarray(want[2][key]))
    assert got[2]["budget_tiles"] == want[2]["budget_tiles"]


def test_search_adaptive_widens_like_jax(indexes):
    """w=1 with k larger than most cells: the rank window widens."""
    x, jidx, idx = indexes
    q = x[5:400:41]
    got = idx.search_adaptive(to_torch(q), 200, w=1)
    want = jidx.search_adaptive(to_jax(q), 200, w=1)
    assert_same_top_k(*got, *want, atol=1e-4)
    assert (np_(got[1]) >= 0).all()


def test_search_pv_matches_jax(indexes):
    x, jidx, idx = indexes
    q = x[100:108]
    got = idx.search_pv(to_torch(q), 5, 8, to_torch(x))
    want = jidx.search_pv(to_jax(q), 5, 8, to_jax(x))
    assert_same_top_k(*got, *want, atol=1e-5)
    assert (np_(got[1])[:, 0] == np.arange(100, 108)).all()


def test_save_round_trips_through_jax(indexes, tmp_path):
    _, jidx, idx = indexes
    idx.save(tmp_path / "port.npz")
    back = jivfadc.IVFADCIndex.load(tmp_path / "port.npz")
    for name in ("cell_offsets", "codes_sorted", "row_ids", "assignments"):
        a = np.asarray(getattr(back, name))
        b = np.asarray(getattr(jidx, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = ivfadc_from_numpy(dict(np.load(tmp_path / "port.npz")),
                              device="cpu")
    assert torch.equal(again.codes_sorted, idx.codes_sorted)


def test_build_in_the_port(rng):
    x = to_torch(_clustered(rng, n=2000))
    g = torch.Generator().manual_seed(0)
    idx = IVFADCIndex.build(g, x, m=12, k=16, k_coarse=16, train_size=1500,
                            iters=4, init="kmeans++")
    assert idx.size == 2000 and int(idx.coarse.counts.sum()) == 2000
    assert sorted(np_(idx.row_ids).tolist()) == list(range(2000))
    _, ids = idx.search_pv(x[:32], 5, 10, x, w=3)
    assert (ids[:, 0] == torch.arange(32)).float().mean() >= 0.9
    grown = idx.add(x[:2])
    assert grown.size == 2002 and grown.tail_count == 2
