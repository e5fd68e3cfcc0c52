"""Anisotropic refinement in the port against the JAX package (CPU).

The same inputs go through JAX's ``anisotropic_refine`` and the port's
(centroids within 1e-4: the normal equations are solved in another order
of float32 sums) and through ``encode_subspaces(aniso_eta=)`` (the same
codes but where two codewords tie within 1e-5 under the anisotropic
metric). ``PQIndex.build(aniso_eta=)`` and ``Freddy.build(aniso_eta=)``
run, and a JAX engine built with ``aniso_eta`` answers alike after
``Freddy.load`` (distances within 1e-5, ids equal up to ties)."""

import jax
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu import VectorStore as JStore
from postgres_word2vec_tpu.ops import kmeans as jkmeans

from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import kmeans

from test_torch_parity_util import (assert_same_rows, assert_same_top_k,
                                    clustered, np_, to_jax, to_torch)


def _aniso_dist(x, cb, eta):
    """(n, m, k) anisotropic distances of ``x`` (n, m·dsub) to ``cb``."""
    m, k, dsub = cb.shape
    xs = x.reshape(len(x), m, 1, dsub).astype(np.float64)
    r = xs - cb[None].astype(np.float64)
    nx = np.linalg.norm(xs, axis=-1)
    par = (r * xs).sum(-1) / np.maximum(nx, 1e-12)
    return (r * r).sum(-1) + (eta - 1.0) * par ** 2


@pytest.mark.parametrize("eta", [2.0, 4.0])
def test_anisotropic_refine_matches_jax(rng, eta):
    m, n, dsub, k = 3, 600, 5, 12
    x = clustered(rng, n=n, d=m * dsub, centers=20)
    x_sub = np.ascontiguousarray(x.reshape(n, m, dsub).transpose(1, 0, 2))
    c0 = x_sub[:, rng.choice(n, k, replace=False)]
    got = kmeans.anisotropic_refine(to_torch(x_sub), to_torch(c0), eta,
                                    iters=4)
    want = jkmeans.anisotropic_refine(to_jax(x_sub), to_jax(c0), eta,
                                      iters=4)
    assert got.shape == (m, k, dsub)
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("eta", [1.0, 3.0])
def test_encode_subspaces_aniso_matches_jax(rng, eta):
    n, m, dsub, k = 900, 4, 6, 32
    x = rng.normal(size=(n, m * dsub)).astype(np.float32)
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    got = np_(kmeans.encode_subspaces(to_torch(x), to_torch(cb),
                                      chunk_size=256, aniso_eta=eta))
    want = np_(jkmeans.encode_subspaces(to_jax(x), to_jax(cb),
                                        chunk_size=256, aniso_eta=eta))
    dist = _aniso_dist(x, cb, eta)
    rows, subs = np.nonzero(got != want)
    for r, j in zip(rows, subs):          # a differing code is a tie
        assert abs(dist[r, j, got[r, j]] - dist[r, j, want[r, j]]) <= 1e-5
    assert len(rows) <= 2
    # the codes are the anisotropic argmin (plain L2 would differ)
    assert (got == dist.argmin(-1)).mean() > 0.99


@pytest.mark.parametrize("opq_iters", [0, 2])
def test_pq_build_with_aniso_eta(rng, opq_iters):
    x = torch.from_numpy(clustered(rng, n=1500, d=24, centers=30))
    common = dict(m=6, k=16, train_size=800, iters=4, opq_iters=opq_iters)
    plain = PQIndex.build(torch.Generator().manual_seed(0), x, **common)
    aniso = PQIndex.build(torch.Generator().manual_seed(0), x,
                          aniso_eta=2.0, **common)
    assert aniso.codes.shape == (1500, 6) and aniso.codes.dtype == torch.uint8
    assert not torch.equal(aniso.codebook.centroids, plain.codebook.centroids)
    # the table is encoded under the anisotropic metric, with the rotation
    np.testing.assert_array_equal(
        np_(aniso.codes), np_(kmeans.encode_subspaces(
            x, aniso.codebook.centroids, rotation=aniso.rotation,
            aniso_eta=2.0)))
    assert int(aniso.codebook.counts.sum()) == 1500 * 6
    d, i = aniso.search(x[:8], 5)
    assert (np_(i)[:, :5] == np.arange(8)[:, None]).any(1).mean() >= 0.75


def test_freddy_build_passes_aniso_eta(rng):
    x = clustered(rng, n=800, d=24, centers=20)
    store = VectorStore.from_arrays([f"w{i}" for i in range(800)], x,
                                    device="cpu")
    kw = dict(seed=0, pq_m=6, pq_k=16, opq_iters=0, with_ivfadc=False,
              with_ivpq=False, train_size=None, iters=4)
    eng = Freddy.build(store, aniso_eta=2.0, **kw)
    base = Freddy.build(store, **kw)
    assert not torch.equal(eng.pq.codebook.centroids,
                           base.pq.codebook.centroids)
    eng.set_knn_function("k_nearest_neighbour_pq_pv")
    assert eng.knn("w5", 3)[0][0] == "w5"


def test_jax_aniso_engine_answers_alike_after_load(rng, tmp_path):
    x = clustered(rng, n=1000, d=24, centers=20)
    words = [f"w{i}" for i in range(1000)]
    jeng = JFreddy.build(JStore.from_arrays(words, x), seed=0, pq_m=6,
                         pq_k=16, opq_iters=0, aniso_eta=3.0,
                         with_ivfadc=False, with_ivpq=False,
                         train_size=None, iters=4)
    jeng.save(tmp_path)
    eng = Freddy.load(tmp_path, device="cpu")
    np.testing.assert_array_equal(np_(eng.pq.codes), np_(jeng.pq.codes))
    q = x[:32]
    d, i = eng.pq.search(to_torch(q), 5)
    jd, ji = jeng.pq.search(jax.numpy.asarray(q), 5)
    assert_same_top_k(d, i, jd, ji, atol=1e-5)
    for fam in ("k_nearest_neighbour_pq", "k_nearest_neighbour_pq_pv"):
        eng.set_knn_function(fam)
        jeng.set_knn_function(fam)
        got, want = eng.knn("w9", 4), jeng.knn("w9", 4)
        assert_same_rows([list(r) for r in got], [list(r) for r in want],
                         1e-5, fam)
