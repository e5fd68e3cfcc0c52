"""Helpers for holding the PyTorch port to the JAX package on the same
numpy inputs (imported by tests/test_torch_*.py): conversions, small
clustered data, the small JAX engines the engine tests load in the port
(:func:`save_jax_engine`), and tests of the helpers' own tie rules."""

import numpy as np
import torch


def to_jax(a):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a))


def to_torch(a):
    return torch.from_numpy(np.array(a))


def np_(x):
    """numpy view of a torch tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clustered(rng, n=4096, d=48, centers=64):
    """``n`` unit rows around ``centers`` Gaussian centres, float32."""
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.6 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def save_jax_engine(path, *, data_seed, n=4096, statistics=None,
                    **build_kw):
    """Build a small JAX engine on the CPU over ``clustered`` rows of
    ``data_seed`` (words ``w0``…), optionally with an active statistics
    table ``statistics = (name, words)``, save it under ``path`` →
    (engine, path)."""
    from postgres_word2vec_tpu import Freddy as JFreddy
    from postgres_word2vec_tpu import VectorStore as JStore

    rng = np.random.default_rng(data_seed)
    words = [f"w{i}" for i in range(n)]
    eng = JFreddy.build(JStore.from_arrays(words, clustered(rng, n=n)),
                        seed=0, train_size=None, **build_kw)
    if statistics is not None:
        eng.create_statistics(*statistics)
    eng.save(path)
    return eng, path


#: The small JAX engines the port's engine tests load
#: (tests/test_torch_models.py, tests/test_torch_engine.py): the OPQ PQ
#: family alone, and IVFADC (24 cells) with IVPQ (2 × 8 coarse centroids)
#: and an active statistics table.
PQ_ENGINE = dict(data_seed=5, with_ivfadc=False, with_ivpq=False, pq_m=12,
                 pq_k=16, iters=5, opq_iters=2)
PROBE_ENGINE = dict(data_seed=6, with_pq=False, ivfadc_m=12, ivfadc_k=16,
                    k_coarse=24, ivpq_m=12, ivpq_k=16, ivpq_k_coarse=8,
                    iters=4, statistics=("dom", [f"w{i}"
                                                 for i in range(2000)]))

#: all three families, no OPQ rotation (a FREDDY dump cannot hold one, and
#: the JAX engine's PQ grouping builds unrotated LUTs)
FULL_ENGINE = dict(data_seed=7, n=3000, pq_m=12, pq_k=16, opq_iters=0,
                   ivfadc_m=12, ivfadc_k=16, k_coarse=24, ivpq_m=12,
                   ivpq_k=16, ivpq_k_coarse=8, iters=4)


def assert_same_top_k(d_port, i_port, d_ref, i_ref, *, atol):
    """Top-k results agree up to ties: distances row by row within
    ``atol``, and every id that is strictly inside one side's top-k (its
    distance below the k-th by more than ``atol``) is in the other's."""
    d_port, i_port = np_(d_port), np_(i_port).astype(np.int64)
    d_ref, i_ref = np_(d_ref), np_(i_ref).astype(np.int64)
    assert d_port.shape == d_ref.shape and i_port.shape == i_ref.shape
    np.testing.assert_allclose(d_port, d_ref, atol=atol, rtol=0)
    for b in range(d_port.shape[0]):
        fin = np.isfinite(d_ref[b])
        kth = d_ref[b][fin].max() if fin.any() else np.inf
        for ds, ids, other in ((d_port[b], i_port[b], i_ref[b]),
                               (d_ref[b], i_ref[b], i_port[b])):
            strict = ids[ds < kth - atol]
            assert set(strict.tolist()) <= set(other.tolist()), (
                b, sorted(strict.tolist()), sorted(other.tolist()))


def assert_binned_contract(mins, ids, ref_mins, dense, *, block_n, bins,
                           atol, mins_rtol=0.0):
    """A binned scan's output against a reference's bin mins and the dense
    scores: +inf slots match, mins agree within ``atol`` (+ ``mins_rtol``
    relative), every id lies in its own bin and points at a row whose
    dense score is within ``atol`` (+ relative) of the bin min."""
    mins, ids, ref_mins, dense = (np_(mins), np_(ids).astype(np.int64),
                                  np_(ref_mins), np_(dense))
    fin = np.isfinite(ref_mins)
    np.testing.assert_array_equal(np.isfinite(mins), fin)
    tol = atol + mins_rtol * np.abs(ref_mins[fin])
    assert np.all(np.abs(mins[fin] - ref_mins[fin]) <= tol)
    col = np.arange(mins.shape[1])
    assert np.all(ids // block_n == (col // bins)[None])
    assert np.all((ids % block_n) % bins == (col % bins)[None])
    n = dense.shape[1]
    assert np.all(ids[fin] < n)
    at = np.take_along_axis(dense, np.minimum(ids, n - 1), axis=1)
    gap_tol = atol + mins_rtol * np.abs(mins[fin])
    assert np.all(np.abs(at[fin] - mins[fin]) <= gap_tol)


def test_same_top_k_accepts_swapped_ties():
    d = np.array([[0.1, 0.2, 0.2]], np.float32)
    assert_same_top_k(d, np.array([[4, 7, 9]]), d, np.array([[4, 9, 7]]),
                      atol=1e-6)
    # a tie at the k-th place may pick either row
    assert_same_top_k(d, np.array([[4, 7, 9]]), d, np.array([[4, 7, 8]]),
                      atol=1e-6)


def test_same_top_k_rejects_a_wrong_id():
    d = np.array([[0.1, 0.2, 0.3]], np.float32)
    try:
        assert_same_top_k(d, np.array([[4, 7, 9]]), d,
                          np.array([[5, 7, 9]]), atol=1e-6)
    except AssertionError:
        return
    raise AssertionError("a differing strict top-k id was accepted")
