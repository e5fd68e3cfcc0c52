"""The port's row sharding (``parallel/sharding.py``), its row-1 IVFADC
probe and the sharded engine against the JAX package (CPU).

The port's mesh is eight ``"cpu"`` entries in a 4 × 2 grid (rows × q), the
JAX package's conftest's eight virtual CPU devices in the same grid. The
same numpy inputs from a seed go through each JAX sharded function and the
port's; widths as in ``tests/test_sharding.py``. Tolerances: distances
within rtol 1e-5 / atol 1e-5 and ids equal up to ties, where both sides
sum the same float32 terms (exact, ADC, in-set, post-verify, the join
rounds, the row-1 probe); 1e-4 where the row-1 probe meets the tiled
probe, whose IVFADC decomposition adds float32 terms in another order (as
``tests/test_ivfadc.py:125-140``); centroids of a Lloyd step 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu.models import ivfadc as jivfadc
from postgres_word2vec_tpu.models import ivpq as jivpq
from postgres_word2vec_tpu.ops import kmeans as jkmeans
from postgres_word2vec_tpu.ops import lut as jlut
from postgres_word2vec_tpu.parallel import sharding as jsharding

from postgres_word2vec_tpu_torch import Freddy
from postgres_word2vec_tpu_torch.models import exact, ivfadc, ivpq
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.ops import adc
from postgres_word2vec_tpu_torch.parallel import sharding

from test_torch_parity_util import (PQ_ENGINE, PROBE_ENGINE,
                                    assert_same_top_k, np_, save_jax_engine,
                                    to_jax, to_torch)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return jsharding.make_mesh(rows=4, q=2)


@pytest.fixture(scope="module")
def mesh():
    return sharding.make_mesh(["cpu"] * 8, rows=4, q=2)


def _same(got, want, *, rtol=1e-5, atol=1e-5):
    """(dists, ids) pairs agree: distances within rtol / atol, ids equal up
    to ties at that tolerance."""
    d_ref = np_(want[0])
    np.testing.assert_allclose(np_(got[0]), d_ref, rtol=rtol, atol=atol)
    fin = np.isfinite(d_ref)
    scale = np.abs(d_ref[fin]).max() if fin.any() else 0.0
    assert_same_top_k(got[0], got[1], want[0], want[1],
                      atol=atol + rtol * scale)


def _normal(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


def _unit(rng, n, d):
    v = _normal(rng, n, d)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _adc_case(rng):
    codes = rng.integers(0, 16, size=(800, 6)).astype(np.uint8)
    cb = rng.normal(size=(6, 16, 4)).astype(np.float32)
    q = _normal(rng, 4, 24)
    luts = np_(jlut.build_luts(jnp.asarray(q), jnp.asarray(cb)))
    return codes, luts


# -------------------------------------------------------------- the mesh

def test_mesh_shape_validation(monkeypatch):
    with pytest.raises(ValueError):
        sharding.make_mesh(["cpu"] * 8, rows=3, q=2)     # 6 ≠ 8 devices
    m = sharding.make_mesh(["cpu"] * 6, q=3)
    assert m.shape == {"rows": 2, "q": 3}
    assert m.row_devices(1) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()


def test_a_shard_is_one_copy_per_device(mesh, rng):
    x = to_torch(_normal(rng, 8, 3))
    sx = sharding.shard_rows(x, mesh)
    assert sx.shard_size == 2 and len(sx.parts[1]) == 1
    assert torch.equal(sx.local(1, 1), x[2:4])
    assert sx.local(1, 0).data_ptr() != x[2:4].data_ptr()   # a copy
    sc = sharding.shard_codes(x, mesh)
    assert sc.local(3).shape == (3, 2) and sc.local(3).is_contiguous()
    with pytest.raises(ValueError, match="pad first"):
        sharding.shard_rows(x[:7], mesh)
    xp, n = sharding.pad_rows(x[:7], 4)
    assert n == 7 and xp.shape == (8, 3) and not xp[7].any()


# ------------------------------------------------------- exact and ADC

def test_sharded_exact_matches_jax(mesh, jmesh, rng):
    v, q = _normal(rng, 800, 16), _normal(rng, 4, 16)
    got = sharding.sharded_exact_top_k(
        mesh, to_torch(q), sharding.shard_rows(to_torch(v), mesh), 9)
    want = jsharding.sharded_exact_top_k(
        jmesh, to_jax(q), jsharding.shard_rows(to_jax(v), jmesh), 9)
    _same(got, want)
    _same(got, exact.exact_top_k(to_torch(q), to_torch(v), 9))


def test_sharded_exact_with_padding_matches_jax(mesh, jmesh, rng):
    v, q = _normal(rng, 803, 16), _normal(rng, 2, 16)
    vp, n_valid = sharding.pad_rows(to_torch(v), 4)
    assert vp.shape[0] == 804 and n_valid == 803
    got = sharding.sharded_exact_top_k(
        mesh, to_torch(q), sharding.shard_rows(vp, mesh), 5,
        valid_rows=n_valid)
    jvp, _ = jsharding.pad_rows(to_jax(v), 4)
    want = jsharding.sharded_exact_top_k(
        jmesh, to_jax(q), jsharding.shard_rows(jvp, jmesh), 5,
        valid_rows=n_valid)
    _same(got, want)
    assert (np_(got[1]) < 803).all()


def test_sharded_adc_matches_jax(mesh, jmesh, rng):
    codes, luts = _adc_case(rng)
    got = sharding.sharded_adc_top_k(
        mesh, to_torch(luts), sharding.shard_codes(to_torch(codes), mesh), 7)
    want = jsharding.sharded_adc_top_k(
        jmesh, to_jax(luts), jsharding.shard_rows(to_jax(codes), jmesh), 7)
    _same(got, want)
    _same(got, adc.adc_top_k(to_torch(luts), to_torch(codes), 7))
    with pytest.raises(ValueError, match="shard_codes"):
        sharding.sharded_adc_top_k(
            mesh, to_torch(luts), sharding.shard_rows(to_torch(codes), mesh),
            7)


def test_sharded_adc_masks_rows_past_valid(mesh, rng):
    codes, luts = _adc_case(rng)
    got = sharding.sharded_adc_top_k(
        mesh, to_torch(luts), sharding.shard_codes(to_torch(codes), mesh),
        7, valid_rows=555)
    _same(got, adc.adc_top_k(to_torch(luts), to_torch(codes[:555]), 7))


# ----------------------------------------------------------------- k-means

def test_sharded_kmeans_step_matches_jax(mesh, jmesh, rng):
    x = _normal(rng, 400, 8)
    c0 = x[:5].copy()
    c, counts = sharding.sharded_kmeans_step(
        mesh, sharding.shard_rows(to_torch(x), mesh), to_torch(c0))
    jc, jcounts = jsharding.sharded_kmeans_step(
        jmesh, jsharding.shard_rows(to_jax(x), jmesh), to_jax(c0))
    c1, counts1 = jkmeans._lloyd_step(to_jax(x), to_jax(c0))
    for want_c, want_n in ((jc, jcounts), (c1, counts1)):
        np.testing.assert_allclose(np_(c), np_(want_c), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(np_(counts), np_(want_n))
    assert counts.dtype == torch.int32


def test_sharded_kmeans_matches_single_device_lloyd(mesh, rng):
    """The port's draw of the first centroids (k distinct rows from a
    ``torch.Generator``; JAX's ``jax.random.choice`` draw cannot be
    reproduced), then eight sharded steps, against eight single-device
    Lloyd steps of the JAX package from the same rows."""
    centers = np.array([[5, 0, 0, 0], [-5, 0, 0, 0], [0, 5, 0, 0]],
                       np.float32)
    x = np.concatenate([c + rng.normal(scale=0.2, size=(80, 4))
                        for c in centers]).astype(np.float32)
    c, counts = sharding.sharded_kmeans(
        mesh, torch.Generator().manual_seed(0),
        sharding.shard_rows(to_torch(x), mesh), 3, iters=8)
    init = torch.randperm(240, generator=torch.Generator().manual_seed(0))
    cj = to_jax(x[init[:3].numpy()])
    for _ in range(8):
        cj, cnt_j = jkmeans._lloyd_step(to_jax(x), cj)
    np.testing.assert_allclose(np_(c), np_(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np_(counts), np_(cnt_j))
    assert len(set(init[:3].tolist())) == 3 and int(counts.sum()) == 240


# ------------------------------------------------------------------ in-set

def test_sharded_exact_in_matches_jax(mesh, jmesh, rng):
    v, q = _normal(rng, 800, 16), _normal(rng, 4, 16)
    tids = rng.choice(800, size=120, replace=False).astype(np.int32)
    mask = np.ones(120, bool)
    mask[-7:] = False
    got = sharding.sharded_exact_in(
        mesh, to_torch(q), sharding.shard_rows(to_torch(v), mesh),
        to_torch(tids), to_torch(mask), 9)
    want = jsharding.sharded_exact_in(
        jmesh, to_jax(q), jsharding.shard_rows(to_jax(v), jmesh),
        to_jax(tids), to_jax(mask), 9)
    _same(got, want)
    _same(got, exact.exact_top_k_in(to_torch(q), to_torch(v),
                                    to_torch(tids), to_torch(mask), 9))


def test_sharded_exact_in_pads_past_the_targets(mesh, jmesh, rng):
    v, q = _normal(rng, 800, 16), _normal(rng, 2, 16)
    tids = np.array([5, 300, 799], np.int32)
    mask = np.array([1, 1, 0], bool)
    got = sharding.sharded_exact_in(
        mesh, to_torch(q), sharding.shard_rows(to_torch(v), mesh),
        to_torch(tids), to_torch(mask), 4)
    want = jsharding.sharded_exact_in(
        jmesh, to_jax(q), jsharding.shard_rows(to_jax(v), jmesh),
        to_jax(tids), to_jax(mask), 4)
    _same(got, want)
    assert (np_(got[1])[:, 2:] == -1).all() and got[1].dtype == torch.int64


def test_sharded_adc_in_matches_jax(mesh, jmesh, rng):
    codes, luts = _adc_case(rng)
    tids = rng.choice(800, size=90, replace=False).astype(np.int32)
    mask = np.ones(90, bool)
    mask[-5:] = False
    got = sharding.sharded_adc_in(
        mesh, to_torch(luts), sharding.shard_codes(to_torch(codes), mesh),
        to_torch(tids), to_torch(mask), 7)
    want = jsharding.sharded_adc_in(
        jmesh, to_jax(luts), jsharding.shard_rows(to_jax(codes), jmesh),
        to_jax(tids), to_jax(mask), 7)
    _same(got, want)


def test_sharded_post_verify_matches_jax(mesh, jmesh, rng):
    v, q = _normal(rng, 800, 16), _normal(rng, 4, 16)
    ids = rng.choice(800, size=(4, 20), replace=True).astype(np.int32)
    ids[0, 3] = -1                       # an invalid slot stays excluded
    dists = np.abs(rng.normal(size=(4, 20))).astype(np.float32)
    got = sharding.sharded_post_verify(
        mesh, to_torch(q), to_torch(dists), to_torch(ids),
        sharding.shard_rows(to_torch(v), mesh), 5)
    want = jsharding.sharded_post_verify(
        jmesh, to_jax(q), to_jax(dists), to_jax(ids),
        jsharding.shard_rows(to_jax(v), jmesh), 5)
    _same(got, want)
    _same(got, adc.post_verify(to_torch(q), to_torch(ids), to_torch(dists),
                               to_torch(v), 5))


# ------------------------------------------------------------------ IVFADC

@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    """(vectors, JAX IVFADC index over 16 cells, the port's from its
    file) — ``tests/test_sharding.py``'s build."""
    v = _unit(np.random.default_rng(0), 2400, 16)
    jidx = jivfadc.IVFADCIndex.build(jax.random.PRNGKey(4), to_jax(v), m=4,
                                     k=8, k_coarse=16, train_size=None,
                                     iters=5)
    path = tmp_path_factory.mktemp("ivf") / "ivf.npz"
    jidx.save(path)
    return v, jidx, IVFADCIndex.load(path, device="cpu")


@pytest.mark.parametrize("w", [1, 3])
def test_ivfadc_probe_matches_jax_and_the_tiled_probe(ivf_pair, w):
    v, jidx, idx = ivf_pair
    q = v[:8]
    got = ivfadc._ivfadc_probe(
        to_torch(q), idx.coarse.centroids, idx.codebook.centroids,
        idx.cell_offsets, idx.codes_sorted, idx.row_ids, w, 5, idx.list_cap)
    want = jivfadc._ivfadc_probe(
        to_jax(q), jidx.coarse.centroids, jidx.codebook.centroids,
        jidx.cell_offsets, jidx.codes_sorted, jidx.row_ids, w=w, k=5,
        list_cap=jidx.list_cap)
    _same(got[:2], want[:2])
    np.testing.assert_array_equal(np_(got[2]), np_(want[2]))
    _same(got[:2], idx.search(to_torch(q), 5, w=w), rtol=1e-4, atol=1e-4)


def test_ivfadc_probe_chunks_large_batches(ivf_pair, monkeypatch):
    v, _, idx = ivf_pair
    args = (to_torch(v[:9]), idx.coarse.centroids, idx.codebook.centroids,
            idx.cell_offsets, idx.codes_sorted, idx.row_ids, 3, 5,
            idx.list_cap)
    whole = ivfadc._ivfadc_probe(*args)
    monkeypatch.setattr(ivfadc, "_PROBE_ELEMS", 3 * idx.list_cap * 4 * 2)
    chunked = ivfadc._ivfadc_probe(*args)
    _same(chunked[:2], whole[:2])
    assert torch.equal(chunked[2], whole[2])


def test_sharded_ivfadc_probe_matches_jax(ivf_pair, mesh, jmesh):
    v, jidx, idx = ivf_pair
    q = v[:8]
    bundle = sharding.shard_ivfadc(idx, mesh)
    assert bundle["list_cap"] == jidx.list_cap
    got = sharding.sharded_ivfadc_probe(mesh, to_torch(q), bundle, w=3, k=5)
    want = jsharding.sharded_ivfadc_probe(
        jmesh, to_jax(q), jsharding.shard_ivfadc(jidx, jmesh), w=3, k=5)
    _same(got, want)
    _same(got, idx.search(to_torch(q), 5, w=3), rtol=1e-4, atol=1e-4)


def test_sharded_ivfadc_adaptive_fills_k(mesh, jmesh, tmp_path):
    """k_coarse = 256 leaves ~9 rows a cell, so w = 1 cannot fill k = 12:
    the escalation runs, fills every query, and agrees with the JAX
    package's."""
    v = _unit(np.random.default_rng(0), 2400, 16)
    jidx = jivfadc.IVFADCIndex.build(jax.random.PRNGKey(4), to_jax(v), m=4,
                                     k=8, k_coarse=256, train_size=None,
                                     iters=5)
    jidx.save(tmp_path / "ivf.npz")
    idx = IVFADCIndex.load(tmp_path / "ivf.npz", device="cpu")
    q = to_torch(v[:8])
    bundle = sharding.shard_ivfadc(idx, mesh)
    _, first = sharding.sharded_ivfadc_probe(mesh, q, bundle, w=1, k=12)
    assert ((np_(first) >= 0).sum(-1) < 12).any()
    got = sharding.sharded_ivfadc_adaptive(mesh, q, bundle, k=12, w=1,
                                           max_rounds=6)
    assert (np_(got[1]) >= 0).all()
    assert (np_(got[1])[:, 0] == np.arange(8)).all()
    want = jsharding.sharded_ivfadc_adaptive(
        jmesh, to_jax(v[:8]), jsharding.shard_ivfadc(jidx, jmesh), k=12, w=1,
        max_rounds=6)
    _same(got, want)


# --------------------------------------------------------------- IVPQ join

@pytest.fixture(scope="module")
def ivpq_pair(tmp_path_factory):
    """(vectors, JAX IVPQ index 4×8 over 4² cells, the port's from its
    file, uniform statistics) — ``tests/test_sharding.py``'s build."""
    v = _unit(np.random.default_rng(0), 2000, 16)
    jidx = jivpq.IVPQIndex.build(jax.random.PRNGKey(0), to_jax(v), m=4, k=8,
                                 k_coarse=4, train_size=None, iters=5)
    path = tmp_path_factory.mktemp("ivpq") / "ivpq.npz"
    jidx.save(path)
    idx = IVPQIndex.load(path, device="cpu")
    return v, jidx, idx, ivpq.uniform_statistics(idx.coarse.cell_counts)


@pytest.mark.parametrize("method,offset", [(0, 0), (2, 1000), (1, 500)])
def test_sharded_join_round_matches_jax(ivpq_pair, mesh, jmesh, method,
                                        offset):
    """Method 2 with targets offset from 0 re-ranks against shard-local
    rows read by position, not by global id (the JAX package's round-1
    fault); every returned distance is the true one."""
    v, jidx, idx, stats = ivpq_pair
    tids = np.arange(offset, offset + 800, dtype=np.int32)
    q = v[:8]
    t = to_torch(tids).long()
    targets = sharding.shard_join_targets(
        idx, t, torch.ones(800, dtype=torch.bool), to_torch(v[tids]), mesh)
    got = sharding.sharded_ivpq_join_round(
        mesh, to_torch(q), idx.coarse.centroids, idx.codebook.centroids,
        statistics=stats, k=5, alpha=50, pvf=10, method=method,
        confidence=0.8, **targets)
    jt = jnp.asarray(tids)
    want = jsharding.sharded_ivpq_join_round(
        jmesh, to_jax(q), jidx.coarse.centroids, jidx.codebook.centroids,
        jnp.take(jidx.codes, jt, axis=0), jnp.take(jidx.cell_of, jt), jt,
        jnp.ones((800,), bool), to_jax(np_(stats)), to_jax(v[tids]), k=5,
        alpha=50, pvf=10, method=method, confidence=0.8)
    _same(got[:2], want[:2])
    np.testing.assert_array_equal(np_(got[2]), np_(want[2]))
    ids, d = np_(got[1]), np_(got[0])
    for b in range(8 if method else 0):       # exact distances: methods 1, 2
        for j in np.flatnonzero(ids[b] >= 0):
            true = float(np.sum((q[b] - v[ids[b, j]]) ** 2))
            np.testing.assert_allclose(d[b, j], true, rtol=1e-4, atol=1e-5)
    if method != 2:               # one round over all 800: same as sharded
        one = ivpq._ivpq_round(
            to_torch(q), idx.coarse.centroids, idx.codebook.centroids,
            idx.codes[t].t().contiguous(), idx.cell_of[t], t,
            torch.ones(800, dtype=torch.bool), stats, to_torch(v), 5, 50,
            10, method, 0.8, False, False)
        _same(got[:2], one[:2])
        np.testing.assert_array_equal(np_(got[2]), np_(one[2]))


@pytest.mark.parametrize("method", [0, 2, 1])
def test_sharded_budget_join_matches_dense_and_jax(ivpq_pair, mesh, jmesh,
                                                   method):
    v, jidx, idx, stats = ivpq_pair
    tids = np.arange(500, 1300, dtype=np.int32)
    q = v[:8]
    kw = dict(vectors=to_torch(v), statistics=stats, alpha=50, pvf=10,
              method=method, confidence=0.8)
    dense = sharding.sharded_ivpq_join(mesh, idx, to_torch(q), 5,
                                       to_torch(tids), impl="dense", **kw)
    budget = sharding.sharded_ivpq_join(mesh, idx, to_torch(q), 5,
                                        to_torch(tids), impl="budget", **kw)
    # method 1's budget round scores the bf16 rows of its tiles (K9/K10's
    # contract, the JAX package's too); the dense round the float32 rows
    _same(budget, dense, rtol=1e-4, atol=1e-2 if method == 1 else 1e-5)
    jkw = dict(vectors=to_jax(v), statistics=to_jax(np_(stats)), alpha=50,
               pvf=10, method=method, confidence=0.8)
    for impl, got in (("dense", dense), ("budget", budget)):
        want = jsharding.sharded_ivpq_join(jmesh, jidx, to_jax(q), 5,
                                           to_jax(tids), impl=impl, **jkw)
        _same(got, want)


def test_sharded_join_needs_vectors_for_exact_methods(ivpq_pair, mesh):
    v, _, idx, _ = ivpq_pair
    with pytest.raises(ValueError, match="raw vectors"):
        sharding.sharded_ivpq_join(mesh, idx, to_torch(v[:2]), 5,
                                   torch.arange(100), method=1)


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def engines(tmp_path_factory, jmesh, mesh):
    """Per saved JAX engine: (JAX engine in mesh mode, the port's engine
    loaded with ``mesh=``, the port's unsharded engine)."""
    out = {}
    for name, spec in (("pq", PQ_ENGINE), ("probe", PROBE_ENGINE)):
        _, path = save_jax_engine(tmp_path_factory.mktemp(name), **spec)
        out[name] = (JFreddy.load(path, mesh=jmesh),
                     Freddy.load(path, device="cpu", mesh=mesh),
                     Freddy.load(path, device="cpu"))
    return out


def _queries(port, b):
    return port.store.vectors_norm[:b]


@pytest.mark.parametrize("b", [8, 7])
@pytest.mark.parametrize("family", ["k_nearest_neighbour",
                                    "k_nearest_neighbour_pq",
                                    "k_nearest_neighbour_pq_pv"])
def test_engine_mesh_knn_families_match_jax(engines, family, b):
    jeng, port, plain = engines["pq"]
    for e in (jeng, port, plain):
        e.set_knn_function(family)
    q = _queries(port, b)
    got = port.knn_matrix(q, 6)
    _same(got, jeng.knn_matrix(to_jax(np_(q)), 6))
    _same(got, plain.knn_matrix(q, 6))
    assert got[0].shape == (b, 6)


@pytest.mark.parametrize("family", ["k_nearest_neighbour_ivfadc",
                                    "k_nearest_neighbour_ivfadc_pv"])
def test_engine_mesh_ivfadc_families_match_jax(engines, family):
    jeng, port, plain = engines["probe"]
    for e in (jeng, port, plain):
        e.set_knn_function(family)
    q = _queries(port, 8)
    got = port.knn_matrix(q, 5)
    _same(got, jeng.knn_matrix(to_jax(np_(q)), 5))
    _same(got, plain.knn_matrix(q, 5), rtol=1e-4, atol=1e-4)
    rows = port.knn_batch(["w1", "w2", "w3"], 4)
    want = plain.knn_batch(["w1", "w2", "w3"], 4)
    assert len(rows) == 12
    assert {(a, w) for a, w, _ in rows} == {(a, w) for a, w, _ in want}


@pytest.mark.parametrize("impl", ["knn_in_exact", "knn_in_pq"])
def test_engine_mesh_in_set_matches_jax(engines, impl):
    jeng, port, plain = engines["pq"]
    for e in (jeng, port, plain):
        e.set_knn_in_function(impl)
    tids, tmask = port._target_ids([f"w{i}" for i in range(0, 900, 3)])
    q = _queries(port, 8)
    got = port.knn_in_matrix(q, 5, tids, tmask)
    _same(got, jeng.knn_in_matrix(to_jax(np_(q)), 5, to_jax(np_(tids)),
                                  to_jax(np_(tmask))))
    _same(got, plain.knn_in_matrix(q, 5, tids, tmask))
    words = ["w1", "w2", "w4"]
    targets = [f"w{i}" for i in range(300)]
    join = ("knn_search_in_batch" if impl == "knn_in_exact"
            else "knn_in_pq_batch")
    got_rows = getattr(port, join)(words, 3, targets)
    want_rows = getattr(plain, join)(words, 3, targets)
    assert {(a, w) for a, w, _ in got_rows} == {
        (a, w) for a, w, _ in want_rows}


@pytest.mark.parametrize("method", [0, 1, 2])
def test_engine_mesh_join_matches_jax(engines, method):
    jeng, port, plain = engines["probe"]
    for e in (jeng, port, plain):
        e.set_method_flag(method)
        e.set_alpha(50)
    words = [f"w{i}" for i in range(3000, 3008)]
    targets = [f"w{i}" for i in range(1000)]
    got = port.knn_in_ivpq_batch(words, 5, targets)
    want = jeng.knn_in_ivpq_batch(words, 5, targets)
    unsharded = plain.knn_in_ivpq_batch(words, 5, targets)
    for other in (want, unsharded) if method != 2 else (want,):
        assert [(a, w) for a, w, _ in got] == [(a, w) for a, w, _ in other]
        np.testing.assert_allclose([s for *_, s in got],
                                   [s for *_, s in other], atol=1e-5)
    ph = port.prepare_targets(targets, name="t1000")
    assert port.knn_in_ivpq_batch(words, 5, "t1000") == got
    assert ph.size == 1000


def test_engine_mesh_pv_shortlist_warns(engines):
    _, port, plain = engines["pq"]
    with pytest.warns(UserWarning, match="no effect on mesh-sharded"):
        port.set_pv_shortlist("exact")
    port.set_pv_shortlist("auto")
    plain.set_pv_shortlist("exact")
    plain.set_pv_shortlist("auto")


def test_engine_mesh_insert_reshards_like_jax(tmp_path, jmesh, mesh):
    """``insert_batch`` under a mesh re-shards: the new term is found
    through the sharded paths, as in the JAX engine."""
    _, path = save_jax_engine(tmp_path, **PQ_ENGINE)
    jeng = JFreddy.load(path, mesh=jmesh)
    port = Freddy.load(path, device="cpu", mesh=mesh)
    for e in (jeng, port):
        assert e.insert_batch(["w3 w7", "w3"]) == 1
    got = port.knn("w3 w7", 4)
    assert got[0][0] == "w3 w7"
    assert [w for w, _ in got] == [w for w, _ in jeng.knn("w3 w7", 4)]
    assert port._shard["valid"] == port.store.size == 4097
    rows = port.k_nearest_neighbour_pq("w3 w7", 4)
    assert {w for w, _ in rows} == {
        w for w, _ in jeng.k_nearest_neighbour_pq("w3 w7", 4)}
