"""The port's online insert against the JAX package (CPU): the running-mean
codebook update, every index's ``add`` (PQ, IVFADC with its insert tail,
flush and splice, IVPQ), ``ExactIndex.extended``, the store's
``extend`` / ``extend_inplace`` and the engine's ``insert_batch``, with
engines carried across in both directions after an insert.

Tolerances: centroids after the running-mean update 1e-5 (float32 updates
in the same order; the squared distances that pick a code are summed in
another order, so a code could flip on a near-tie, which these seeds do
not hit); codes, cells, counts and CSR fields equal; IVFADC distances
1e-4 (the IVFADC decomposition adds float32 terms in another order);
engine similarities 1e-5 (exact or post-verified families), ids up to
ties."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu import VectorStore as JStore
from postgres_word2vec_tpu.models import exact as jexact
from postgres_word2vec_tpu.models import ivfadc as jivfadc
from postgres_word2vec_tpu.models import ivpq as jivpq
from postgres_word2vec_tpu.models import pq as jpq

from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.pq import (PQCodebook,
                                                   online_codebook_update)
from postgres_word2vec_tpu_torch.utils.convert import (ivpq_from_numpy,
                                                       pq_from_numpy)

from test_torch_parity_util import assert_same_top_k, np_, to_jax, to_torch

N, D = 3000, 48


def _clustered(rng, n=N, d=D, centers=64):
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.6 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _new_rows(seed, n, d=D):
    x = np.random.default_rng(seed).normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_codebook(got: PQCodebook, want) -> None:
    np.testing.assert_allclose(np_(got.centroids), np.asarray(want.centroids),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np_(got.counts), np.asarray(want.counts))


# --------------------------------------------------- running-mean update

def test_online_codebook_update_matches_jax(rng):
    m, k, dsub = 6, 16, 8
    cents = rng.normal(size=(m, k, dsub)).astype(np.float32)
    counts = rng.integers(1, 50, size=(m, k)).astype(np.int32)
    x = rng.normal(size=(40, m * dsub)).astype(np.float32)
    cb = PQCodebook(to_torch(cents), to_torch(counts))
    got, codes = online_codebook_update(cb, to_torch(x))
    want, jcodes = jpq.online_codebook_update(
        jpq.PQCodebook(to_jax(cents), to_jax(counts)), to_jax(x))
    _same_codebook(got, want)
    np.testing.assert_array_equal(np_(codes), np.asarray(jcodes))
    # sequential: the caller's codebook is untouched, and a batch equals
    # the same rows added one at a time
    np.testing.assert_array_equal(np_(cb.centroids), cents)
    step = cb
    for row in to_torch(x):
        step, _ = online_codebook_update(step, row[None])
    torch.testing.assert_close(step.centroids, got.centroids, atol=0, rtol=0)


# ---------------------------------------------------------------- PQ, IVPQ

def test_pq_add_matches_jax():
    x = _clustered(np.random.default_rng(41))
    jidx = jpq.PQIndex.build(jax.random.PRNGKey(4), to_jax(x), m=12, k=16,
                             train_size=None, iters=4, opq_iters=2)
    idx = pq_from_numpy({"centroids": np.asarray(jidx.codebook.centroids),
                         "counts": np.asarray(jidx.codebook.counts),
                         "codes": np.asarray(jidx.codes),
                         "rotation": np.asarray(jidx.rotation)}, device="cpu")
    new = _new_rows(1, 25)
    idx.transposed_codes()                       # a cached layout to drop
    got, want = idx.add(to_torch(new)), jidx.add(to_jax(new))
    _same_codebook(got.codebook, want.codebook)
    np.testing.assert_array_equal(np_(got.codes), np.asarray(want.codes))
    assert got.codes.dtype == torch.uint8 and got.rotation is idx.rotation
    # the kernel modes see the new rows (the transposed codes are rebuilt)
    assert got.transposed_codes().shape == (12, N + 25)
    for impl in ("kernel", "kernel_int8"):
        _, ids = got.search_pv(to_torch(new), 1, 20, to_torch(
            np.concatenate([x, new])), impl=impl, shortlist="exact")
        assert (np_(ids)[:, 0] == np.arange(N, N + 25)).all()


def test_ivpq_add_matches_jax():
    x = _clustered(np.random.default_rng(42))
    jidx = jivpq.IVPQIndex.build(jax.random.PRNGKey(5), to_jax(x), m=12,
                                 k=16, k_coarse=8, coarse_positions=2,
                                 train_size=None, iters=4)
    idx = ivpq_from_numpy({
        "coarse_centroids": np.asarray(jidx.coarse.centroids),
        "cell_counts": np.asarray(jidx.coarse.cell_counts),
        "centroids": np.asarray(jidx.codebook.centroids),
        "counts": np.asarray(jidx.codebook.counts),
        "codes": np.asarray(jidx.codes), "cell_of": np.asarray(jidx.cell_of)},
        device="cpu")
    new = _new_rows(2, 30)
    got, want = idx.add(to_torch(new)), jidx.add(to_jax(new))
    _same_codebook(got.codebook, want.codebook)
    np.testing.assert_array_equal(np_(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(np_(got.cell_of), np.asarray(want.cell_of))
    np.testing.assert_array_equal(np_(got.coarse.cell_counts),
                                  np.asarray(want.coarse.cell_counts))
    assert got.size == N + 30 and got.cell_of.dtype == torch.int64


# --------------------------------------------------------------- exact

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_extended_matches_fresh_build(dtype):
    """Mirrors the JAX package's tests/test_exact.py:140-175: O(batch)
    ``extended`` searches like a fresh build on the concatenated table,
    capacity rows never leak, capacity is reused, and ``search_in`` reads
    the aliased full table; the same holds against the JAX package."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(500, 32)).astype(np.float32)
    extra = rng.normal(size=(37, 32)).astype(np.float32)
    full = to_torch(np.concatenate([base, extra], 0))
    idx = ExactIndex(to_torch(base), dtype)
    idx2 = idx.extended(full, to_torch(extra))
    fresh = ExactIndex(full, dtype)
    q = to_torch(rng.normal(size=(6, 32)).astype(np.float32))
    d_e, i_e = idx2.search(q, 7)
    d_f, i_f = fresh.search(q, 7)
    assert torch.equal(i_e, i_f)
    torch.testing.assert_close(d_e, d_f, rtol=1e-5, atol=1e-5)
    assert (i_e < 537).all()
    cap = idx2._table.shape[0]
    assert cap == 4096                           # grown to the quantum
    jidx2 = jexact.ExactIndex(to_jax(base), dtype).extended(
        to_jax(np_(full)), to_jax(extra))
    assert_same_top_k(d_e, i_e, *jidx2.search(to_jax(np_(q)), 7), atol=1e-4)
    idx3 = idx2.extended(full, to_torch(extra[:4]))
    assert idx3._size == 537 + 4
    assert idx3._table.shape[0] == cap          # capacity reused
    tids = to_torch(np.arange(500, 537, dtype=np.int32))
    _, i_in = idx3.search_in(q, 3, tids)
    assert (i_in >= 500).all()


def test_extended_consumes_the_receiver_and_rejects_fused(rng):
    v = to_torch(_clustered(rng, n=300))
    idx = ExactIndex(v, "int8")
    big = idx.extended(v, v[:5])
    cap = big._table.shape[0]
    with pytest.raises(RuntimeError, match="consumed"):
        idx.search(v[:2], 3)
    again = big.extended(v, v[5:9])
    assert again._table.shape[0] == cap and again._size == 309
    assert again._table.shape[1] == 48 and torch.isinf(
        again._norms[309:]).all() and not again._scales[309:].any()
    with pytest.raises(ValueError, match="fused"):
        ExactIndex(v, "bfloat16", fused=True).extended(v, v[:2])


# -------------------------------------------------------------- IVFADC

@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    """(vectors, JAX IVFADC index, its port loaded from the saved file)."""
    x = _clustered(np.random.default_rng(13))
    jidx = jivfadc.IVFADCIndex.build(jax.random.PRNGKey(2), to_jax(x), m=12,
                                     k=16, k_coarse=24, train_size=None,
                                     iters=4)
    path = tmp_path_factory.mktemp("ivf_insert") / "ivfadc.npz"
    jidx.save(path)
    return x, jidx, IVFADCIndex.load(path, device="cpu")


def _same_csr(got: IVFADCIndex, want) -> None:
    for name in ("cell_offsets", "codes_sorted", "row_ids", "assignments"):
        a, b = np_(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.list_cap == want.list_cap
    np.testing.assert_array_equal(np_(got.coarse.counts),
                                  np.asarray(want.coarse.counts))


def test_ivfadc_tail_matches_jax(ivf_pair):
    """Mirrors tests/test_ivfadc.py:224-263: the tail holds the new rows,
    searches scan and merge it, and a flush splices it into the CSR — all
    as in the JAX package."""
    x, jidx, idx = ivf_pair
    new = _new_rows(3, 9)
    got, want = idx.add(to_torch(new)), jidx.add(to_jax(new))
    assert got.tail_count == want.tail_count == 9 and got.size == N + 9
    _same_codebook(got.codebook, want.codebook)
    for name in ("tail_codes", "tail_cells", "tail_ids"):
        np.testing.assert_array_equal(np_(getattr(got, name))[:9],
                                      np.asarray(getattr(want, name))[:9])
    np.testing.assert_allclose(np_(got.tail_rowterm)[:9],
                               np.asarray(want.tail_rowterm)[:9], atol=1e-5)
    q = np.concatenate([new, x[:8]])
    for args in ((5,), (1,)):
        assert_same_top_k(*got.search(to_torch(q), *args, w=3),
                          *want.search(to_jax(q), *args, w=3), atol=1e-4)
    assert_same_top_k(*got.search_adaptive(to_torch(new), 1, w=4),
                      *want.search_adaptive(to_jax(new), 1, w=4), atol=1e-4)
    xv = np.concatenate([x, new])
    assert_same_top_k(*got.search_pv(to_torch(q), 3, 5, to_torch(xv)),
                      *want.search_pv(to_jax(q), 3, 5, to_jax(xv)),
                      atol=1e-5)
    flushed = got.flush()
    assert flushed.tail_count == 0 and flushed.size == N + 9
    _same_csr(flushed, want.flush())
    assert got.flush() is not got and flushed.flush() is flushed


def test_ivfadc_splice_on_overflow_matches_jax(ivf_pair, monkeypatch):
    """Mirrors tests/test_ivfadc.py:266-281 with TAIL_CAP lowered to 16 in
    both packages: five adds of 7 rows splice twice, and the CSR lists,
    the tail and the searches agree with the JAX package's."""
    x, jidx, idx = ivf_pair
    monkeypatch.setattr(IVFADCIndex, "TAIL_CAP", 16)
    monkeypatch.setattr(jivfadc.IVFADCIndex, "TAIL_CAP", 16)
    for i in range(5):
        new = _new_rows(10 + i, 7)
        idx, jidx = idx.add(to_torch(new)), jidx.add(to_jax(new))
        assert idx.tail_count == jidx.tail_count < 16
    assert idx.size == N + 35 and idx._tiled is None
    _same_csr(idx, jidx)
    off = np_(idx.cell_offsets)
    assert off[-1] + idx.tail_count == idx.size
    q = to_torch(x[:4])
    d, i = idx.search(q, 5, w=idx.num_cells)
    assert (i >= 0).all()
    assert_same_top_k(d, i, *jidx.search(to_jax(x[:4]), 5,
                                         w=jidx.num_cells), atol=1e-4)


def test_ivfadc_save_flushes_and_jax_loads(ivf_pair, tmp_path):
    x, jidx, idx = ivf_pair
    grown = idx.add(to_torch(_new_rows(4, 6)))
    grown.save(tmp_path / "port.npz")
    back = jivfadc.IVFADCIndex.load(tmp_path / "port.npz")
    assert back.tail_count == 0 and back.size == N + 6
    _same_csr(grown.flush(), back)


# --------------------------------------------------------------- store

def test_store_extend_matches_jax(rng):
    """Mirrors tests/test_store_io.py:65-112."""
    words = [f"t{i}" for i in range(50)]
    vecs = rng.normal(size=(50, 16)).astype(np.float32)
    s = VectorStore.from_arrays(words, vecs, device="cpu")
    js = JStore.from_arrays(words, vecs)
    s3, j3 = s.extend(["n1"], vecs[:1] * 2), js.extend(["n1"], vecs[:1] * 2)
    assert s3.size == 51 and s3.get_id("n1") == 50 and s.size == 50
    np.testing.assert_allclose(np_(s3.vectors_norm), np.asarray(j3.vectors_norm),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="already present"):
        s3.extend(["t0"], vecs[:1])
    ret = s.extend_inplace(["n1", "n2"], vecs[:2] * 3)
    want = js.extend_inplace(["n1", "n2"], vecs[:2] * 3)
    assert ret is s and s.words == want.words
    assert s.word_to_id == want.word_to_id
    np.testing.assert_allclose(np_(s.vectors), np.asarray(want.vectors),
                               rtol=1e-6)
    np.testing.assert_allclose(np_(s.vectors_norm),
                               np.asarray(want.vectors_norm), rtol=1e-6)
    n0 = s.size
    with pytest.raises(ValueError, match="already present"):
        s.extend_inplace(["fresh", "n1"], vecs[:2])
    assert s.size == n0 and "fresh" not in s and s.vectors.shape[0] == n0


# -------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def engine_dirs(tmp_path_factory):
    """A JAX engine with every index family, saved twice: with a float32
    exact index and with an int8 one."""
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(4096)]
    store = JStore.from_arrays(words, _clustered(rng, n=4096))
    eng = JFreddy.build(store, seed=0, pq_m=12, pq_k=16, opq_iters=2,
                        ivfadc_m=12, ivfadc_k=16, k_coarse=24, ivpq_m=12,
                        ivpq_k=16, ivpq_k_coarse=8, train_size=None,
                        iters=4)
    dirs = {}
    for dtype in ("float32", "int8"):
        eng.exact = jexact.ExactIndex(eng.store.vectors_norm, dtype)
        dirs[dtype] = tmp_path_factory.mktemp(f"engine_{dtype}")
        eng.save(dirs[dtype])
    return dirs


TERMS = ["w1 w2", "w3 w400", "w5 w6 w7", "w9", "w10 nope", "nope", "w1 w2",
         "w11 w12"]
NEW = ["w1 w2", "w3 w400", "w5 w6 w7", "w10 nope", "w11 w12"]
OLD = ["w0", "w17", "w999", "w4095"]


def _rows(rows, store, names, k):
    """(query, word, sim) rows → (−sim, id) matrices, padded."""
    per = {n: [] for n in names}
    for q, w, s in rows:
        per[q].append((-s, store.get_id(w)))
    d = np.array([([s for s, _ in per[n]] + [np.inf] * k)[:k]
                  for n in names], np.float32)
    i = np.array([([j for _, j in per[n]] + [-1] * k)[:k] for n in names])
    return d, i


def _same_engine_answers(port, jeng, atol=1e-5):
    """``knn`` on new and old words in the exact, PQ-PV and IVFADC-PV
    families and the IVPQ join (method 2) over targets that include the
    new rows: the same similarities within ``atol``, ids up to ties."""
    words = NEW + OLD
    for family in ("k_nearest_neighbour", "k_nearest_neighbour_pq_pv",
                   "k_nearest_neighbour_ivfadc_pv"):
        for e in (port, jeng):
            e.set_knn_function(family)
            e.set_pvf(5)
        for w in words:
            got, want = port.knn(w, 6), jeng.knn(w, 6)
            dg, ig = _rows([(w, *r) for r in got], port.store, [w], 6)
            dw, iw = _rows([(w, *r) for r in want], jeng.store, [w], 6)
            assert_same_top_k(dg, ig, dw, iw, atol=atol)
            if " " in w and "nope" not in w:     # a new mean of two words
                assert got[0][0] == w, (family, w, got[:2])
    targets = [f"w{i}" for i in range(0, 4096, 3)] + NEW
    for e in (port, jeng):
        e.set_alpha(20)
        e.set_method_flag(2)
        e.set_pvf(4)
    got = port.knn_in_ivpq_batch(words, 5, targets)
    want = jeng.knn_in_ivpq_batch(words, 5, targets)
    assert_same_top_k(*_rows(got, port.store, words, 5),
                      *_rows(want, jeng.store, words, 5), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_insert_batch_matches_jax(engine_dirs, dtype):
    """A JAX engine saved with every index, loaded in the port: both
    insert the same multi-word terms (duplicates, known words and all-OOV
    terms skipped) and then answer alike on new and old words."""
    port, jeng = Freddy.load(engine_dirs[dtype], device="cpu"), JFreddy.load(
        engine_dirs[dtype])
    assert port.exact.compute_dtype == dtype
    assert port.insert_batch(TERMS) == jeng.insert_batch(TERMS) == len(NEW)
    assert port.store.words == jeng.store.words
    np.testing.assert_allclose(np_(port.store.vectors_norm),
                               np.asarray(jeng.store.vectors_norm),
                               atol=1e-6)
    assert port.ivfadc.tail_count == jeng.ivfadc.tail_count == len(NEW)
    assert port.pq.size == port.ivpq.size == port.exact._size == 4096 + 5
    _same_engine_answers(port, jeng)
    assert port.insert_batch(["w1 w2", "nope"]) == 0


def test_engine_inserted_by_jax_loads_in_the_port(engine_dirs, tmp_path):
    jeng = JFreddy.load(engine_dirs["float32"])
    jeng.insert_batch(TERMS)
    jeng.save(tmp_path / "j")                    # flushes the IVFADC tail
    port = Freddy.load(tmp_path / "j", device="cpu")
    assert port.ivfadc.tail_count == 0 and port.ivfadc.size == 4096 + 5
    assert port.store.size == 4096 + 5 and "w5 w6 w7" in port.store
    _same_engine_answers(port, JFreddy.load(tmp_path / "j"))


def test_engine_inserted_by_the_port_loads_in_jax(engine_dirs, tmp_path):
    port = Freddy.load(engine_dirs["int8"], device="cpu")
    port.insert_batch(TERMS)
    port.save(tmp_path / "p")
    jeng = JFreddy.load(tmp_path / "p")
    assert jeng.exact.compute_dtype == "int8" and jeng.ivfadc.tail_count == 0
    assert jeng.store.words == port.store.words
    np.testing.assert_array_equal(np.asarray(jeng.pq.codes), np_(port.pq.codes))
    np.testing.assert_array_equal(np.asarray(jeng.ivpq.cell_of),
                                  np_(port.ivpq.cell_of))
    _same_engine_answers(Freddy.load(tmp_path / "p", device="cpu"), jeng)
