"""The rest of the port's engine against the JAX package (CPU), on the
small saved JAX engines of ``test_torch_parity_util`` loaded in the port:
the store's ``get_words`` / ``from_binary_file`` / native text parser, the
vector ops, ``PQIndex.search_in``, the in-set family with its TRACK
stages, the ten analogy methods, both groupings, the three clusterings,
tokenize, autotune, warmup, ``prepare_join(vecs_pregathered=True)`` and
the join-tile cache.

Tolerances: ``search_in`` distances within 1e-5 and equal ids (the same
float32 LUT sums in the same order); in-set kNN similarities within 1e-5;
analogy, grouping and clustering return the same words and cluster ids;
tokenize within 1e-6; autotune the same candidates, parameters and
recalls (seconds are not compared); joins within 1e-4, as in
tests/test_torch_models.py.
"""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import VectorStore as JStore
from postgres_word2vec_tpu import api as japi
from postgres_word2vec_tpu.ops import vector_ops as jvo

from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch import api
from postgres_word2vec_tpu_torch.api import NoMatrixCore
from postgres_word2vec_tpu_torch.ops import vector_ops as vo

from test_torch_parity_util import (FULL_ENGINE, PQ_ENGINE, PROBE_ENGINE,
                                    assert_same_top_k, np_, save_jax_engine,
                                    to_jax, to_torch)


@pytest.fixture(scope="module")
def full_engine(tmp_path_factory):
    """JAX engine with PQ (no OPQ), IVFADC and IVPQ, and its port."""
    jeng, path = save_jax_engine(tmp_path_factory.mktemp("full"),
                                 **FULL_ENGINE)
    return jeng, Freddy.load(path, device="cpu"), path


@pytest.fixture(scope="module")
def pq_engine(tmp_path_factory):
    jeng, path = save_jax_engine(tmp_path_factory.mktemp("pq"), **PQ_ENGINE)
    return jeng, Freddy.load(path, device="cpu"), path


@pytest.fixture(scope="module")
def probe_engine(tmp_path_factory):
    jeng, path = save_jax_engine(tmp_path_factory.mktemp("probe"),
                                 **PROBE_ENGINE)
    return jeng, Freddy.load(path, device="cpu"), path


TARGETS = [f"w{i}" for i in range(0, 3000, 3)]
TRIPLES = (("w1", "w2", "w3"), ("w10", "w200", "w77"),
           ("w1500", "w4", "w999"))


# ------------------------------------------------------------------ store

def _write_word2vec(tmp_path, words, vecs, binary):
    path = tmp_path / ("v.bin" if binary else "v.txt")
    with open(path, "wb") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n".encode())
        for w, v in zip(words, vecs):
            body = (v.astype(np.float32).tobytes() if binary else
                    " ".join(f"{x:.6f}" for x in v).encode())
            f.write(w.encode() + b" " + body + b"\n")
    return path


@pytest.mark.parametrize("max_words", [None, 7])
def test_from_binary_file_matches_jax(rng, tmp_path, max_words):
    words = [f"tok{i}" for i in range(20)]
    vecs = rng.normal(size=(20, 8)).astype(np.float32)
    path = _write_word2vec(tmp_path, words, vecs, binary=True)
    got = VectorStore.from_binary_file(path, max_words, device="cpu")
    want = JStore.from_binary_file(path, max_words)
    assert got.words == want.words
    np.testing.assert_array_equal(np_(got.vectors), np.asarray(want.vectors))
    np.testing.assert_allclose(np_(got.vectors_norm),
                               np.asarray(want.vectors_norm), atol=1e-7)


@pytest.mark.parametrize("use_native", [True, False])
def test_from_text_file_parsers_match_jax(rng, tmp_path, use_native):
    words = [f"tok{i}" for i in range(20)]
    vecs = rng.normal(size=(20, 8)).astype(np.float32)
    path = _write_word2vec(tmp_path, words, vecs, binary=False)
    got = VectorStore.from_text_file(path, use_native=use_native,
                                     device="cpu")
    want = JStore.from_text_file(path, use_native=use_native)
    assert got.words == want.words == words
    np.testing.assert_array_equal(np_(got.vectors), np.asarray(want.vectors))


def test_native_text_parser_falls_back_to_numpy(rng, tmp_path, monkeypatch):
    from postgres_word2vec_tpu_torch.utils import native_io

    def broken(*_a, **_k):
        raise OSError("no native parser")
    monkeypatch.setattr(native_io, "load_text_embeddings", broken)
    words = [f"tok{i}" for i in range(5)]
    vecs = rng.normal(size=(5, 4)).astype(np.float32)
    path = _write_word2vec(tmp_path, words, vecs, binary=False)
    got = VectorStore.from_text_file(path, device="cpu")
    np.testing.assert_allclose(np_(got.vectors), vecs, atol=1e-6)


def test_from_binary_file_needs_a_device_or_the_card(tmp_path, rng,
                                                     monkeypatch):
    path = _write_word2vec(tmp_path, ["a"],
                           rng.normal(size=(1, 4)).astype(np.float32), True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        VectorStore.from_binary_file(path)


def test_get_words_matches_jax(full_engine):
    jeng, port, _ = full_engine
    ids = [0, 5, 2999, 3000, -1, 17]
    assert port.store.get_words(ids) == jeng.store.get_words(ids)


# ------------------------------------------------------------ vector ops

@pytest.mark.parametrize("name", ["cosine_similarity",
                                  "cosine_similarity_norm", "vec_plus",
                                  "vec_minus", "squared_l2"])
def test_binary_vector_ops_match_jax(rng, name):
    a = rng.normal(size=(3, 5, 16)).astype(np.float32)
    b = rng.normal(size=(3, 5, 16)).astype(np.float32)
    got = getattr(vo, name)(to_torch(a), to_torch(b))
    want = getattr(jvo, name)(to_jax(a), to_jax(b))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_centroid_matches_jax(rng):
    a = rng.normal(size=(3, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(np_(vo.centroid(to_torch(a))),
                               np.asarray(jvo.centroid(to_jax(a))),
                               rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- search_in

@pytest.mark.parametrize("k", [1, 5, 40])
def test_pq_search_in_matches_jax(pq_engine, k):
    """OPQ-rotated index; a masked and a duplicated target; k past T."""
    jeng, port, path = pq_engine
    q = np.asarray(jeng.store.vectors_norm[3:9])
    tids = np.array([4, 9, 3000, 12, 9, 77, 3, 4095, 512, 1], np.int32)
    mask = np.ones(len(tids), bool)
    mask[2] = False
    got = port.pq.search_in(to_torch(q), k, to_torch(tids), to_torch(mask))
    want = jeng.pq.search_in(to_jax(q), k, to_jax(tids), to_jax(mask))
    np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    if k > len(tids) - 1:
        assert (np_(got[1])[:, len(tids) - 1:] == -1).all()
        assert np.isinf(np_(got[0])[:, len(tids) - 1:]).all()


def test_pq_search_in_defaults_to_an_all_true_mask(pq_engine):
    _, port, _ = pq_engine
    q = port.store.vectors_norm[:4]
    tids = torch.arange(100, 200)
    a = port.pq.search_in(q, 5, tids)
    b = port.pq.search_in(q, 5, tids, torch.ones(100, dtype=torch.bool))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_pq_adc_in_is_the_plain_gather(pq_engine):
    _, port, _ = pq_engine
    from postgres_word2vec_tpu_torch.ops import adc, lut

    pq = port.pq
    luts = lut.build_luts(pq._rotate(port.store.vectors_norm[:3]),
                          pq.codebook.centroids)
    tids = torch.tensor([7, 0, 4095, 7])
    torch.testing.assert_close(pq.adc_in(luts, tids),
                               adc.adc_distances(luts, pq.codes[tids]),
                               atol=0, rtol=0)


# --------------------------------------------------------- in-set family

@pytest.mark.parametrize("impl", ["knn_in_exact", "knn_in_pq"])
def test_knn_in_family_matches_jax(full_engine, impl):
    jeng, port, _ = full_engine
    port.set_knn_in_function(impl)
    jeng.set_knn_in_function(impl)
    try:
        for query in ("w5", "w2222"):
            got, want = port.knn_in(query, 6, TARGETS), jeng.knn_in(
                query, 6, TARGETS)
            assert [w for w, _ in got] == [w for w, _ in want]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], atol=1e-5)
        ids = list(range(0, 3000, 7))
        got = getattr(port, impl)("w8", 4, ids)
        want = getattr(jeng, impl)("w8", 4, ids)
        assert [w for w, _ in got] == [w for w, _ in want]
        q = np_(port.store.vectors_for(["w1", "w2", "w3"]))
        tids, tmask = port._target_ids(TARGETS)
        jt, jm = jeng._target_ids(TARGETS)
        d, i = port.knn_in_matrix(to_torch(q), 5, tids, tmask)
        dj, ij = jeng.knn_in_matrix(to_jax(q), 5, jt, jm)
        assert_same_top_k(d, i, dj, ij, atol=1e-5)
    finally:
        jeng.set_knn_in_function("knn_in_exact")
        port.set_knn_in_function("knn_in_exact")


def test_knn_in_matrix_has_no_ivpq_core(full_engine):
    _, port, _ = full_engine
    port.set_knn_in_function("knn_in_ivpq")
    try:
        tids, tmask = port._target_ids(TARGETS)
        with pytest.raises(NoMatrixCore):
            port.knn_in_matrix(port.store.vectors_norm[:2], 5, tids, tmask)
        assert port.knn_in("w3", 3, TARGETS)[0][0] == "w3"
    finally:
        port.set_knn_in_function("knn_in_exact")
    with pytest.raises(KeyError):
        port.set_knn_in_function("no_such_impl")


def _rows_as_top_k(rows, store, names, k):
    """``(query, word, sim)`` rows → (−sim, id) matrices, one row a query
    (the names distinct)."""
    d = {n: [] for n in names}
    i = {n: [] for n in names}
    for q, w, s in rows:
        d[q].append(-s)
        i[q].append(store.get_id(w))
    return (np.array([(d[n] + [np.inf] * k)[:k] for n in names], np.float32),
            np.array([(i[n] + [-1] * k)[:k] for n in names]))


@pytest.mark.parametrize("track", [False, True])
def test_knn_in_pq_batch_matches_jax(full_engine, track):
    """600 queries: two 512-query chunks, the second ragged."""
    jeng, port, _ = full_engine
    words = [f"w{i}" for i in range(5, 3000, 5)]
    assert len(words) > 512
    port.tracker.clear_track()
    port.set_track_stages(track)
    try:
        got = port.knn_in_pq_batch(words, 4, TARGETS)
    finally:
        port.set_track_stages(False)
    want = jeng.knn_in_pq_batch(words, 4, TARGETS)
    assert [q for q, *_ in got] == [q for q, *_ in want]
    assert_same_top_k(*_rows_as_top_k(got, port.store, words, 4),
                      *_rows_as_top_k(want, port.store, words, 4), atol=1e-5)
    res = port.tracker.get_results()
    for key in ("total_time", "query_construction_time", "computation_time",
                "data_retrieval_time"):
        assert res[key], key
    assert bool(res.get("precomputation_time")) == track
    assert (res["data_retrieval_time"][-1] > 0) == track


def test_join_tracks_precomputation_under_track_stages(probe_engine):
    _, port, _ = probe_engine
    port.tracker.clear_track()
    port.set_track_stages(True)
    try:
        port.knn_in_ivpq_batch(["w1", "w2"], 3, TARGETS)
    finally:
        port.set_track_stages(False)
    res = port.tracker.get_results()
    assert res["precomputation_time"] and res["data_retrieval_time"]


# ---------------------------------------------------------------- analogy

ANALOGY = ["analogy_3cosadd", "analogy_3cosmul", "analogy_pair_direction",
           "analogy_3cosadd_pq", "analogy_3cosadd_ivfadc"]
ANALOGY_IN = ["analogy_3cosadd_in", "analogy_3cosadd_in_pq",
              "analogy_3cosadd_in_ivpq"]


@pytest.mark.parametrize("name", ANALOGY + ANALOGY_IN)
def test_analogy_matches_jax(full_engine, name):
    jeng, port, _ = full_engine
    extra = (TARGETS,) if name in ANALOGY_IN else ()
    for triple in TRIPLES:
        want = getattr(jeng, name)(*triple, *extra)
        assert getattr(port, name)(*triple, *extra) == want, triple
        assert want not in triple


@pytest.mark.parametrize("name", ["analogy", "analogy_in"])
def test_analogy_facades_follow_dispatch(full_engine, name):
    jeng, port, _ = full_engine
    impl = "analogy_3cosmul" if name == "analogy" else "analogy_3cosadd_in_pq"
    extra = (TARGETS,) if name == "analogy_in" else ()
    setter = f"set_{name}_function"
    for e in (jeng, port):
        getattr(e, setter)(impl)
    try:
        assert getattr(port, name)(*TRIPLES[0], *extra) == getattr(
            jeng, name)(*TRIPLES[0], *extra) == getattr(port, impl)(
                *TRIPLES[0], *extra)
    finally:
        for e in (jeng, port):
            getattr(e, setter)(japi.DEFAULT_DISPATCH[name])


def test_analogy_pair_direction_chunks_rows(full_engine, monkeypatch):
    """The raw table normalized in row chunks picks the same word."""
    _, port, _ = full_engine
    whole = port.analogy_pair_direction(*TRIPLES[1])
    monkeypatch.setattr(Freddy, "_PAIR_CHUNK", 77)
    assert port.analogy_pair_direction(*TRIPLES[1]) == whole


def test_analogy_shortlist_exhausted_raises(full_engine):
    _, port, _ = full_engine
    with pytest.raises(ValueError, match="raise pvf"):
        port.analogy_3cosadd_in_pq("w1", "w2", "w3", ["w1", "w2"])


# ------------------------------------------------------- groups, clusters

TOKENS = [f"w{i}" for i in range(0, 3000, 11)] + ["unknown"]
GROUP_WORDS = [f"w{i}" for i in range(1, 3000, 150)]


@pytest.mark.parametrize("name", ["grouping_func", "grouping_func_pq"])
def test_groupings_match_jax(full_engine, name):
    jeng, port, _ = full_engine
    got = getattr(port, name)(TOKENS, GROUP_WORDS)
    assert got == getattr(jeng, name)(TOKENS, GROUP_WORDS)
    assert len(got) == len(TOKENS) - 1
    port.set_groups_function(name)
    try:
        assert port.groups(TOKENS, GROUP_WORDS) == got
    finally:
        port.set_groups_function("grouping_func")


def test_pq_grouping_rotates_into_the_opq_basis(pq_engine):
    """On an OPQ index the port builds the group LUTs from rotated
    vectors (the codes' basis); the JAX engine does not, and agrees with
    exact grouping less often."""
    jeng, port, _ = pq_engine
    toks = [f"w{i}" for i in range(0, 4096, 7)]
    groups = [f"w{i}" for i in range(3, 4096, 200)]
    exact = dict(port.grouping_func(toks, groups))
    got = dict(port.grouping_func_pq(toks, groups))
    want = dict(jeng.grouping_func_pq(toks, groups))
    agree_port = np.mean([got[t] == exact[t] for t in toks])
    agree_jax = np.mean([want[t] == exact[t] for t in toks])
    assert agree_port > agree_jax, (agree_port, agree_jax)
    # by hand: the rotated group vectors' LUTs over the tokens' codes
    from postgres_word2vec_tpu_torch.ops import adc, lut

    pq = port.pq
    gids = torch.tensor(port.store.get_ids(groups))
    luts = lut.build_luts(port.store.vectors_norm[gids] @ pq.rotation,
                          pq.codebook.centroids)
    d = adc.adc_distances(luts, pq.codes[torch.tensor(
        port.store.get_ids(toks))])
    best = gids[torch.argmin(d, dim=0)].tolist()
    assert [got[t] for t in toks] == port.store.get_words(best)


@pytest.mark.parametrize("name", ["cluster_exact", "cluster_pq",
                                  "cluster_ivpq"])
def test_clusterings_match_jax(full_engine, name):
    jeng, port, _ = full_engine
    toks = TOKENS[:150]
    got = getattr(port, name)(toks, 6)
    assert got == getattr(jeng, name)(toks, 6)
    assert {c for _, c in got} <= set(range(1, 7))
    port.set_cluster_function(name)
    try:
        assert port.cluster(toks, 6) == got
    finally:
        port.set_cluster_function("cluster_exact")


def test_cluster_assign_and_local_ids_match_jax(rng):
    d = rng.random((4, 6)).astype(np.float32)
    d[1, 2] = d[0, 0]                          # a tie across centroids
    ids = np.array([[0, 3, 5, -1, 2, 2], [0, 1, 0, 4, -1, 6],
                    [7, 7, 3, 3, 1, -1], [6, 5, 4, 3, 2, 1]], np.int32)
    got = api._cluster_assign(to_torch(d), to_torch(ids), 9)
    want = japi._cluster_assign(to_jax(d), to_jax(ids), 9)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    assert np_(got)[8] == -1
    tids = np.array([40, 7, 99, 3, 12], np.int32)
    gids = np.array([[99, 3, -1, 5], [40, 12, 7, 1000]], np.int32)
    np.testing.assert_array_equal(
        np_(api._globals_to_locals(to_torch(gids).long(),
                                   to_torch(tids).long())),
        np.asarray(japi._globals_to_locals(to_jax(gids), to_jax(tids))))


# --------------------------------------------------------------- tokenize

@pytest.mark.parametrize("text", ["w1", "w1 w2", "w3 unknown w4 w5",
                                  "nothing known"])
def test_tokenize_matches_jax(full_engine, text):
    jeng, port, _ = full_engine
    for name in ("tokenize", "tokenize_raw"):
        got, want = getattr(port, name)(text), getattr(jeng, name)(text)
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --------------------------------------------------------------- autotune

def _summary(report):
    return sorted((r["name"], tuple(sorted(r["params"].items())), r["recall"],
                   r["meets_target"]) for r in report)


def _check_winner(report, target):
    chosen = [r for r in report if r.get("chosen")]
    assert len(chosen) == 1
    ok = [r for r in report if r["recall"] >= target]
    if ok:
        assert chosen[0] is min(ok, key=lambda r: r["seconds"])
    else:
        assert chosen[0]["recall"] == max(r["recall"] for r in report)
    assert report == sorted(report, key=lambda r: r["seconds"])
    return chosen[0]


def test_autotune_matches_jax(full_engine):
    jeng, port, path = full_engine
    got = port.autotune(sample=48, apply=False)
    want = jeng.autotune(sample=48, apply=False)
    assert _summary(got) == _summary(want)
    assert not any(r.get("chosen") for r in got)
    fresh = Freddy.load(path, device="cpu")
    report = fresh.autotune(sample=48, target_recall=0.8)
    best = _check_winner(report, 0.8)
    assert fresh.dispatch["knn"] == best["name"]
    for p, v in best["params"].items():
        assert getattr(fresh.params, p) == v


def test_autotune_join_matches_jax(full_engine):
    jeng, port, path = full_engine
    kw = dict(sample=32, target_sample=600, alphas=(20, 60), pvfs=(5,))
    got = port.autotune_join(apply=False, **kw)
    want = jeng.autotune_join(apply=False, **kw)
    assert _summary(got) == _summary(want)
    fresh = Freddy.load(path, device="cpu")
    report = fresh.autotune_join(targets=TARGETS, target_recall=0.95, **kw)
    best = _check_winner(report, 0.95)
    assert fresh.dispatch["knn_join"] == best["name"]
    for p, v in best["params"].items():
        assert getattr(fresh.params, p) == v


def test_benchutil_timeit_and_recall():
    from postgres_word2vec_tpu_torch.evaluation import benchutil

    calls = []
    dt, out = benchutil.timeit(lambda x: calls.append(x) or x + 1, 2,
                               iters=3)
    assert out == 3 and len(calls) == 4 and dt >= 0.0
    t = benchutil.last_timing()
    assert t["n"] == 3 and t["min_s"] <= t["max_s"]
    assert benchutil.recall_at_k(torch.tensor([[1, 2], [3, 9]]),
                                 np.array([[2, 1, 7], [3, 4, 5]])) == 0.75


def test_warmup_runs_every_family(full_engine):
    _, _, path = full_engine
    port = Freddy.load(path, device="cpu")
    port.warmup(join_targets=300)
    assert port.pq._codes_t is None          # CPU: the plain scans


# ------------------------------------------------------ pregathered joins

@pytest.mark.parametrize("impl", ["dense", "budget"])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_pregathered_join_on_shuffled_targets(probe_engine, impl, method):
    """A (T, d) matrix aligned with a shuffled target set is read by
    target position: the same results as the store table read by id, and
    as the JAX package's pregathered handle."""
    jeng, port, _ = probe_engine
    rng = np.random.default_rng(3)
    tids = rng.permutation(4096)[:1500]
    x = port.store.vectors_norm
    q = x[2:40:3]
    kw = dict(statistics=port.statistics["dom"], alpha=20, method=method,
              pvf=4, impl=impl)
    ph = port.ivpq.prepare_join(to_torch(tids), vectors=x[to_torch(tids)],
                                vecs_pregathered=True)
    assert ph.vecs_pregathered and ph.vectors.shape == (1500, x.shape[1])
    by_id = port.ivpq.prepare_join(to_torch(tids), vectors=x)
    a = port.ivpq.search_join(q, 5, prepared=ph, **kw)
    b = port.ivpq.search_join(q, 5, prepared=by_id, **kw)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=0)
    jx = np.asarray(jeng.store.vectors_norm)
    jph = jeng.ivpq.prepare_join(to_jax(tids.astype(np.int32)),
                                 vectors=to_jax(jx[tids]),
                                 vecs_pregathered=True)
    want = jeng.ivpq.search_join(to_jax(np_(q)), 5, prepared=jph,
                                 statistics=jeng.statistics["dom"], alpha=20,
                                 method=method, pvf=4, impl=impl)
    assert_same_top_k(a[0], a[1], want[0], want[1], atol=1e-4)


def test_pregathered_needs_one_row_per_target(probe_engine):
    _, port, _ = probe_engine
    with pytest.raises(ValueError, match="one row per target"):
        port.ivpq.prepare_join(torch.arange(10),
                               vectors=port.store.vectors_norm,
                               vecs_pregathered=True)


def test_pregathered_whole_store_in_order_aliases_it(probe_engine):
    _, port, _ = probe_engine
    x = port.store.vectors_norm
    ph = port.ivpq.prepare_join(torch.arange(x.shape[0]), vectors=x,
                                vecs_pregathered=True)
    assert ph.vectors is x
    got = port.ivpq.search_join(x[:9], 5, prepared=ph, method=2, alpha=20,
                                impl="budget")
    assert (got[1][:, 0] == torch.arange(9)).all()


# ---------------------------------------------------------- tile cache

def _adhoc(idx, x, tids, method=0):
    return idx.search_join(x[:6], 5, tids, vectors=x, alpha=20,
                           method=method, impl="budget", return_info=True)


def test_join_tile_cache_hits_and_reports_no_retrieval(probe_engine):
    _, port, path = probe_engine
    idx = Freddy.load(path, device="cpu").ivpq
    x = port.store.vectors_norm
    tids = torch.arange(0, 4096, 2)
    first = _adhoc(idx, x, tids)
    assert len(idx._join_cache) == 1 and first[2]["data_retrieval_s"] > 0
    (jt, pinned), = idx._join_cache.values()
    second = _adhoc(idx, x, tids)
    assert second[2]["data_retrieval_s"] == 0.0
    assert next(iter(idx._join_cache.values()))[0] is jt and pinned is None
    assert torch.equal(first[1], second[1])
    _adhoc(idx, x, tids, method=1)          # raw-row tiles: a new entry
    assert len(idx._join_cache) == 2
    assert list(idx._join_cache.values())[1][1] is x


def test_join_tile_cache_evicts_the_least_recently_used(probe_engine):
    _, port, path = probe_engine
    idx = Freddy.load(path, device="cpu").ivpq
    x = port.store.vectors_norm
    sets = [torch.arange(s, 4096, 5) for s in range(5)]
    for t in sets[:4]:
        _adhoc(idx, x, t)
    assert _adhoc(idx, x, sets[0])[2]["data_retrieval_s"] == 0.0  # LRU hit
    _adhoc(idx, x, sets[4])                 # the 5th set evicts set 1
    assert len(idx._join_cache) == idx._JOIN_CACHE_CAP == 4
    assert _adhoc(idx, x, sets[0])[2]["data_retrieval_s"] == 0.0
    assert _adhoc(idx, x, sets[1])[2]["data_retrieval_s"] > 0


def test_join_tile_cache_never_serves_rows_from_before_a_change(
        probe_engine):
    """An insert gives a new index and a new table; an in-place write to
    the table bumps its version: either way the raw-row tiles are built
    again and the join sees the new rows."""
    _, _, path = probe_engine
    eng = Freddy.load(path, device="cpu")
    tids = torch.arange(0, 4096, 4)
    _adhoc(eng.ivpq, eng.store.vectors_norm, tids, method=1)
    old = eng.ivpq
    assert eng.insert_batch(["w1 w5", "w9 w13"]) == 2
    assert eng.ivpq is not old and not eng.ivpq._join_cache
    x = eng.store.vectors_norm
    before = _adhoc(eng.ivpq, x, tids, method=1)
    r = int(before[1][1, 1])                # query 1's second target
    assert float(before[0][1, 1]) > 1e-3
    # overwrite that target's row with query row 1: the join must find it
    # at distance 0 first
    with torch.no_grad():
        x[r] = x[1]
    after = _adhoc(eng.ivpq, x, tids, method=1)
    assert after[2]["data_retrieval_s"] > 0
    assert int(after[1][1, 0]) == r and float(after[0][1, 0]) < 1e-3
