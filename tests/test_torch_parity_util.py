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


# ------------------------------------------------------------ serving parity

#: the JAX server tests' engine (tests/test_server.py:11-21): 300 × 16
#: normal rows, PQ 4×8, IVFADC 4×8 over 6 cells, IVPQ 4×8 over 4 cells
SERVER_ENGINE = dict(pq_m=4, pq_k=8, ivfadc_m=4, ivfadc_k=8, k_coarse=6,
                     ivpq_m=4, ivpq_k=8, ivpq_k_coarse=4, train_size=None,
                     iters=5)


def save_server_engine(path):
    """Build the JAX server tests' engine, save it under ``path`` → the
    JAX engine."""
    from postgres_word2vec_tpu import Freddy as JFreddy
    from postgres_word2vec_tpu import VectorStore as JStore

    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    eng = JFreddy.build(JStore.from_arrays([f"w{i}" for i in range(300)],
                                           vecs), seed=0, **SERVER_ENGINE)
    eng.save(path)
    return eng


def http_call(port, path, payload=None, *, method=None, raw=None,
              timeout=10.0):
    """One request (POST with a JSON body, or GET without one) → (status,
    decoded JSON body). ``raw`` sends those bytes as the body instead."""
    import json
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except ValueError:
            return e.code, body.decode(errors="replace")


_T100 = [f"w{i}" for i in range(100)]

#: one request for every endpoint, in an order whose state changes (config,
#: prepared targets, statistics, insert) both servers see alike; ``None``
#: as the payload is a GET
SERVER_CASES = [
    ("knn_word", "/knn", {"query": "w10", "k": 3}),
    ("knn_vector", "/knn", {"query": [0.25] * 8 + [-0.5] * 8, "k": 4}),
    ("knn_in_words", "/knn_in", {"query": "w3", "k": 4, "targets": _T100}),
    ("knn_in_ids", "/knn_in", {"query": "w30", "k": 3,
                               "targets": list(range(50, 250))}),
    ("knn_batch", "/knn_batch", {"queries": ["w1", "w2", "w3"], "k": 3}),
    ("config_alpha", "/config", {"set_alpha": 50}),
    ("knn_join", "/knn_join", {"queries": ["w1", "w2"], "k": 2,
                               "targets": _T100}),
    ("prepare_targets", "/prepare_targets", {"name": "dom",
                                             "targets": _T100}),
    ("config_join_ivpq", "/config",
     {"set_knn_join_function": "knn_in_ivpq_batch", "set_method_flag": 1}),
    ("knn_join_prepared", "/knn_join", {"queries": ["w4", "w5", "w6"],
                                        "k": 3, "targets": "dom"}),
    ("analogy", "/analogy", {"w1": "w1", "w2": "w2", "w3": "w3"}),
    ("analogy_in", "/analogy_in", {"w1": "w1", "w2": "w2", "w3": "w3",
                                   "targets": _T100}),
    ("groups", "/groups", {"tokens": [f"w{i}" for i in range(40)],
                           "group_tokens": ["w100", "w150", "w200"]}),
    ("cluster", "/cluster", {"tokens": [f"w{i}" for i in range(60)],
                             "k": 4}),
    ("tokenize", "/tokenize", {"text": "w1 w2 nope"}),
    ("tokenize_raw", "/tokenize", {"text": "w1 w2", "raw": True}),
    ("tokenize_unknown", "/tokenize", {"text": "nope"}),
    ("statistics", "/statistics", {"name": "s", "domain": _T100}),
    ("config_knn_pq_pv", "/config",
     {"set_knn_function": "k_nearest_neighbour_pq_pv", "set_pvf": 5}),
    ("knn_pq_pv", "/knn", {"query": "w11", "k": 3}),
    ("config_knn_ivfadc_pv", "/config",
     {"set_knn_function": "k_nearest_neighbour_ivfadc_pv"}),
    ("knn_ivfadc_pv", "/knn", {"query": "w12", "k": 3}),
    ("config_knn_exact", "/config",
     {"set_knn_function": "k_nearest_neighbour"}),
    ("insert", "/insert", {"terms": ["w1 w2", "w7 nope"]}),
    ("knn_inserted", "/knn", {"query": "w1 w2", "k": 2}),
    ("unknown_endpoint", "/nope", {}),
    ("unknown_word", "/knn", {"query": "missing_word", "k": 3}),
    ("unknown_setting", "/config", {"set_bogus": 1}),
    ("knn_in_no_targets", "/knn_in", {"query": "w3", "k": 3}),
    ("bad_dim", "/knn", {"query": [0.1, 0.2], "k": 3}),
    ("join_unknown_set", "/knn_join", {"queries": ["w1"], "k": 2,
                                       "targets": "nope"}),
    ("get_unknown", "/nope", None),
]


def assert_same_rows(got, want, tol, what):
    """Ranked rows (``[word, sim]``, or ``[query, word, sim]`` for joins)
    agree: the same length, similarities within ``tol``, and the same row
    at every rank but where the similarities tie within ``tol``: a row may
    then swap with one it ties with, or differ in a tie at its query's
    last rank (the k-th place may pick either row)."""
    assert len(got) == len(want), what
    gs = np.array([r[-1] for r in got], np.float64)
    ws = np.array([r[-1] for r in want], np.float64)
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0, err_msg=what)
    for i, (g, w) in enumerate(zip(got, want)):
        if g[:-1] == w[:-1]:
            continue
        group = [j for j in range(len(want)) if want[j][:-2] == w[:-2]]
        tied = [tuple(want[j][:-1]) for j in group
                if abs(ws[j] - ws[i]) <= tol]
        assert (tuple(g[:-1]) in tied
                or abs(ws[i] - ws[group[-1]]) <= tol), (what, i, g, w)


def assert_same_response(got, want, tol=1e-5, what=""):
    """Two servers' JSON answers agree: ranked rows by :func:`_same_rows`,
    numbers within ``tol``, everything else equal; ``build_s`` (a time) is
    not compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), what
        for key in want:
            if key != "build_s":
                assert_same_response(got[key], want[key], tol,
                                     f"{what}.{key}")
    elif (isinstance(want, list) and want and isinstance(want[0], list)
          and isinstance(want[0][-1], float)):
        assert_same_rows(got, want, tol, what)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            assert_same_response(g, w, tol, what)
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (what, got, want)
    else:
        assert got == want, (what, got, want)
