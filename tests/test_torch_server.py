"""The port's threaded ``QueryServer`` against the JAX package's (CPU).

Both serve the JAX server tests' engine (tests/test_server.py:11-21),
built by the JAX package and saved, the port's side loaded with
``Freddy.load(device="cpu")``. Every endpoint gets the same request on
both servers: the same status code, and for a 200 the same answer (the
same words in the same order, similarities within 1e-5, a swap allowed
only between rows that tie within it). Then the port's own serving
behaviour: /knn and /knn_in micro-batches coalesce, a bad item fails only
its own slot, word and vector queries mix in one batch, and /health has
the JAX server's keys. Every client call times out after 10 s.
"""

import threading

import numpy as np
import pytest

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu.server import QueryServer as JQueryServer

from postgres_word2vec_tpu_torch import Freddy
from postgres_word2vec_tpu_torch.server import QueryServer

from test_torch_parity_util import (SERVER_CASES, assert_same_response,
                                    http_call, save_server_engine)


@pytest.fixture(scope="module")
def engine_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("served")
    save_server_engine(path)
    return path


@pytest.fixture(scope="module")
def servers(engine_dir, request):
    """(JAX server, port server) over the same saved engine."""
    jsrv = JQueryServer(JFreddy.load(engine_dir), port=0).start()
    request.addfinalizer(jsrv.stop)
    psrv = QueryServer(Freddy.load(engine_dir, device="cpu"),
                       port=0).start()
    request.addfinalizer(psrv.stop)
    return jsrv, psrv


@pytest.fixture()
def batching(engine_dir, request):
    """A port server with a 60 ms coalescing window, on its own engine."""
    srv = QueryServer(Freddy.load(engine_dir, device="cpu"), port=0,
                      batch_window_ms=60.0).start()
    request.addfinalizer(srv.stop)
    return srv


def _concurrently(fn, n):
    out = [None] * n

    def one(j):
        out[j] = fn(j)

    threads = [threading.Thread(target=one, args=(j,)) for j in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("name,path,payload", SERVER_CASES,
                         ids=[c[0] for c in SERVER_CASES])
def test_every_endpoint_answers_as_jax(servers, name, path, payload):
    jsrv, psrv = servers
    method = "GET" if payload is None else "POST"
    want_code, want = http_call(jsrv.port, path, payload, method=method)
    got_code, got = http_call(psrv.port, path, payload, method=method)
    assert got_code == want_code, (name, got, want)
    if want_code == 200:
        assert_same_response(got["result"], want["result"], 1e-5, name)
    else:
        assert "error" in got


def test_health_has_the_jax_keys(servers):
    jsrv, psrv = servers
    _, want = http_call(jsrv.port, "/health")
    code, got = http_call(psrv.port, "/health")
    assert code == 200 and got.keys() == want.keys()
    assert got["knn_stage_s"].keys() == want["knn_stage_s"].keys()
    assert got["status"] == "ok" and got["vocab"] == want["vocab"]
    assert got["device"] == "cpu"


def test_knn_microbatching_coalesces(batching):
    res = _concurrently(lambda j: http_call(
        batching.port, "/knn", {"query": f"w{j}", "k": 3}), 24)
    for j, (code, r) in enumerate(res):
        assert code == 200 and r["result"][0][0] == f"w{j}"
    _, h = http_call(batching.port, "/health")
    assert h["knn_items_done"] == 24
    assert h["knn_batched_calls"] < h["knn_items_done"]
    assert h["knn_max_coalesced"] >= 2


def test_knn_bad_item_fails_only_its_slot(batching):
    def one(j):
        q = "no_such_word" if j == 2 else ([0.1, 0.2] if j == 4
                                           else f"w{j}")
        return http_call(batching.port, "/knn", {"query": q, "k": 3})

    res = _concurrently(one, 6)
    for j, (code, r) in enumerate(res):
        if j == 2:
            assert code == 400 and "KeyError" in r["error"]
        elif j == 4:
            assert code == 400 and "ValueError" in r["error"]
        else:
            assert code == 200 and r["result"][0][0] == f"w{j}"


def test_knn_in_coalesces_and_isolates_bad_items(batching):
    t1 = [f"w{i}" for i in range(30)]
    t2 = [f"w{i}" for i in range(30, 80)]
    eng = batching.engine
    payloads = [{"query": f"w{j}", "k": 3, "targets": t1} for j in range(6)]
    payloads += [{"query": "w40", "k": 3, "targets": t2},
                 {"query": "no_such_word", "k": 3, "targets": t1}]
    res = _concurrently(lambda j: http_call(batching.port, "/knn_in",
                                            payloads[j]), len(payloads))
    for j, p in enumerate(payloads[:-1]):
        code, r = res[j]
        assert code == 200
        want = eng.knn_in(p["query"], 3, p["targets"])
        assert [w for w, _ in r["result"]] == [w for w, _ in want]
        np.testing.assert_allclose([s for _, s in r["result"]],
                                   [s for _, s in want], atol=1e-5)
    assert res[-1][0] == 400 and "KeyError" in res[-1][1]["error"]
    _, h = http_call(batching.port, "/health")
    assert h["knn_in_batched_calls"] < h["knn_in_items_done"]
    # the IVPQ impl has no matrix core: per-item calls still answer
    eng.set_knn_in_function("knn_in_ivpq")
    code, r = http_call(batching.port, "/knn_in",
                        {"query": "w3", "k": 2, "targets": t1})
    assert code == 200 and len(r["result"]) == 2


def test_mixed_word_and_vector_batch(batching):
    """Word and raw-vector queries coalesced into one batch run as separate
    device groups, and each slot gets its own answer."""
    eng = batching.engine
    v5 = eng.store.vector_for("w5").numpy()
    out = batching.runner._run_knn_batch([("w3", 2), (v5, 2), ("w9", 2),
                                          (v5, 3)])
    assert out[0][0][0] == "w3" and out[2][0][0] == "w9"
    assert out[1][0][0] == "w5" and len(out[1]) == 2
    assert out[3][0][0] == "w5" and len(out[3]) == 3
    # the same queries one at a time give the same rows
    for (q, k), got in zip([("w3", 2), (v5, 2)], out[:2]):
        want = eng.knn(q, k)
        assert [w for w, _ in got] == [w for w, _ in want]


def test_prepare_targets_serves_named_joins(batching):
    targets = [f"w{i}" for i in range(50)]
    code, r = http_call(batching.port, "/prepare_targets",
                        {"name": "dom", "targets": targets})
    assert code == 200 and r["result"]["size"] == 50
    body = {"queries": ["w1", "w2"], "k": 3}
    _, adhoc = http_call(batching.port, "/knn_join",
                         {**body, "targets": targets})
    _, named = http_call(batching.port, "/knn_join",
                         {**body, "targets": "dom"})
    assert adhoc["result"] == named["result"]
