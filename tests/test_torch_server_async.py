"""The port's asyncio ``AsyncQueryServer`` (standard-library HTTP) against
the JAX package's aiohttp one (CPU), and its HTTP/1.1 handling.

Parity as in tests/test_torch_server.py: every endpoint gets the same
request on both servers over the same saved engine; the status codes are
equal and a 200's answer is the same (words in order, similarities within
1e-5, swaps only between ties). Then the port's server runs in a
subprocess with ``aiohttp`` (and JAX) blocked, and raw sockets check
keep-alive, ``Connection: close``, HTTP/1.0 and malformed requests. Every
client call times out after 10 s.
"""

import json
import os
import select
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu.server_async import (
    AsyncQueryServer as JAsyncQueryServer)

from postgres_word2vec_tpu_torch import Freddy
from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer

from test_torch_parity_util import (SERVER_CASES, assert_same_response,
                                    http_call, save_server_engine)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def engine_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("served_async")
    save_server_engine(path)
    return path


@pytest.fixture(scope="module")
def servers(engine_dir, request):
    jsrv = JAsyncQueryServer(JFreddy.load(engine_dir), port=0).start()
    request.addfinalizer(jsrv.stop)
    psrv = AsyncQueryServer(Freddy.load(engine_dir, device="cpu"),
                            port=0).start()
    request.addfinalizer(psrv.stop)
    return jsrv, psrv


@pytest.mark.parametrize("name,path,payload", SERVER_CASES,
                         ids=[c[0] for c in SERVER_CASES])
def test_every_endpoint_answers_as_jax_async(servers, name, path, payload):
    jsrv, psrv = servers
    method = "GET" if payload is None else "POST"
    want_code, want = http_call(jsrv.port, path, payload, method=method)
    got_code, got = http_call(psrv.port, path, payload, method=method)
    assert got_code == want_code, (name, got, want)
    if want_code == 200:
        assert_same_response(got["result"], want["result"], 1e-5, name)
    else:
        assert "error" in got


def test_async_health_has_the_jax_keys(servers):
    jsrv, psrv = servers
    _, want = http_call(jsrv.port, "/health")
    code, got = http_call(psrv.port, "/health")
    assert code == 200 and got.keys() == want.keys()
    assert got["knn_batch_errors"] == 0


def test_async_coalesces_with_pipelined_batches(engine_dir, request):
    import threading

    srv = AsyncQueryServer(Freddy.load(engine_dir, device="cpu"), port=0,
                           batch_window_ms=40.0, pipeline_depth=2).start()
    request.addfinalizer(srv.stop)
    srv.warmup()
    res = [None] * 24

    def one(j):
        q = "no_such_word" if j == 5 else f"w{j}"
        res[j] = http_call(srv.port, "/knn", {"query": q, "k": 3})

    threads = [threading.Thread(target=one, args=(j,)) for j in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for j, (code, r) in enumerate(res):
        if j == 5:
            assert code == 400 and "KeyError" in r["error"]
        else:
            assert code == 200 and r["result"][0][0] == f"w{j}"
    _, h = http_call(srv.port, "/health")
    assert h["knn_items_done"] == 24 and h["knn_batch_errors"] == 0
    assert h["knn_batched_calls"] < 24


# ----------------------------------------- the HTTP reader, aiohttp blocked

@pytest.fixture(scope="module")
def blocked_server(engine_dir, request):
    """The port's async server in a subprocess that cannot import aiohttp
    or JAX → its port."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["aiohttp"] = None
        sys.modules["jax"] = None
        from postgres_word2vec_tpu_torch import Freddy
        from postgres_word2vec_tpu_torch.server_async import (
            AsyncQueryServer)
        srv = AsyncQueryServer(Freddy.load({str(engine_dir)!r},
                                           device="cpu"), port=0).start()
        print(srv.port, flush=True)
        sys.stdin.read()
        srv.stop()
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})

    def stop():
        proc.stdin.close()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)

    request.addfinalizer(stop)
    ready, _, _ = select.select([proc.stdout], [], [], 60)
    assert ready, "the server did not start"
    line = proc.stdout.readline()
    assert line.strip().isdigit(), proc.stderr.read()
    return int(line)


def _connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.settimeout(10)
    return s


def _request(path, body=b"", *, method="POST", version="HTTP/1.1",
             headers=()):
    head = [f"{method} {path} {version}", "Host: l"]
    if method == "POST":
        head.append(f"Content-Length: {len(body)}")
    head += list(headers)
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _read_response(sock, buf=b""):
    """One response off ``sock`` → (status, headers, JSON body, rest)."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        assert chunk, "connection closed before a response"
        buf += chunk
    head, _, buf = buf.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = {k.strip().lower(): v.strip()
               for k, _, v in (h.partition(":") for h in lines[1:])}
    n = int(headers["content-length"])
    while len(buf) < n:
        chunk = sock.recv(65536)
        assert chunk, "connection closed inside a body"
        buf += chunk
    return status, headers, json.loads(buf[:n]), buf[n:]


def _closed(sock) -> bool:
    try:
        return sock.recv(1) == b""
    except ConnectionResetError:
        return True


def test_keep_alive_serves_requests_in_order(blocked_server):
    with _connect(blocked_server) as s:
        body = json.dumps({"query": "w7", "k": 2}).encode()
        # two requests in one write: both answered, in order, on one socket
        s.sendall(_request("/knn", body) + _request("/health", method="GET"))
        st1, h1, b1, rest = _read_response(s)
        st2, _, b2, rest = _read_response(s, rest)
        assert (st1, st2) == (200, 200) and rest == b""
        assert b1["result"][0][0] == "w7" and b2["status"] == "ok"
        assert "connection" not in h1
        s.sendall(_request("/knn", body))
        assert _read_response(s)[0] == 200


def test_connection_close_and_http10_close_after_the_response(
        blocked_server):
    body = json.dumps({"query": "w1", "k": 2}).encode()
    for req in (_request("/knn", body, headers=("Connection: close",)),
                _request("/knn", body, version="HTTP/1.0")):
        with _connect(blocked_server) as s:
            s.sendall(req)
            status, headers, out, _ = _read_response(s)
            assert status == 200 and out["result"][0][0] == "w1"
            assert headers.get("connection") == "close"
            assert _closed(s)


def test_malformed_json_body_answers_400_and_keeps_the_connection(
        blocked_server):
    with _connect(blocked_server) as s:
        s.sendall(_request("/knn", b'{"query": "w1", "k": '))
        status, _, out, _ = _read_response(s)
        assert status == 400 and "JSONDecodeError" in out["error"]
        s.sendall(_request("/knn", b'{"query": "w2", "k": 1}'))
        status, _, out, _ = _read_response(s)
        assert status == 200 and out["result"][0][0] == "w2"


@pytest.mark.parametrize("raw,status", [
    (b"GARBAGE\r\n\r\n", 400),
    (b"POST /knn HTTP/1.1\r\nContent-Length: x\r\n\r\n", 400),
    (b"POST /knn HTTP/1.1\r\nbad header line\r\n\r\n", 400),
    (b"POST /knn HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 400),
    (b"POST /knn HTTP/1.1\r\nContent-Length: 999999999999\r\n\r\n", 413),
    (b"PUT /knn HTTP/1.1\r\nContent-Length: 0\r\n\r\n", 405),
], ids=["request_line", "content_length", "header", "chunked", "too_large",
        "method"])
def test_malformed_requests(blocked_server, raw, status):
    with _connect(blocked_server) as s:
        s.sendall(raw)
        got, _, out, _ = _read_response(s)
        assert got == status and "error" in out


def test_truncated_body_answers_400_and_closes(blocked_server):
    with _connect(blocked_server) as s:
        s.sendall(b"POST /knn HTTP/1.1\r\nContent-Length: 50\r\n\r\n{}")
        s.shutdown(socket.SHUT_WR)
        status, headers, out, _ = _read_response(s)
        assert status == 400 and headers.get("connection") == "close"
        assert _closed(s)


# ------------------------------------------------------------ the load driver

def test_load_driver_windows_against_the_port(engine_dir, request):
    """A fleet of two spawned raw-socket clients runs short windows against
    the port's async server (/knn, and /knn_join of 4-query requests
    against a prepared set), then against the echo server: no errors, and
    the periodic answer checks pass. Closing the fleet stops its clients
    and multiprocessing's resource tracker: no process of it outlives the
    fleet."""
    from postgres_word2vec_tpu_torch.evaluation import serving_bench as sb

    srv = AsyncQueryServer(Freddy.load(engine_dir, device="cpu"),
                           port=0).start()
    request.addfinalizer(srv.stop)
    sb.post(srv.port, "/prepare_targets",
            {"name": "t", "targets": list(range(200))}, timeout=10)
    with sb.ClientFleet(2) as fleet:
        for kw in (dict(), dict(path="/knn_join", batch=4,
                                extra=', "targets": "t"')):
            w = fleet.window(srv.port, 300, 3, 1.0, **kw)
            assert w["errors"] == 0 and w["completed"] > 0, w
            assert w["qps"] > 0 and w["latency_ms"]["p50"] > 0
        echo = sb.run_echo_floor(fleet, 0.5, 3)
        assert echo["errors"] == 0 and echo["completed"] > 0
    assert not [c for c in sb.child_processes() if "multiprocessing" in c]
    assert sb.get(srv.port, "/health")["knn_batch_errors"] == 0
