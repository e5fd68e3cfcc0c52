"""Async serving runtime — one event loop, an HTTP/1.1 front end from the
standard library.

Counterpart of ``postgres_word2vec_tpu/server_async.py``: the same
endpoints, status codes and JSON bodies as :mod:`.server` (the threaded
front end); only the HTTP and concurrency machinery differ. The JAX
package parses HTTP with aiohttp; this one needs nothing outside the
standard library: ``asyncio.start_server`` and a small keep-alive reader
(request line, headers, a ``Content-Length`` body; ``Connection: close``
and HTTP/1.0 close after the response).

- /knn and /knn_in micro-batches coalesce directly on the loop (a plain
  list + one timer), with per-item asyncio futures;
- one executor thread runs every engine call (the dispatch phase of the
  coalesced batches and the other endpoints), which serializes the device;
- ``pipeline_depth`` coalesced batches are in flight: the dispatch phase
  enqueues the search and the copies of its results and records a CUDA
  event (:class:`.server.EngineRunner`), and completer threads wait on
  those events and format, while the next batch dispatches.
"""

from __future__ import annotations

import asyncio
import json
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from postgres_word2vec_tpu_torch.api import Freddy
from postgres_word2vec_tpu_torch.server import (EngineRunner,
                                                UnknownEndpoint,
                                                load_engine, parse_knn_item)
from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER, Span

#: the largest request body read (larger ones answer 413)
MAX_BODY_BYTES = 64 << 20
#: the longest request line or header line read
MAX_LINE_BYTES = 65536

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large"}


class _LoopBatcher:
    """Coalesce concurrent single-item requests ON the event loop.

    ``submit(item)`` appends to a plain list and awaits a future; a single
    drainer coroutine sleeps ``window_ms`` after the first arrival, then
    runs everything queued, in ``max_batch`` slices, in two phases:
    ``fn`` — the DISPATCH phase, on the executor — resolves, gathers and
    enqueues a slice on the device and returns pending state, and
    ``complete_fn(state)`` waits for the device and formats on the
    ``completer`` pool. Up to ``depth`` slices are in flight, so batch
    N+1's host work and device enqueue overlap batch N's device execution
    instead of idling behind it (the JAX package's unsplit mode, which no
    front end uses, is not ported).
    """

    def __init__(self, fn, executor, *, complete_fn, completer,
                 max_batch: int = 64, window_ms: float = 2.0,
                 depth: int = 2):
        self._fn = fn
        self._executor = executor
        self._complete = complete_fn
        self._completer = completer
        self._depth = max(1, depth)
        self._max = max_batch
        self._win = window_ms / 1e3
        self._items: list = []
        self._futs: list = []
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self.batched_calls = 0
        self.items_done = 0
        self.busy_s = 0.0
        self.max_coalesced = 0
        self.batch_errors = 0
        self.last_error: str | None = None

    def start(self) -> None:
        """Create loop-bound state; call from inside the running loop."""
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._drainer())

    async def stop(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass

    async def submit(self, item):
        fut = asyncio.get_running_loop().create_future()
        self._items.append(item)
        self._futs.append(fut)
        self._wake.set()
        return await fut

    def _fail(self, cfuts, e: Exception) -> None:
        # surfaced server-side as well: items get per-request 400s, but an
        # operator (and the load driver) must be able to see WHAT failed
        self.batch_errors += 1
        self.last_error = f"{type(e).__name__}: {e}"
        if self.batch_errors <= 3 or self.batch_errors % 100 == 0:
            print(f"[batcher] batch failure #{self.batch_errors}: "
                  f"{self.last_error}", file=sys.stderr, flush=True)
        for f in cfuts:
            if not f.done():
                f.set_exception(e)

    def _deliver(self, cfuts, results, t0: float, n: int) -> None:
        self.busy_s += time.perf_counter() - t0
        self.batched_calls += 1
        self.items_done += n
        self.max_coalesced = max(self.max_coalesced, n)
        for f, r in zip(cfuts, results):
            if f.done():
                continue
            if isinstance(r, Exception):
                f.set_exception(r)
            else:
                f.set_result(r)

    async def _finish(self, loop, state, cfuts, t0: float, n: int) -> None:
        """Completion phase of one in-flight batch; never raises — a
        batch-level failure 400s its own items."""
        try:
            results = await loop.run_in_executor(
                self._completer, self._complete, state)
        except Exception as e:  # noqa: BLE001 — batch-level failure
            self._fail(cfuts, e)
            return
        self._deliver(cfuts, results, t0, n)

    async def _drainer(self):
        loop = asyncio.get_running_loop()
        inflight: deque = deque()
        while True:
            await self._wake.wait()
            if self._win > 0:
                await asyncio.sleep(self._win)   # coalescing window
            items, futs = self._items, self._futs
            self._items, self._futs = [], []
            self._wake.clear()
            for s in range(0, len(items), self._max):
                chunk = items[s:s + self._max]
                cfuts = futs[s:s + self._max]
                # bound the in-flight depth, dispatch, then hand the
                # pending state to a completion task and keep draining
                while len(inflight) >= self._depth:
                    await inflight.popleft()
                t0 = time.perf_counter()
                try:
                    state = await loop.run_in_executor(
                        self._executor, self._fn, chunk)
                except Exception as e:  # noqa: BLE001 — dispatch failure
                    self._fail(cfuts, e)
                    continue
                inflight.append(loop.create_task(
                    self._finish(loop, state, cfuts, t0, len(chunk))))
            while inflight and inflight[0].done():
                await inflight.popleft()


class _BadRequest(Exception):
    """A request the reader cannot parse: answer ``status`` and close."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_request(reader: asyncio.StreamReader
                        ) -> tuple[str, str, bytes, bool] | None:
    """One HTTP/1.x request → (method, path, body, keep_alive), or None at
    a clean end of the connection."""
    try:
        line = await reader.readuntil(b"\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise _BadRequest(400, "truncated request line") from None
        return None
    except asyncio.LimitOverrunError:
        raise _BadRequest(400, "request line too long") from None
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(400, f"malformed request line {line[:80]!r}")
    method, target, version = parts
    headers: dict[str, str] = {}
    while True:
        try:
            h = await reader.readuntil(b"\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            raise _BadRequest(400, "malformed headers") from None
        if h == b"\r\n":
            break
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, f"malformed header {h[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    conn = headers.get("connection", "").lower()
    keep_alive = (conn != "close" if version == "HTTP/1.1"
                  else conn == "keep-alive")
    if "transfer-encoding" in headers:
        raise _BadRequest(400, "only Content-Length bodies are supported")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise _BadRequest(400, "malformed Content-Length") from None
    if length < 0:
        raise _BadRequest(400, "malformed Content-Length")
    if length > MAX_BODY_BYTES:
        raise _BadRequest(413, f"body of {length} bytes exceeds "
                               f"{MAX_BODY_BYTES}")
    try:
        body = await reader.readexactly(length) if length else b""
    except asyncio.IncompleteReadError:
        raise _BadRequest(400, "truncated body") from None
    path = target.split("?", 1)[0]
    return method, path, body, keep_alive


def _response(status: int, payload, keep_alive: bool) -> bytes:
    data = json.dumps(payload).encode()
    head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            + ("" if keep_alive else "Connection: close\r\n") + "\r\n")
    return head.encode() + data


class AsyncQueryServer:
    """Standard-library asyncio front end over a shared
    :class:`~postgres_word2vec_tpu_torch.server.EngineRunner`.

    Same constructor and endpoints as the JAX package's
    ``AsyncQueryServer``; ``start()`` runs the event loop on a daemon
    thread so sync callers (tests, the load driver) drive it exactly like
    the threaded server.
    """

    DEFAULT_K = 5

    def __init__(self, engine: Freddy, host: str = "127.0.0.1",
                 port: int = 0, batch_window_ms: float = 2.0,
                 max_batch: int = 64, pipeline_depth: int = 2):
        self.engine = engine
        self.runner = EngineRunner(engine)
        self._host = host
        self._port0 = port
        self.port: int | None = None
        self._window_ms = batch_window_ms
        self._max_batch = max_batch
        # in-flight coalesced batches: 2 overlaps one batch's dispatch
        # with the previous batch's device work and completion
        self._depth = pipeline_depth
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="engine")
        # one completer a batch in flight: each waits on its own batch's
        # event; device work stays ordered on the card's stream whichever
        # thread waits, and each batch delivers to its own futures
        self._completer = ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth),
            thread_name_prefix="complete")
        self._requests = 0
        self._started = time.time()
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()
        self._start_error: BaseException | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_ev: asyncio.Event | None = None
        self._conns: set[asyncio.Task] = set()
        self._knn_batcher: _LoopBatcher | None = None
        self._knn_in_batcher: _LoopBatcher | None = None

    # ------------------------------------------------------------- control
    def warmup(self, k: int | None = None) -> None:
        """Run every power-of-two /knn batch shape coalescing can produce
        (see :meth:`EngineRunner.warmup`)."""
        self.runner.warmup(self._max_batch,
                           self.DEFAULT_K if k is None else k)

    def start(self) -> "AsyncQueryServer":
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="frontend")
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError("async server failed to start")
        if self._start_error is not None:
            raise RuntimeError("async server failed to start") \
                from self._start_error
        return self

    def stop(self) -> None:
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._executor.shutdown(wait=False)
        self._completer.shutdown(wait=False)

    def serve_forever(self) -> None:
        if self._thread is None:
            self.start()
        self._thread.join()

    def _run_loop(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:  # noqa: BLE001 — reported by start()
            self._start_error = e
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_ev = asyncio.Event()
        self._knn_batcher = _LoopBatcher(
            self.runner.dispatch_knn_batch, self._executor,
            max_batch=self._max_batch, window_ms=self._window_ms,
            complete_fn=self.runner.complete_knn_batch,
            completer=self._completer, depth=self._depth)
        self._knn_in_batcher = _LoopBatcher(
            self.runner.dispatch_knn_in_batch, self._executor,
            max_batch=self._max_batch, window_ms=self._window_ms,
            complete_fn=self.runner.complete_knn_in_batch,
            completer=self._completer, depth=self._depth)
        self._knn_batcher.start()
        self._knn_in_batcher.start()
        srv = await asyncio.start_server(self._serve_conn, self._host,
                                         self._port0, limit=MAX_LINE_BYTES)
        self.port = srv.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            await self._stop_ev.wait()
        finally:
            srv.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await srv.wait_closed()
            await self._knn_batcher.stop()
            await self._knn_in_batcher.stop()

    # ------------------------------------------------------------ handlers
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One keep-alive connection: requests in order, one at a time."""
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _BadRequest as e:
                    writer.write(_response(e.status, {"error": str(e)},
                                           False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, body, keep_alive = req
                status, payload, reply = await self._route(method, path,
                                                           body)
                writer.write(_response(status, payload, keep_alive))
                await writer.drain()
                if reply is not None:
                    reply.end()
                if not keep_alive:
                    break
        except ConnectionError:
            pass        # the client went away mid-request
        finally:
            self._conns.discard(task)
            writer.close()

    async def _route(self, method: str, path: str, body: bytes
                     ) -> tuple[int, dict, Span | None]:
        """→ (status, payload, the open ``fe_reply_time`` span of an
        executor endpoint's answer, for the caller to end once written).

        An executor endpoint's request gets a request id here, as its last
        byte has been read; its ``fe_queue_time`` span runs from here
        (through the JSON decode) until the engine thread holds the
        device lock, and its ``fe_reply_time`` span from the engine's
        return until the response is written."""
        if method == "GET" and path == "/health":
            return 200, self._health(), None
        if method != "POST":       # every other path takes POST only
            return 405, {"error": f"method {method} not allowed"}, None
        self._requests += 1
        batched = path in ("/knn", "/knn_in")
        queued = None
        if not batched:
            rid = GLOBAL_TRACKER.new_request()
            queued = GLOBAL_TRACKER.begin("fe_queue_time", request=rid)
        try:
            req = json.loads(body) if body else {}
            if batched:
                batcher = (self._knn_batcher if path == "/knn"
                           else self._knn_in_batcher)
                result = await batcher.submit(parse_knn_item(path, req))
                return 200, {"result": result}, None
            result, reply = await asyncio.get_running_loop(
                ).run_in_executor(self._executor, self._run_plain, path,
                                  req, queued)
            return 200, {"result": result}, reply
        except UnknownEndpoint as e:
            return 404, {"error": str(e)}, None
        except Exception as e:  # noqa: BLE001 — serve errors as 400
            return 400, {"error": f"{type(e).__name__}: {e}"}, None
        finally:
            if queued is not None:
                queued.end()        # a request that failed before the lock

    def _run_plain(self, path: str, req: dict, queued: Span):
        """On the engine thread: the endpoint under the device lock, then
        the ``fe_reply_time`` span opened as the engine returns."""
        result = self.runner.run_plain(path, req, queued=queued)
        return result, GLOBAL_TRACKER.begin("fe_reply_time",
                                            request=queued.request)

    def _health(self) -> dict:
        h = self.runner.health(self._requests, self._started)
        for name, b in (("knn", self._knn_batcher),
                        ("knn_in", self._knn_in_batcher)):
            h[f"{name}_batched_calls"] = b.batched_calls
            h[f"{name}_busy_s"] = round(b.busy_s, 3)
            h[f"{name}_items_done"] = b.items_done
            h[f"{name}_max_coalesced"] = b.max_coalesced
            h[f"{name}_batch_errors"] = b.batch_errors
            if b.last_error:
                h[f"{name}_last_error"] = b.last_error
        return h


def main() -> None:
    """CLI: ``python -m postgres_word2vec_tpu_torch.server_async
    <engine_dir> [port]`` — serve a previously saved engine on the card."""
    engine, port = load_engine(sys.argv, __doc__)
    server = AsyncQueryServer(engine, port=port)
    server.warmup()
    server.start()
    print(f"serving {engine.store.size} vectors on :{server.port} (async, "
          f"{engine.store.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
