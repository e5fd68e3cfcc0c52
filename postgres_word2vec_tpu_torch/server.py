"""Query server — the serving runtime around the engine.

Counterpart of ``postgres_word2vec_tpu/server.py``. The reference's serving
story is Postgres itself: clients connect and issue SQL against the
extension's functions. This module is the equivalent standalone runtime: a
threaded HTTP/JSON server exposing every query family with the same names
and parameter semantics, so a FREDDY deployment's client-side SQL maps 1:1
onto request paths.

Endpoints (POST JSON unless noted):

    /knn          {"query": word|vector, "k": int}
    /knn_in       {"query": …, "k": int, "targets": [words|ids]}
    /knn_batch    {"queries": [words], "k": int}
    /knn_join     {"queries": [words], "k": int,
                   "targets": [words|ids] | "registered-name"}
    /prepare_targets {"name": "...", "targets": [words|ids]} — register a
                   persistent-tile target set for repeated /knn_join calls
    /analogy      {"w1": w, "w2": w, "w3": w}
    /analogy_in   {…, "targets": [words]}
    /groups       {"tokens": [...], "group_tokens": [...]}
    /cluster      {"tokens": [...], "k": int}
    /tokenize     {"text": "..."} (+"raw": true)
    /insert       {"terms": [...]}
    /statistics   {"name": "...", "domain": [words]}
    /config       {"set_pvf": 20, "set_alpha": 3, …}  (any setter)
    /health       GET — engine + device status

A routing failure answers 404, every other failure 400 with
``{"error": "Type: message"}``.

Device work is serialized with a lock. Concurrent single-query ``/knn`` and
``/knn_in`` requests are MICRO-BATCHED: a coalescing queue gathers requests
for up to ``batch_window_ms`` (default 2 ms) and runs them as one device
call on the dispatched index family, so a fleet of single-query clients
gets batched-kernel throughput without changing their requests.

On the card a coalesced batch is split in two phases
(:meth:`EngineRunner.dispatch_knn_batch` and
:meth:`EngineRunner.complete_knn_batch`): the dispatch enqueues the row
gather, the search and the copies of its results into pinned host memory,
then records a CUDA event; the completion waits on that event and formats
on the host. A pipelined front end (``server_async``) runs the completion
on another thread while the next batch dispatches. Families whose search
reads a device value on the host before it returns (IVFADC's widening
rounds, ``search_adaptive``; the IVPQ join's escalation rounds) block in
the dispatch; exact, PQ, PQ + post-verify, IVFADC + post-verify and the
in-set exact and PQ cores dispatch without waiting for the card.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from postgres_word2vec_tpu_torch.api import Freddy, NoMatrixCore

#: the /knn and /knn_in handlers' default k
DEFAULT_K = 5


class UnknownEndpoint(KeyError):
    """Routing failure (404) — distinct from domain KeyErrors (400)."""


class _MicroBatcher:
    """Coalesce concurrent single-item requests into one batched call.

    ``fn(items) -> results`` runs on a worker thread; ``submit(item)``
    blocks until the item's result is ready. The worker drains whatever is
    queued after the first item has waited ``window_ms`` (or immediately at
    ``max_batch``).
    """

    def __init__(self, fn, *, max_batch: int = 64, window_ms: float = 2.0):
        self._fn = fn
        self._max_batch = max_batch
        self._window = window_ms / 1e3
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self.stats_lock = threading.Lock()   # guards the counters below
        self.batched_calls = 0
        self.max_coalesced = 0
        self.busy_s = 0.0          # wall time spent inside fn (device path)
        self.items_done = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, item):
        slot = {"item": item, "event": threading.Event(), "result": None,
                "error": None}
        with self._cv:
            self._queue.append(slot)
            self._cv.notify()
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def _run(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                deadline = time.monotonic() + self._window
                while len(self._queue) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._queue[:self._max_batch]
                del self._queue[:len(batch)]
            t0 = time.perf_counter()
            try:
                results = self._fn([s["item"] for s in batch])
                for s, r in zip(batch, results):
                    # fn returns an Exception per slot for an item-level
                    # failure: one unknown word must not 400 every request
                    # coalesced into the same batch.
                    if isinstance(r, Exception):
                        s["error"] = r
                    else:
                        s["result"] = r
            except Exception as e:  # noqa: BLE001 — batch-level failure
                for s in batch:
                    s["error"] = e
            with self.stats_lock:
                self.busy_s += time.perf_counter() - t0
                self.items_done += len(batch)
                self.batched_calls += 1
                self.max_coalesced = max(self.max_coalesced, len(batch))
            for s in batch:
                s["event"].set()


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class _Pending:
    """One dispatched group: its result slots, its real row count, the
    device results (held until the copies out of them have completed, so
    the caching allocator cannot hand their memory to the next batch), the
    host copies and the event recorded after them (None on the CPU, where
    the results are already host tensors)."""

    __slots__ = ("idxs", "b", "d", "i", "d_host", "i_host", "event")

    def __init__(self, idxs: list[int], b: int, d: torch.Tensor,
                 i: torch.Tensor):
        self.idxs, self.b, self.d, self.i = idxs, b, d, i
        if d.is_cuda:
            # enqueue the copies behind the search; nothing waits here
            self.d_host = torch.empty(d.shape, dtype=d.dtype,
                                      pin_memory=True)
            self.i_host = torch.empty(i.shape, dtype=i.dtype,
                                      pin_memory=True)
            self.d_host.copy_(d, non_blocking=True)
            self.i_host.copy_(i, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.d_host, self.i_host, self.event = d, i, None

    def fetch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Wait for the copies and return the real rows' host results."""
        if self.event is not None:
            self.event.synchronize()
        self.d = self.i = None
        return self.d_host[:self.b], self.i_host[:self.b]


class EngineRunner:
    """Engine-execution core shared by the threaded and async servers:
    query resolution, pow2-padded gathers, the coalesced batch runners,
    and the device lock. Front ends differ only in how they parse HTTP
    and coalesce requests."""

    def __init__(self, engine: Freddy):
        self.engine = engine
        # "search" = enqueueing the search (host time; families that read
        # a device value on the host wait inside it); "fetch" = the wait
        # for the event behind the result copies, in the completion phase
        self.stage_s = {"resolve": 0.0, "gather": 0.0, "search": 0.0,
                        "fetch": 0.0, "format": 0.0}
        self._lock = threading.Lock()
        # device-resident (tids, tmask) per /knn_in target set: the serving
        # pattern is many clients querying the SAME restricted domain, so
        # the id set is resolved and uploaded once. Bounded FIFO
        # (drop-oldest) — target sets are client-controlled input.
        self._tid_cache: dict[tuple, tuple] = {}
        self._tid_cache_max = 32

    # -------------------------------------------------- knn micro-batching
    def _resolve_queries(self, entries, out: list) -> tuple[dict, dict]:
        """Resolve (j, query) entries on the host only: word → vocab id,
        raw vector → normalized numpy row (dim-checked). A bad item fails
        only its own ``out`` slot."""
        eng = self.engine
        wid: dict[int, int] = {}
        raw: dict[int, np.ndarray] = {}
        for j, query in entries:
            try:
                if isinstance(query, str):
                    wid[j] = eng.store.get_id(query)
                else:
                    v = np.asarray(query, np.float32).reshape(-1)
                    if v.shape[0] != eng.store.dim:
                        raise ValueError(
                            f"query dim {v.shape[0]} != store dim "
                            f"{eng.store.dim}")
                    n = float(np.linalg.norm(v))
                    raw[j] = v / n if n > 0 else v
            except Exception as e:  # noqa: BLE001 — isolate per item
                out[j] = e
        return wid, raw

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the store's device; to the card from pinned
        memory without waiting for the copy."""
        t = torch.from_numpy(host)
        dev = self.engine.store.device
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    def _gather_group(self, idxs: list[int], wid: dict, raw: dict
                      ) -> tuple[torch.Tensor, int]:
        """One query matrix for a coalesced group, padded to the next power
        of two rows with copies of its first query. The padding keeps the
        JAX package's shape-driven choices (``_grouped_wins``,
        ``_BUDGET_SCAN_BLOCK``) on the same branch for a coalesced batch in
        both packages.

        Word-id groups gather their rows on the device (``index_select``
        over the normalized table, the ids uploaded from pinned memory);
        raw-vector groups stack their rows on the host and upload the small
        (B, d) matrix."""
        b = len(idxs)
        bp = _pow2(b)
        if idxs[0] in raw:   # raw-vector group (host rows, dim-checked)
            rows = [raw[j] for j in idxs]
            rows.extend([rows[0]] * (bp - b))
            return self._upload(np.ascontiguousarray(np.stack(rows))), b
        ids = np.asarray([wid[j] for j in idxs] + [wid[idxs[0]]] * (bp - b),
                         np.int64)
        q = torch.index_select(self.engine.store.vectors_norm, 0,
                               self._upload(ids))
        return q, b

    def _group_by(self, items: list[tuple], out: list, raw: dict,
                  key) -> dict[tuple, list[int]]:
        """Items not failed yet, grouped by ``key(item)`` plus whether the
        query is a raw vector (raw groups upload host rows, word groups
        gather on the device)."""
        groups: dict[tuple, list[int]] = {}
        for j, item in enumerate(items):
            if out[j] is None:
                groups.setdefault((*key(item), j in raw), []).append(j)
        return groups

    def dispatch_knn_batch(self, items: list[tuple]):
        """Enqueue one coalesced batch of (query, k) items on the device
        and return an opaque pending state for :meth:`complete_knn_batch`.
        Nothing here waits for the card (but a family's own host reads,
        see the module docstring), so a pipelined front end dispatches the
        next batch while this one runs."""
        eng = self.engine
        tmr = self.stage_s
        t0 = time.perf_counter()
        out: list = [None] * len(items)
        wid, raw = self._resolve_queries(
            [(j, query) for j, (query, _k) in enumerate(items)], out)
        groups = self._group_by(items, out, raw, lambda it: (int(it[1]),))
        tmr["resolve"] += time.perf_counter() - t0
        pending = []
        for (k, _is_raw), idxs in groups.items():
            with self._lock:
                t0 = time.perf_counter()
                q, b = self._gather_group(idxs, wid, raw)
                tmr["gather"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                d, i = eng.knn_matrix(q, k)
                pending.append(_Pending(idxs, b, d, i))
                tmr["search"] += time.perf_counter() - t0
        return out, pending

    def complete_knn_batch(self, state) -> list:
        """Wait for a batch dispatched by :meth:`dispatch_knn_batch` and
        format it; safe to run on another thread than the dispatcher."""
        eng = self.engine
        tmr = self.stage_s
        out, pending = state
        for p in pending:
            t0 = time.perf_counter()
            d, i = p.fetch()
            tmr["fetch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            rows = eng._format_knn(d, i)
            tmr["format"] += time.perf_counter() - t0
            for j, r in zip(p.idxs, rows):
                out[j] = r
        return out

    def _run_knn_batch(self, items: list[tuple]) -> list:
        """One device call for a coalesced batch of (query, k) items —
        dispatch + completion back to back (the threaded front end's path;
        the async front end pipelines the two phases).

        Queries group by k (usually one group); each group stacks into a
        (B, d) matrix and runs through ``Freddy.knn_matrix`` — the engine's
        own dispatched batch path — then formats per query. A bad item
        (unknown word, malformed vector) fails only its own slot."""
        return self.complete_knn_batch(self.dispatch_knn_batch(items))

    # ------------------------------------------------ knn_in micro-batching
    def _target_set(self, tgt: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The device-resident (ids, mask) of a /knn_in target set, padded
        to a power of two with masked slots; cached per target set."""
        cached = self._tid_cache.get(tgt)
        if cached is not None:
            return cached
        eng = self.engine
        tid_list = (eng.store.get_ids(list(tgt), strict=False)
                    if isinstance(tgt[0], str) else [int(t) for t in tgt])
        t = len(tid_list)
        tp = _pow2(t)
        tids_np = np.zeros((tp,), np.int64)
        tids_np[:t] = tid_list
        tmask_np = np.zeros((tp,), bool)
        tmask_np[:t] = True
        cached = (self._upload(tids_np), self._upload(tmask_np))
        if len(self._tid_cache) >= self._tid_cache_max:
            self._tid_cache.pop(next(iter(self._tid_cache)))
        self._tid_cache[tgt] = cached
        return cached

    def dispatch_knn_in_batch(self, items: list[tuple]):
        """Dispatch phase of the coalesced /knn_in path: items are
        (query, k, targets-tuple). Requests group by (k, target set) — the
        serving pattern is many clients querying the SAME restricted
        domain (the reference's statistics-table use case) — and each
        group enqueues as ONE batched in-set device call through
        ``Freddy.knn_in_matrix``. Dispatch impls without a matrix core
        (IVPQ) run per-item calls to completion here. Returns pending
        state for :meth:`complete_knn_in_batch`."""
        eng = self.engine
        out: list = [None] * len(items)
        wid, raw = self._resolve_queries(
            [(j, query) for j, (query, _k, _tgt) in enumerate(items)], out)
        groups = self._group_by(items, out, raw,
                                lambda it: (int(it[1]), it[2]))
        # impls without a batched matrix core (IVPQ's data-dependent
        # rounds) go straight to per-item calls
        has_core = eng.dispatch["knn_in"] in eng._KNN_IN_CORES

        def _per_item(idxs, k, tgt):
            with self._lock:
                for j in idxs:
                    try:
                        out[j] = eng.knn_in(items[j][0], k, list(tgt))
                    except Exception as e:  # noqa: BLE001
                        out[j] = e

        pending = []
        for (k, tgt, _is_raw), idxs in groups.items():
            if not has_core:
                _per_item(idxs, k, tgt)
                continue
            try:
                with self._lock:
                    tids, tmask = self._target_set(tgt)
                    q, b = self._gather_group(idxs, wid, raw)
                    d, i = eng.knn_in_matrix(q, k, tids, tmask)
                    pending.append(_Pending(idxs, b, d, i))
            except NoMatrixCore:
                # a precise sentinel: a bare KeyError would also swallow
                # unrelated internal errors as fallbacks
                _per_item(idxs, k, tgt)
            except Exception as e:  # noqa: BLE001 — group-level failure
                for j in idxs:
                    out[j] = e
        return out, pending

    def complete_knn_in_batch(self, state) -> list:
        """Wait for and format the groups dispatched by
        :meth:`dispatch_knn_in_batch`; a failing group fails only its own
        slots."""
        eng = self.engine
        out, pending = state
        for p in pending:
            try:
                rows = eng._format_knn(*p.fetch())
                for j, r in zip(p.idxs, rows):
                    out[j] = r
            except Exception as e:  # noqa: BLE001 — group-level failure
                for j in p.idxs:
                    out[j] = e
        return out

    def _run_knn_in_batch(self, items: list[tuple]) -> list:
        """Dispatch + completion back to back (threaded front end; the
        async front end pipelines the phases)."""
        return self.complete_knn_in_batch(self.dispatch_knn_in_batch(items))

    # ---------------------------------------------------- shared routing
    def warmup(self, max_batch: int, k: int = DEFAULT_K) -> None:
        """Run the /knn micro-batch path once at every power-of-two batch
        size up to ``max_batch`` rounded up (the sizes coalescing pads to),
        so the first live batches find the kernels built and the per-table
        caches filled."""
        w0 = self.engine.store.words[0]
        b = 1
        while b <= _pow2(max_batch):
            self._run_knn_batch([(w0, k)] * b)
            b *= 2

    def run_plain(self, path: str, body: dict):
        """The endpoints that are not micro-batched, under the device
        lock."""
        eng = self.engine
        with self._lock:
            if path == "/knn_batch":
                return eng.knn_batch(body["queries"], int(body.get("k", 5)))
            if path == "/knn_join":
                # "targets" may be a list OR the name of a target set
                # registered via /prepare_targets (persistent-tile reuse).
                return eng.knn_join(body["queries"], int(body.get("k", 5)),
                                    body["targets"])
            if path == "/prepare_targets":
                ph = eng.prepare_targets(body["targets"], name=body["name"])
                return {"prepared": body["name"], "size": ph.size,
                        "build_s": round(ph.build_s, 4)}
            if path == "/analogy":
                return eng.analogy(body["w1"], body["w2"], body["w3"])
            if path == "/analogy_in":
                return eng.analogy_in(body["w1"], body["w2"], body["w3"],
                                      body["targets"])
            if path == "/groups":
                return eng.groups(body["tokens"], body["group_tokens"])
            if path == "/cluster":
                return eng.cluster(body["tokens"], int(body.get("k", 5)))
            if path == "/tokenize":
                fn = eng.tokenize_raw if body.get("raw") else eng.tokenize
                v = fn(body["text"])
                return None if v is None else v.tolist()
            if path == "/insert":
                return {"inserted": eng.insert_batch(body["terms"])}
            if path == "/statistics":
                eng.create_statistics(body["name"], body["domain"])
                return {"created": body["name"]}
            if path == "/config":
                applied = {}
                for key, val in body.items():
                    if not key.startswith("set_") or not hasattr(eng, key):
                        raise UnknownEndpoint(f"unknown setting {key!r}")
                    getattr(eng, key)(val)
                    applied[key] = val
                return {"applied": applied}
            raise UnknownEndpoint(f"unknown endpoint {path}")

    def health(self, requests: int, started: float) -> dict:
        """The /health body's engine part (the JAX servers' keys)."""
        eng = self.engine
        dev = eng.store.device
        name = str(dev)
        if dev.type == "cuda":
            name += f" ({torch.cuda.get_device_name(dev)})"
        return {
            "status": "ok",
            "vocab": eng.store.size,
            "dim": eng.store.dim,
            "indexes": {
                "pq": eng.pq is not None,
                "ivfadc": eng.ivfadc is not None,
                "ivpq": eng.ivpq is not None,
            },
            "device": name,
            "requests": requests,
            "knn_stage_s": {k: round(v, 3) for k, v in self.stage_s.items()},
            "uptime_s": round(time.time() - started, 1),
        }


def parse_knn_item(path: str, body: dict) -> tuple:
    """The micro-batch item of a /knn or /knn_in request body."""
    q = body.get("query")
    q = q if isinstance(q, str) else np.asarray(q, np.float32)
    if path == "/knn":
        return q, int(body.get("k", DEFAULT_K))
    return q, int(body.get("k", DEFAULT_K)), tuple(body["targets"])


class QueryServer:
    """Wraps an engine with a threaded HTTP server."""

    DEFAULT_K = DEFAULT_K

    def __init__(self, engine: Freddy, host: str = "127.0.0.1",
                 port: int = 8765, batch_window_ms: float = 2.0,
                 max_batch: int = 64):
        self.engine = engine
        self.runner = EngineRunner(engine)
        self.stage_s = self.runner.stage_s
        self._lock = self.runner._lock
        self._count_lock = threading.Lock()
        self._requests = 0
        self._started = time.time()
        self._max_batch = max_batch
        self._knn_batcher = _MicroBatcher(self.runner._run_knn_batch,
                                          max_batch=max_batch,
                                          window_ms=batch_window_ms)
        self._knn_in_batcher = _MicroBatcher(self.runner._run_knn_in_batch,
                                             max_batch=max_batch,
                                             window_ms=batch_window_ms)
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- control
    def warmup(self, k: int | None = None) -> None:
        """Run every power-of-two /knn batch shape coalescing can produce
        (see :meth:`EngineRunner.warmup`); ``k``: the handler default."""
        self.runner.warmup(self._max_batch,
                           self.DEFAULT_K if k is None else k)

    def start(self) -> "QueryServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    # ------------------------------------------------------------ dispatch
    def _handle(self, path: str, body: dict):
        with self._count_lock:
            self._requests += 1
        if path == "/knn":
            return self._knn_batcher.submit(parse_knn_item(path, body))
        if path == "/knn_in":
            return self._knn_in_batcher.submit(parse_knn_item(path, body))
        return self.runner.run_plain(path, body)

    def _knn_stats(self) -> dict:
        """Both micro-batchers' counters, each read under its own stats
        lock, so /health never reads a half-updated (calls, items, busy)
        triple."""
        out = {}
        for name, b in (("knn", self._knn_batcher),
                        ("knn_in", self._knn_in_batcher)):
            with b.stats_lock:
                out[f"{name}_batched_calls"] = b.batched_calls
                out[f"{name}_busy_s"] = round(b.busy_s, 3)
                out[f"{name}_items_done"] = b.items_done
                out[f"{name}_max_coalesced"] = b.max_coalesced
        return out

    def _health(self) -> dict:
        return {**self.runner.health(self._requests, self._started),
                **self._knn_stats()}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: keep-alive connections (Content-Length is always
            # set in _send, so persistent connections are safe).
            protocol_version = "HTTP/1.1"
            # headers and body leave in two writes: with Nagle's algorithm
            # on, the body waits for the client's delayed ACK of the
            # headers (~40 ms a response on Linux)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # silence default stderr log
                pass

            def _send(self, code: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, server._health())
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    result = server._handle(self.path, body)
                    self._send(200, {"result": result})
                except UnknownEndpoint as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — serve errors as 400
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        return Handler


def load_engine(argv: list[str], doc: str) -> tuple[Freddy, int]:
    """The CLIs' common start: ``argv = [prog, engine_dir, [port]]`` →
    the engine loaded on the card (it raises without one) and warmed up,
    and the port (default 8765)."""
    if len(argv) < 2:
        print(doc)
        raise SystemExit(1)
    engine = Freddy.load(argv[1])
    engine.warmup()
    return engine, int(argv[2]) if len(argv) > 2 else 8765


def main() -> None:
    """CLI: ``python -m postgres_word2vec_tpu_torch.server <engine_dir>
    [port]`` — serve a previously saved engine (see ``Freddy.save``; an
    engine saved by the JAX package loads too) on the card."""
    import sys

    engine, port = load_engine(sys.argv, __doc__)
    server = QueryServer(engine, port=port)
    server.warmup()   # every /knn micro-batch shape
    print(f"serving {engine.store.size} vectors on :{server.port} "
          f"({engine.store.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
