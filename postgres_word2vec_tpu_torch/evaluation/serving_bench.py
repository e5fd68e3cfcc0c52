#!/usr/bin/env python3
"""End-to-end serving throughput: concurrent single-query clients against
the port's HTTP runtime on the card, swept over the knn dispatch families.

Counterpart of ``evaluation/serving_bench.py`` for the PyTorch port. The
reference's serving layer is Postgres itself (concurrent backends, one
process per connection). This measures the standalone equivalent: a fleet
of closed-loop single-query clients whose requests the server coalesces
into one device batch per window (micro-batching).

Each family in ``--families`` (exact, pq, pq_pv, ivfadc, ivfadc_pv) is a
separate measured window with ``dispatch['knn']`` switched through
``/config {"set_knn_function": ...}`` — the serving twin of the
reference's ``set_knn_function`` (sql:78-92). ``--echo-floor`` first runs
the same fleet against a canned-response server on the same HTTP reader
(no engine, no device): the host's ceiling for this transport.

The clients are raw-socket loops in separate processes
(:class:`ClientFleet`), started once with the ``spawn`` method and reused
for every window; this module imports neither torch nor the engine at
import time, so a client process touches no CUDA. They share the host's
cores with the server, so the report records ``os.cpu_count()``. The
exact family is served on the fused bf16 index (kernel K1).

Usage: python -m postgres_word2vec_tpu_torch.evaluation.serving_bench
       [--n 3072000] [--clients 32] [--seconds 10]
       [--families exact,pq_pv,ivfadc_pv] [--echo-floor]
       [--out chiprun_out/serving.json]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import multiprocessing as mp
import os
import queue
import socket
import subprocess
import threading
import time
import urllib.request

import numpy as np

#: a client's socket timeout: a request unanswered this long is an error
SOCKET_TIMEOUT_S = 10.0

#: dispatch['knn'] implementation per sweep family name
FAMILY_IMPL = {
    "exact": "k_nearest_neighbour",
    "pq": "k_nearest_neighbour_pq",
    "pq_pv": "k_nearest_neighbour_pq_pv",
    "ivfadc": "k_nearest_neighbour_ivfadc",
    "ivfadc_pv": "k_nearest_neighbour_ivfadc_pv",
}


def log(msg) -> None:
    print(msg, flush=True)


def post(port: int, path: str, payload, timeout: float = 60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(port: int, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def client_window(cid: int, port: int, n: int, k: int, seconds: float,
                  check: str | None, ready, path: str = "/knn",
                  extra: str = "", batch: int = 1, seed: int = 0
                  ) -> tuple[list, int, dict]:
    """One closed-loop raw-socket client for one window: prebuilt request
    bytes and a content-length body reader instead of http.client's
    response machinery (the clients share the host's cores with the
    server, so their parsing cost would depress the measured server QPS).
    Each request asks for one random word ``w{i}`` (``batch`` > 1: a
    ``"queries"`` list of that many) with ``extra`` appended to the JSON
    body (e.g. ``', "targets": ...'``). ``ready()`` is called once
    connected and returns when the window opens.

    Every 64th 200-response is decoded and checked: ``check="self"`` wants
    the first row's first field to be the (first) query word (its own
    nearest neighbour; for joins the first row's query), ``"rows"`` a
    non-empty result, None nothing. → (latencies, errors, error kinds)."""
    r = np.random.default_rng((cid, seed))

    def connect():
        s = socket.create_connection(("127.0.0.1", port),
                                     timeout=SOCKET_TIMEOUT_S)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    sock = connect()
    buf = b""
    my_lat: list[float] = []
    err = 0
    err_kinds: dict = {}
    i = 0
    ready()
    stop_t = time.time() + seconds
    while time.time() < stop_t:
        if batch == 1:
            w = f"w{int(r.integers(0, n))}"
            body = '{"query": "%s", "k": %d%s}' % (w, k, extra)
        else:
            ws = [f"w{int(x)}" for x in r.integers(0, n, batch)]
            w = ws[0]
            body = '{"queries": %s, "k": %d%s}' % (json.dumps(ws), k, extra)
        body = body.encode()
        req = (f"POST {path} HTTP/1.1\r\nHost: l\r\n"
               f"Content-Type: application/json\r\nContent-Length: "
               f"{len(body)}\r\n\r\n").encode() + body
        t0 = time.perf_counter()
        try:
            sock.sendall(req)
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            cl = int(head.lower().split(b"content-length:")[1]
                     .split(b"\r\n")[0])
            while len(buf) < cl:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            payload, buf = buf[:cl], buf[cl:]
            if head.startswith(b"HTTP/1.1 200"):
                my_lat.append(time.perf_counter() - t0)
                if check and i % 64 == 0:
                    rows = json.loads(payload)["result"]
                    if not rows or (check == "self" and rows[0][0] != w):
                        raise ValueError(f"bad answer for {w}: {rows[:1]}")
            else:
                err += 1
                # classify by status and the first bytes of the error body
                kind = ("status:" + head.split(b" ", 2)[1].decode()
                        + ":" + payload[:80].decode(errors="replace"))
                err_kinds[kind] = err_kinds.get(kind, 0) + 1
        except Exception as e:  # noqa: BLE001 — counted, then reconnect
            err += 1
            kind = f"{type(e).__name__}: {str(e)[:80]}"
            err_kinds[kind] = err_kinds.get(kind, 0) + 1
            with contextlib.suppress(OSError):
                sock.close()
            buf = b""
            try:
                sock = connect()
            except OSError:
                break
        i += 1
    sock.close()
    return my_lat, err, err_kinds


def _fleet_worker(cid: int, cmd_q, out_q, barrier) -> None:
    """A client process: one window per command until a None command.
    The barrier opens each window for every client at once, after all
    have connected."""
    while True:
        spec = cmd_q.get()
        if spec is None:
            return
        out_q.put(client_window(
            cid, ready=lambda: barrier.wait(timeout=_READY_TIMEOUT_S),
            **spec))


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource-tracker process, if this process
    started one, and reap it. Left alone, in older Python releases it
    exits only after this interpreter does, and so outlives the program
    that spawned the clients."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is None:
            return
        os.close(tracker._fd)          # EOF on its pipe ends its loop
        tracker._fd = None
        if tracker._pid is not None:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(tracker._pid, 0)
            tracker._pid = None


def child_processes() -> list[str]:
    """The live children of this process (Linux ``/proc``), as
    ``"pid command"`` strings: empty once every process it started has
    been stopped and reaped."""
    me = str(os.getpid())
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            # the command sits in parentheses and may hold spaces
            fields = stat.rpartition(")")[2].split()
            if fields[1] != me or fields[0] == "Z":
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue                   # it ended while we looked
        out.append(f"{d} {cmd.strip()[:120]}")
    return out


#: the longest wait for every client to connect (or report) a window
_READY_TIMEOUT_S = 120.0


class ClientFleet:
    """``clients`` client processes, started once with the ``spawn``
    method and reused for every window (starting 32 interpreters costs
    seconds on a busy host). Use as a context manager; :meth:`window`
    runs one measured window."""

    def __init__(self, clients: int):
        ctx = mp.get_context("spawn")
        self.clients = clients
        self._cmd_q, self._out_q = ctx.Queue(), ctx.Queue()
        self._barrier = ctx.Barrier(clients + 1)
        self._windows = 0
        self._procs = [ctx.Process(target=_fleet_worker, daemon=True,
                                   args=(i, self._cmd_q, self._out_q,
                                         self._barrier))
                       for i in range(clients)]
        for p in self._procs:
            p.start()

    def __enter__(self) -> "ClientFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop every client, then the resource tracker that the first
        spawn started: no process of the fleet outlives this call."""
        if self._procs is None:
            return
        for _ in self._procs:
            self._cmd_q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        queues = [self._cmd_q, self._out_q]
        for q in queues:
            q.close()
            q.join_thread()
        # the queues' and the barrier's semaphores unregister with the
        # tracker when collected: drop every reference before it stops
        del q, queues
        self._procs = self._cmd_q = self._out_q = self._barrier = None
        gc.collect()
        stop_resource_tracker()

    def _dead(self) -> list:
        return [p.exitcode for p in self._procs if p.exitcode is not None]

    def window(self, port: int, n: int, k: int, seconds: float, *,
               path: str = "/knn", extra: str = "", batch: int = 1,
               check: str | None = "self", busy: bool = False) -> dict:
        """One measured window of every client against ``port`` →
        completed requests, errors, wall time, QPS and latency
        percentiles. With ``busy``, ``busy_share`` reports the share of one
        second in the middle of the window that the card ran a kernel
        (:func:`_busy_second`)."""
        self._windows += 1
        spec = dict(port=port, n=n, k=k, seconds=seconds, check=check,
                    path=path, extra=extra, batch=batch, seed=self._windows)
        for _ in self._procs:
            self._cmd_q.put(spec)
        try:
            self._barrier.wait(timeout=_READY_TIMEOUT_S)
        except threading.BrokenBarrierError:
            raise RuntimeError(f"the clients did not connect (exit codes of "
                               f"dead ones: {self._dead()[:4]})") from None
        t0 = time.perf_counter()
        busy_share = _busy_second(seconds) if busy else None
        lat: list[float] = []
        errors = 0
        err_kinds: dict = {}
        for _ in self._procs:
            try:
                my_lat, err, kinds = self._out_q.get(
                    timeout=seconds + _READY_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"a client did not report (exit codes of "
                                   f"dead ones: {self._dead()[:4]})") \
                    from None
            for kk, vv in kinds.items():
                err_kinds[kk] = err_kinds.get(kk, 0) + vv
            lat.extend(my_lat)
            errors += err
        wall = time.perf_counter() - t0
        lat_ms = np.sort(np.asarray(lat)) * 1e3

        def pct(p):
            return float(np.percentile(lat_ms, p)) if lat_ms.size else None

        out = {"completed": int(lat_ms.size), "errors": errors,
               "wall_s": wall, "qps": lat_ms.size / wall,
               "latency_ms": {"p50": pct(50), "p95": pct(95),
                              "p99": pct(99)}}
        if busy_share is not None:
            out["busy_share"] = busy_share
        if err_kinds:
            out["error_kinds"] = err_kinds
        return out


def _busy_second(seconds: float) -> float:
    """Wait until a third of the window has passed, then sample the card's
    utilization for one second (NVML's share of time in which a kernel ran,
    ``nvidia-smi --query-gpu=utilization.gpu`` every 100 ms) → its mean
    share. Not a ``torch.profiler`` trace: stopping one while the servers
    run crashed the process (a segmentation fault or a corrupted heap in
    the profiler's stop, once server threads had come and gone)."""
    span = min(1.0, seconds / 3)
    time.sleep(seconds / 3)
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(span)
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    return utilization_share(out)


def utilization_share(samples: str) -> float:
    """The mean of ``nvidia-smi``'s utilization samples (percent, one a
    line) as a share."""
    vals = [float(x) for x in samples.split()]
    if not vals:
        raise RuntimeError("nvidia-smi reported no utilization sample")
    return sum(vals) / len(vals) / 100.0


@contextlib.contextmanager
def echo_server(k: int):
    """A canned-response server on the port's HTTP reader
    (``server_async``), on a loop of its own thread: what the transport
    alone costs, with no engine and no device. Yields its port."""
    from postgres_word2vec_tpu_torch.server_async import (_BadRequest,
                                                          _read_request,
                                                          _response)

    canned = {"result": [[f"w{i}", 0.5] for i in range(k)]}
    ready = threading.Event()
    box: dict = {}

    async def conn(reader, writer):
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _BadRequest:
                    break
                if req is None:
                    break
                writer.write(_response(200, canned, req[3]))
                await writer.drain()
                if not req[3]:
                    break
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def main():
        srv = await asyncio.start_server(conn, "127.0.0.1", 0)
        box["port"] = srv.sockets[0].getsockname()[1]
        box["loop"] = asyncio.get_running_loop()
        box["stop"] = asyncio.Event()
        ready.set()
        await box["stop"].wait()
        srv.close()

    th = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    th.start()
    if not ready.wait(30):
        raise RuntimeError("echo server failed to start")
    try:
        yield box["port"]
    finally:
        box["loop"].call_soon_threadsafe(box["stop"].set)
        th.join(timeout=10)


def run_echo_floor(fleet: ClientFleet, seconds: float, k: int) -> dict:
    """A window of ``fleet`` against :func:`echo_server`."""
    with echo_server(k) as port:
        return fleet.window(port, 10, k, seconds, check=None)


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--depth", type=int, default=2,
                    help="async server pipeline depth (in-flight batches)")
    ap.add_argument("--families", default="exact,pq_pv,ivfadc_pv",
                    help="comma list of " + ",".join(FAMILY_IMPL))
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--server", choices=("threaded", "async"),
                    default="async")
    ap.add_argument("--echo-floor", action="store_true",
                    help="also measure the no-engine transport floor")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "serving.json"))
    args = ap.parse_args()
    families = [f.strip() for f in args.families.split(",") if f.strip()]
    unknown = [f for f in families if f not in FAMILY_IMPL]
    if unknown:
        raise SystemExit(f"unknown families {unknown}; "
                         f"one of {sorted(FAMILY_IMPL)}")

    import torch

    from postgres_word2vec_tpu_torch import ExactIndex, Freddy, VectorStore
    from postgres_word2vec_tpu_torch.evaluation import synth
    from postgres_word2vec_tpu_torch.server import QueryServer
    from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer

    if not torch.cuda.is_available():
        raise SystemExit("serving_bench: no CUDA device; it measures the "
                         "card")
    card = gpu_line()
    need_pq = any(f.startswith("pq") for f in families)
    need_ivf = any(f.startswith("ivfadc") for f in families)
    log(f"serving_bench: N={args.n} clients={args.clients} "
        f"families={families} card={card} cpus={os.cpu_count()}")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    store = VectorStore.from_arrays([f"w{i}" for i in range(args.n)],
                                    synth.generate_wordlike(gen, args.n,
                                                            args.d),
                                    normalized=True)
    eng = Freddy.build(store, with_pq=need_pq, with_ivfadc=need_ivf,
                       with_ivpq=False, exact_dtype="bfloat16",
                       exact_approx=True)
    eng.exact = ExactIndex(store.vectors_norm, "bfloat16", approx=True,
                           fused=True)
    eng.warmup()
    log(f"engine up in {time.perf_counter() - t0:.1f}s "
        f"(pq={need_pq} ivfadc={need_ivf})")
    if args.server == "async":
        srv = AsyncQueryServer(eng, port=0, max_batch=args.max_batch,
                               batch_window_ms=args.window_ms,
                               pipeline_depth=args.depth)
    else:
        srv = QueryServer(eng, port=0, max_batch=args.max_batch,
                          batch_window_ms=args.window_ms)
    srv.start()
    results = {
        "n": args.n, "clients": args.clients, "seconds": args.seconds,
        "k": args.k, "max_batch": args.max_batch,
        "window_ms": args.window_ms, "pipeline_depth": args.depth,
        "host_cpus": os.cpu_count(), "gpu": card, "server": args.server,
        "families": {},
        "note": "concurrent single-query /knn clients (separate processes "
                "sharing the host's cores with the server); the server "
                "coalesces them into device batches; one window per knn "
                "dispatch family",
    }
    fleet = ClientFleet(args.clients)
    try:
        if args.echo_floor:
            w = run_echo_floor(fleet, args.seconds, args.k)
            results["echo_floor"] = w
            log(f"[echo-floor] qps={w['qps']:.0f} "
                f"p50={w['latency_ms']['p50']}ms on {card}")
        for fam in families:
            post(srv.port, "/config", {"set_knn_function": FAMILY_IMPL[fam]})
            t0 = time.perf_counter()
            srv.warmup(k=args.k)
            log(f"[{fam}] warm in {time.perf_counter() - t0:.1f}s")
            trials = []
            for rep in range(args.repeats):
                w = fleet.window(srv.port, args.n, args.k, args.seconds,
                                 check="rows")
                trials.append(w)
                log(f"[{fam}] trial {rep}: qps={w['qps']:.0f} "
                    f"p50={w['latency_ms']['p50']}ms "
                    f"p99={w['latency_ms']['p99']}ms errors={w['errors']}"
                    + (f" kinds={w['error_kinds']}"
                       if w.get("error_kinds") else "") + f" on {card}")
            results["families"][fam] = {
                "impl": FAMILY_IMPL[fam], "trials": trials,
                "qps_median": float(np.median([t["qps"] for t in trials]))}
        results["health"] = get(srv.port, "/health")
    finally:
        fleet.close()
        srv.stop()
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
