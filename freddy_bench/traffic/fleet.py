"""The benchmark's load generator: closed-loop HTTP clients.

A frozen copy, adapted, of ``client_window``, ``ClientFleet``,
``stop_resource_tracker`` and ``child_processes`` of
``postgres_word2vec_tpu_torch/evaluation/serving_bench.py`` at commit
abbb0ce: raw-socket closed loops (prebuilt request bytes, a
content-length reader) in a process started with the ``spawn`` method.
This module imports neither torch nor the program, so the client process
touches no CUDA. What the copy changes:

- the clients are connections of ONE process, driven by one selector on
  one core of their own (:func:`loop_window`), where the original ran a
  process a client: 32 client processes on the host's 8 cores compete
  with the server for its cores, one process on a core of its own does
  not;
- every request is timed, failed ones too (a failed request is ``None``:
  beyond any latency limit), and the count of answers completed inside
  the window is kept apart from the requests sent in it, whose last one
  may complete after the window closes (its latency still counts);
- the query words come from a generator seeded by the run's seed, the
  client id and the phase (warm-up or window), uniform over the store;
- a sample of the answers, drawn from the same seed, is kept as sent,
  with the ids asked for, for the comparison with the reference;
- one command opens the window and another collects it, so that the
  caller can mark the window's edges (for a profiler) while it runs.
"""

from __future__ import annotations

import contextlib
import gc
import json
import multiprocessing as mp
import os
import queue
import socket
import threading
import time

import numpy as np

#: the longest wait for every client to connect (or report) a window
READY_TIMEOUT_S = 120.0


class _Conn:
    """One closed-loop connection of :func:`loop_window`."""

    def __init__(self, cid, sock, seed, phase):
        self.cid, self.sock = cid, sock
        self.words = np.random.default_rng((seed, cid, phase, 0))
        self.pick = np.random.default_rng((seed, cid, phase, 1))
        self.out = b""
        self.buf = b""
        self.t0 = 0.0
        self.ids = None
        self.keep = False
        self.rep = {"lat": [], "in_window": 0, "errors": 0,
                    "error_kinds": {}, "samples": [], "sent_ids": [],
                    "per_second": []}


def loop_window(port: int, seconds: float, ready, *, clients: int,
                path: str, n: int, query_words: int, body: dict, seed: int,
                phase: int, sample_p: float, timeout_s: float,
                keep_ids: bool) -> list[dict]:
    """``clients`` connections from one thread for one window. Each
    request asks for ``query_words`` words ``w{i}`` with ``i`` uniform
    over ``[0, n)`` (one: ``{"query": w}``, more: ``{"queries": [...]}``)
    plus ``body``. ``ready()`` is called once every connection is up and
    returns when the window opens. Each connection sends its next
    request when its answer is in, while the window is open; a request's
    latency runs from its send.

    → reports, one a connection: ``lat`` (seconds per
    request, None where it failed), ``in_window`` (answers with status 200
    completed before the close), ``errors``, ``error_kinds``, ``samples``
    (the ids asked for and the raw answer of each sampled request with
    status 200), with ``keep_ids`` ``sent_ids`` (every id asked for),
    and ``per_second`` (answers completed in each second)."""
    import selectors

    extra = json.dumps(body)[1:-1]
    extra = (", " + extra) if extra else ""
    sel = selectors.DefaultSelector()
    conns = []
    for c in range(clients):
        s = socket.create_connection(("127.0.0.1", port), timeout=timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        conns.append(_Conn(c, s, seed, phase))
    ready()
    now = time.perf_counter
    t_open = now()
    stop_t = t_open + seconds

    def fail(c, kind):
        c.rep["lat"].append(None)
        c.rep["errors"] += 1
        c.rep["error_kinds"][kind] = c.rep["error_kinds"].get(kind, 0) + 1

    def send_next(c):
        c.ids = c.words.integers(0, n, query_words)
        c.keep = bool(c.pick.random() < sample_p)
        if query_words == 1:
            q = '{"query": "w%d"%s}' % (c.ids[0], extra)
        else:
            q = '{"queries": [%s]%s}' % (
                ", ".join('"w%d"' % i for i in c.ids), extra)
        data = q.encode()
        c.out = (f"POST {path} HTTP/1.1\r\nHost: l\r\n"
                 f"Content-Type: application/json\r\nContent-Length: "
                 f"{len(data)}\r\n\r\n").encode() + data
        if keep_ids:
            c.rep["sent_ids"].extend(int(i) for i in c.ids)
        c.t0 = now()
        c.deadline = now() + timeout_s
        sel.register(c.sock, selectors.EVENT_WRITE, c)

    def on_answer(c, head, payload):
        t1 = now()
        if head.startswith(b"HTTP/1.1 200"):
            c.rep["lat"].append(t1 - c.t0)
            if t1 <= stop_t:
                c.rep["in_window"] += 1
                sec = int(seconds - (stop_t - t1))
                ps = c.rep["per_second"]
                ps.extend([0] * (sec + 1 - len(ps)))
                ps[sec] += 1
            if c.keep:
                c.rep["samples"].append(([int(i) for i in c.ids], payload))
        else:
            fail(c, "status:" + head.split(b" ", 2)[1].decode() + ":"
                 + payload[:80].decode(errors="replace"))
        if now() < stop_t:
            send_next(c)

    for c in conns:
        send_next(c)
    while sel.get_map():
        for key, mask in sel.select(timeout=0.5):
            c = key.data
            try:
                if mask & selectors.EVENT_WRITE:
                    sent = c.sock.send(c.out)
                    c.out = c.out[sent:]
                    if not c.out:
                        sel.modify(c.sock, selectors.EVENT_READ, c)
                    continue
                chunk = c.sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionError("closed")
                c.buf += chunk
                if b"\r\n\r\n" not in c.buf:
                    continue
                head, _, rest = c.buf.partition(b"\r\n\r\n")
                cl = int(head.lower().split(b"content-length:")[1]
                         .split(b"\r\n")[0])
                if len(rest) < cl:
                    continue
                c.buf = rest[cl:]
                sel.unregister(c.sock)
                on_answer(c, head, rest[:cl])
            except (OSError, ValueError, IndexError) as e:
                with contextlib.suppress(KeyError, ValueError):
                    sel.unregister(c.sock)
                fail(c, f"{type(e).__name__}: {str(e)[:80]}")
        t = now()
        for key in list(sel.get_map().values()):
            c = key.data
            if t > c.deadline:
                sel.unregister(c.sock)
                fail(c, "timeout")
    for c in conns:
        c.sock.close()
    sel.close()
    return [c.rep for c in conns]


def _loop_worker(cmd_q, out_q, barrier) -> None:
    """The client process of a :class:`ClientFleet`, on the last core the
    run may use: one :func:`loop_window` per command until None."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, {cores[-1]})
    while True:
        spec = cmd_q.get()
        if spec is None:
            return
        try:
            out = loop_window(
                ready=lambda: barrier.wait(timeout=READY_TIMEOUT_S), **spec)
        except Exception as e:  # noqa: BLE001 — reported to the parent
            out = {"fatal": f"client loop: {type(e).__name__}: {e}"}
        out_q.put(out)


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource-tracker process, if this process
    started one, and reap it, so that it cannot outlive the run."""
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
            fields = stat.rpartition(")")[2].split()
            if fields[1] != me or fields[0] == "Z":
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue                   # it ended while we looked
        out.append(f"{d} {cmd.strip()[:120]}")
    return out


class ClientFleet:
    """One client process for ``clients`` connections, started once with
    the ``spawn`` method and reused for every window. :meth:`open` starts
    a window and returns when every connection is up and the window is
    open; :meth:`collect` waits for the report. Use as a context manager:
    :meth:`close` stops every process it started."""

    def __init__(self, clients: int):
        ctx = mp.get_context("spawn")
        self.clients = clients
        self._cmd_q, self._out_q = ctx.Queue(), ctx.Queue()
        self._barrier = ctx.Barrier(2)
        self._procs = [ctx.Process(target=_loop_worker, daemon=True,
                                   args=(self._cmd_q, self._out_q,
                                         self._barrier))]
        for p in self._procs:
            p.start()

    def __enter__(self) -> "ClientFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the client process, then the resource tracker that the
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
        del q, queues
        self._procs = self._cmd_q = self._out_q = self._barrier = None
        gc.collect()
        stop_resource_tracker()

    def _dead(self) -> list:
        return [p.exitcode for p in self._procs if p.exitcode is not None]

    def open(self, seconds: float, **spec) -> float:
        """Send the client process one window of ``seconds`` (``spec``:
        the keywords of :func:`loop_window` but ``clients`` and
        ``ready``) and return the host clock at which it opened."""
        self._seconds = seconds
        self._cmd_q.put(dict(spec, seconds=seconds, clients=self.clients))
        try:
            self._barrier.wait(timeout=READY_TIMEOUT_S)
        except threading.BrokenBarrierError:
            raise RuntimeError(f"the clients did not connect (exit codes of "
                               f"dead ones: {self._dead()[:4]})") from None
        return time.perf_counter()

    def collect(self, late_s: float = 60.0) -> list[dict]:
        """Every connection's report of the window :meth:`open` started;
        a connection may take ``late_s`` past the close for its last
        answer."""
        try:
            rep = self._out_q.get(timeout=self._seconds + late_s
                                  + READY_TIMEOUT_S)
        except queue.Empty:
            raise RuntimeError(f"the clients did not report (exit codes of "
                               f"dead ones: {self._dead()[:4]})") from None
        if isinstance(rep, dict) and "fatal" in rep:
            raise RuntimeError(rep["fatal"])
        return rep
