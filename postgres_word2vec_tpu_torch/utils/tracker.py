"""Stage-timing instrumentation — the reference's ``TRACK`` notices, and
the spans and counters of a served statement.

The reference brackets kernel stages with ``clock()`` and emits
``elog(INFO, "TRACK <metric> <value>")`` (freddy.c:527-651,
ivpq_search_in.c:233-697); the Python side scrapes psycopg2 notices
(evaluation/tracking.py:6-17). Here the emitter and scraper collapse into
one in-process recorder with the same metric names (:data:`TRACK_METRICS`):

    precomputation_time, query_construction_time, data_retrieval_time,
    computation_time, total_time, retrieved, target_count

A stage is timed on the host clock. PyTorch returns before the device
finishes, so a stage around device work measures its enqueue unless the
work ends in a host read or a synchronise.

The server's layers record more names the same way: spans (seconds) and
counters (one value a statement). While a ``torch.profiler`` records in
this process, each span also appends a :class:`SpanRecord` to the bounded
ring :attr:`Tracker.ring`: request id, span id, parent span id, name,
thread, and its start and end on the Unix clock in ns, the clock of the
profiler's Chrome trace, into which :func:`.profiling.device_trace` writes
them. With no profiler, a span costs one flag test, two clock reads and
one list append.

:func:`host` reads a tensor to the host and counts the read on its
thread (:func:`host_reads`): on the card each such read waits for the
stream. ``Freddy.knn_in_ivpq_batch`` records a statement's count as
``join_host_reads``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: the reference's TRACK metric names
TRACK_METRICS = ("precomputation_time", "query_construction_time",
                 "data_retrieval_time", "computation_time", "total_time",
                 "retrieved", "target_count")

#: span records the ring keeps: a served /knn_join statement records
#: about 7 spans, and a 51 s window has held up to ~2,200 statements
#: (~15,000 records); four times that, rounded up
RING_SIZE = 65536


class SpanRecord(NamedTuple):
    """One span, recorded while a profiler recorded (Unix-clock ns)."""
    request: int        # request id, 0 outside a request
    span: int           # span id
    parent: int         # parent span id, 0 at the top
    name: str
    thread: str         # the thread that opened it
    start_ns: int
    end_ns: int


class Span:
    """A timed interval into the tracker list ``name``. As a context
    manager it times a block on one thread, and spans opened inside it on
    that thread are its children; :meth:`Tracker.begin` opens one that
    :meth:`end` closes, on any thread."""

    __slots__ = ("_tracker", "name", "request", "parent", "id", "_t0",
                 "_thread", "seconds")

    def __init__(self, tracker: "Tracker", name: str, parent: int | None,
                 request: int | None):
        self._tracker = tracker
        self.name = name
        self.parent = parent
        self.request = request
        self.id = 0
        self._t0 = None
        #: the span's length once it has ended
        self.seconds = 0.0

    def start(self) -> "Span":
        # set from a profiler's start to its stop, whichever thread runs it
        if _autograd_profiler._is_profiler_enabled:
            self._tracker._open(self)
        self._t0 = time.perf_counter_ns()
        return self

    def end(self) -> None:
        """Close the span (a second call does nothing)."""
        t1 = time.perf_counter_ns()
        t0, self._t0 = self._t0, None
        if t0 is None:
            return
        self.seconds = (t1 - t0) / 1e9
        self._tracker.track(self.name, self.seconds)
        if self.id:
            self._tracker._close(self, t0, t1)

    def __enter__(self) -> "Span":
        self.start()
        if self.id:
            self._tracker._stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.id:
            stack = self._tracker._stack()
            if stack and stack[-1] is self:
                stack.pop()
        self.end()


class Tracker:
    """Metric recorder with the reference Tracker's query surface
    (evaluation/tracking.py: ``get_results`` → dict of metric → [values]),
    safe to record into from several threads."""

    def __init__(self) -> None:
        self._values: dict[str, list[float]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        #: the spans recorded while a profiler recorded, oldest first
        self.ring: deque[SpanRecord] = deque(maxlen=RING_SIZE)
        #: Unix ns minus ``perf_counter_ns``, taken when recording starts
        self._offset_ns = 0
        self._recording = False

    def track(self, metric: str, value: float) -> None:
        lst = self._values.get(metric)
        if lst is None:
            with self._lock:
                lst = self._values.setdefault(metric, [])
        lst.append(float(value))

    def span(self, name: str) -> Span:
        """``with tracker.span(name):`` times the block (seconds into
        ``name``); its parent is the span open around it on this
        thread."""
        return Span(self, name, None, None)

    #: the reference's name for a span
    stage = span

    def begin(self, name: str, *, request: int | None = None) -> Span:
        """Open a span that ``end()`` closes, on this or another thread; it
        has no parent."""
        return Span(self, name, 0, request).start()

    def new_request(self) -> int:
        """A new request id."""
        return next(self._ids)

    @contextlib.contextmanager
    def request(self, request: int | None):
        """Spans opened on this thread inside the block belong to
        ``request``."""
        prev = getattr(self._local, "request", None)
        self._local.request = request
        try:
            yield
        finally:
            self._local.request = prev

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, span: Span) -> None:
        """The recording half of :meth:`Span.start`."""
        if not self._recording:
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
            self._recording = True
        span.id = next(self._ids)
        if span.request is None:
            span.request = getattr(self._local, "request", None)
        if span.parent is None:
            stack = self._stack()
            span.parent = stack[-1].id if stack else 0
        span._thread = threading.current_thread().name

    def _close(self, span: Span, t0: int, t1: int) -> None:
        off = self._offset_ns
        self.ring.append(SpanRecord(span.request or 0, span.id, span.parent,
                                    span.name, span._thread, t0 + off,
                                    t1 + off))
        if not _autograd_profiler._is_profiler_enabled:
            self._recording = False

    def get_results(self) -> dict[str, list[float]]:
        with self._lock:
            items = list(self._values.items())
        return {k: list(v) for k, v in items}

    def track_results(self) -> dict[str, list[float]]:
        """:meth:`get_results` of the reference's TRACK names only (the
        server's spans and counters left out)."""
        return {k: v for k, v in self.get_results().items()
                if k in TRACK_METRICS}

    def clear_track(self) -> None:
        with self._lock:
            self._values.clear()
        self.ring.clear()


_reads = threading.local()


def host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one device → host read on this thread."""
    _reads.n = getattr(_reads, "n", 0) + 1
    return t.cpu()


def host_reads() -> int:
    """The reads :func:`host` has made on this thread so far."""
    return getattr(_reads, "n", 0)


#: Process-global tracker the engine reports into (mirrors the reference's
#: connection-scoped notice stream).
GLOBAL_TRACKER = Tracker()
