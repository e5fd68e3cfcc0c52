"""Captured CUDA graphs of the IVPQ join's first budget round.

A budget round (``models/ivpq.py``) is a few hundred small device
operations a 512-query block: cell selection, the tile plan, the LUTs, the
budget kernel, top-k and the PV re-rank. Dispatched one at a time from
Python they keep the host busy while the card waits. The round makes one
host read, the largest selection's tile count that sizes the plan
(``fit_budget``), so it is captured as two graphs split at that read: the
selection, keyed on what it reads, and the scan, keyed also on the plan's
size. :class:`RoundGraphs` holds them for one index.

Its rules, all on what a call can observe:

- a key is captured the second time it is seen; its first sighting runs
  eager, so lazy start-up (kernel builds, cuBLAS handles, the fused-code
  cache) happens outside capture, and one-off shapes are never captured;
- an entry keeps weak references to the objects whose end ends it (the
  prepared target set, the statistics table) and the ``_version`` a
  tensor had at capture; every lookup first drops the entries and
  sightings whose objects died or changed in place;
- at most ``cap`` graphs are held, the least recently used dropped
  first; a scan graph reads its selection graph's outputs and is dropped
  with it;
- the graphs share one private memory pool, so the pool holds their
  outputs and one set of temporaries rather than each graph's own. A
  replay may overwrite any other graph's temporaries, so a caller replays
  a selection graph right before the scan that reads it and consumes or
  copies a replay's outputs before the next replay, on the same stream;
- each replay adds to :data:`.kernels.KERNELS` the launches its capture
  counted, so launch counts read as the eager round's.

Capture and replay are injectable: the CPU tests run these rules with a
capture that keeps the function and a replay that reruns it into the
captured outputs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Hashable

import torch

from postgres_word2vec_tpu_torch.ops import kernels


def _liveness(objs) -> tuple:
    """(weak reference, ``_version`` or None) for each object."""
    return tuple((weakref.ref(o), getattr(o, "_version", None))
                 for o in objs)


def _alive(liveness: tuple) -> bool:
    """True while every object lives and no tensor changed in place."""
    for ref, version in liveness:
        o = ref()
        if o is None or (version is not None and o._version != version):
            return False
    return True


@dataclasses.dataclass
class GraphEntry:
    """One captured graph with its static input buffers and outputs."""
    graph: object
    inputs: tuple               # buffers a replay's inputs are copied into
    outputs: tuple              # what the graph writes on each replay
    launches: dict              # kernel → launches one replay makes
    liveness: tuple
    parent: Hashable | None     # the selection graph a scan graph reads


@functools.lru_cache(maxsize=1)
def _cu_graph_launch():
    """The driver's ``cuGraphLaunch``, called with the GIL held (PyDLL)."""
    fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cuda_replay(graph, outputs) -> None:
    """Launch ``graph`` on the current stream through the driver, the GIL
    held. ``CUDAGraph.replay`` releases the GIL and first runs its random
    generators' prologue (ATen fills; these graphs draw no random
    numbers); with ``torch.profiler`` stopping on another thread, which
    holds the GIL throughout, such a replay was seen to deadlock with the
    stop. Holding the GIL for the launch (microseconds) keeps the two
    apart."""
    err = _cu_graph_launch()(graph.raw_cuda_graph_exec(),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuGraphLaunch failed with CUDA error {err}")


class RoundGraphs:
    """An LRU of captured round graphs (see the module docstring).

    ``capture(fn) → (graph, outputs)`` captures ``fn()``'s work and returns
    its outputs; ``replay(graph, outputs)`` reruns it into them;
    ``engages(x)`` says whether a tensor's device takes graphs (CUDA)."""

    #: keys seen once and remembered, the oldest forgotten first
    SEEN_CAP = 64

    def __init__(self, cap: int = 16, *, capture: Callable | None = None,
                 replay: Callable | None = None,
                 engages: Callable[[torch.Tensor], bool] | None = None):
        self.cap = max(int(cap), 2)
        self._capture = capture or self._cuda_capture
        self._replay = replay or _cuda_replay
        self._engages = engages or (lambda x: x.is_cuda)
        self._graphs: OrderedDict[Hashable, GraphEntry] = OrderedDict()
        self._seen: OrderedDict[Hashable, tuple] = OrderedDict()
        self._pool = None
        self._stream = None
        #: held across a round's replays and its host read
        self.lock = threading.RLock()
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def engages(self, x: torch.Tensor) -> bool:
        return self._engages(x)

    def clear(self) -> None:
        """Drop every graph and sighting (the pool goes with the last)."""
        with self.lock:
            self._graphs.clear()
            self._seen.clear()

    def run(self, key: Hashable, fn: Callable, inputs: tuple = (), *,
            alive: tuple = (), parent: Hashable | None = None
            ) -> GraphEntry | None:
        """Replay ``key``'s graph of ``fn(*inputs)`` (a flat tuple of
        tensors) with ``inputs`` copied into its buffers → its entry, whose
        ``outputs`` hold the result; None on the key's first sighting,
        where the caller runs ``fn`` eager. The second sighting captures.
        ``alive``: the objects whose end or in-place change ends the entry;
        ``parent``: the key of the graph whose outputs ``fn`` reads."""
        with self.lock:
            self._drop_dead()
            e = self._graphs.get(key)
            if e is None:
                if not self._sighted(key, alive):
                    return None
                e = self._capture_entry(key, fn, inputs, alive, parent)
            else:
                self._graphs.move_to_end(key)
            for buf, x in zip(e.inputs, inputs):
                buf.copy_(x)
            self._replay(e.graph, e.outputs)
            for name, n in e.launches.items():
                kernels.KERNELS[name].launches += n
            self.replays += 1
            return e

    # ------------------------------------------------------------ the rules
    def _sighted(self, key: Hashable, alive: tuple) -> bool:
        """True if ``key`` was seen before with its objects still alive;
        else record this sighting (the oldest past :data:`SEEN_CAP` go)."""
        prev = self._seen.pop(key, None)
        if prev is not None and _alive(prev):
            return True
        self._seen[key] = _liveness(alive)
        while len(self._seen) > self.SEEN_CAP:
            self._seen.popitem(last=False)
        return False

    def _drop_dead(self) -> None:
        for key in [k for k, e in self._graphs.items()
                    if not _alive(e.liveness)]:
            self._drop(key)
        for key in [k for k, lv in self._seen.items() if not _alive(lv)]:
            del self._seen[key]

    def _drop(self, key: Hashable) -> None:
        """Drop ``key``'s graph and the graphs that read its outputs."""
        if self._graphs.pop(key, None) is None:
            return
        for k in [k for k, e in self._graphs.items() if e.parent == key]:
            self._graphs.pop(k)

    def _capture_entry(self, key, fn, inputs, alive, parent) -> GraphEntry:
        static = tuple(x.clone() for x in inputs)
        launched: dict[str, int] = {}

        def counted():
            before = kernels.launch_counts()
            out = fn(*static)
            after = kernels.launch_counts()
            launched.clear()
            launched.update({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            return tuple(out)

        graph, outputs = self._capture(counted)
        # the captured call ran nothing on the device: its replays count
        for name, n in launched.items():
            kernels.KERNELS[name].launches -= n
        self.captures += 1
        while len(self._graphs) >= self.cap:
            victim = next(k for k in self._graphs if k != parent)
            self._drop(victim)
        e = GraphEntry(graph, static, tuple(outputs), dict(launched),
                       _liveness(alive), parent)
        self._graphs[key] = e
        return e

    def _cuda_capture(self, fn: Callable) -> tuple:
        """Capture ``fn()`` on a side stream into the shared pool, after
        one eager warm-up call there (PyTorch's pattern: per-stream lazy
        state is made outside capture). A capture error mode of
        ``thread_local`` leaves other threads' CUDA calls alone."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        if not self._graphs:
            # a pool whose graphs all ended is released, not reused
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            fn()
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return graph, outputs
