"""Profiling — the device-side view beside the TRACK-style Tracker.

Counterpart of ``postgres_word2vec_tpu/utils/profiling.py`` on
``torch.profiler``: :func:`device_trace` writes a Chrome trace of the
enclosed block (open it in Perfetto or ``chrome://tracing``),
:func:`annotate` names a span in it (the tracker's spans show there too,
:mod:`.tracker`), and :func:`device_memory_stats` snapshots the caching
allocator's counters.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER

#: the name of the trace file :func:`device_trace` writes in its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str | Path, *, host: bool = True):
    """Trace the enclosed block with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format) when it exits. The card's
    kernels, copies and sets are recorded when CUDA is available; ``host``
    also records the host's torch operators (off to keep the tracing cost
    off a loaded server's threads). The tracker's spans recorded
    meanwhile, on every thread (a server's front end and engine thread
    too), are added to the trace, one track a thread, category ``span``.
    Yields ``log_dir`` as a string."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if not acts:
        raise ValueError("host=False records nothing without a CUDA device")
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield str(log_dir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = log_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    spans = [r for r in list(GLOBAL_TRACKER.ring) if r.start_ns >= t0]
    if spans:
        _add_spans(path, spans)


def _add_spans(path: Path, spans: list) -> None:
    """Write the tracker's span records into the Chrome trace at
    ``path`` (its ``ts`` are µs after its ``baseTimeNanoseconds``)."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    pid, tids = os.getpid(), {}
    events = trace.setdefault("traceEvents", [])
    for r in spans:
        if r.thread not in tids:
            tids[r.thread] = tid = 1_000_000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": r.thread}})
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                       "tid": tids[r.thread],
                       "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"request": r.request, "span": r.span,
                                "parent": r.parent}})
    path.write_text(json.dumps(trace))


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Live / peak / limit device memory in bytes under the JAX package's
    keys (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), from
    the caching allocator; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(0).total_memory}
