"""Profiling — the device-side view beside the TRACK-style Tracker.

Counterpart of ``postgres_word2vec_tpu/utils/profiling.py`` on
``torch.profiler``: :func:`device_trace` writes a Chrome trace of the
enclosed block (open it in Perfetto or ``chrome://tracing``),
:func:`annotate` names a span in it, :func:`device_busy_share` reads the
share of a window the card spent running work from such a trace, and
:func:`device_memory_stats` snapshots the caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch

#: the name of the trace file :func:`device_trace` writes in its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str | Path, *, host: bool = True):
    """Trace the enclosed block with ``torch.profiler`` and write
    ``log_dir/trace.json`` (Chrome trace format) when it exits. The card's
    kernels, copies and sets are recorded when CUDA is available; ``host``
    also records the host's torch operators (off to keep the tracing cost
    off a loaded server's threads). Yields ``log_dir`` as a string."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if not acts:
        raise ValueError("host=False records nothing without a CUDA device")
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield str(log_dir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


#: Chrome-trace categories of work that occupies the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_share(trace_path: str | Path, window_s: float) -> float:
    """The share of a ``window_s``-second window that the card was busy,
    from a trace written by :func:`device_trace`: the union of its kernel,
    copy and set intervals over the window."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in _DEVICE_CATS and "ts" in e)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        busy_us += e - max(s, end)
        end = e
    return busy_us / 1e6 / window_s


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
