"""The device's view of the measured window, from ``torch.profiler``.

The profiler starts in the run's own process before the server serves
anything, with device activities only, and records nothing until the
window opens (:meth:`DeviceTrace.open`); it stops recording when the
window closes (:meth:`DeviceTrace.close`), while the server's threads
still live. What it recorded is read from its Chrome trace: each kernel,
copy and set on the card, with its start and duration.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict

#: Chrome-trace categories of work that occupies the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A device operation's name without its template and argument lists
    (``void at::native::reduce_kernel<512, …>(…)`` → ``at::native::
    reduce_kernel``); copies and sets keep theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


@dataclasses.dataclass
class TraceData:
    """The device operations of one traced window."""
    window_s: float
    events: list          # (name, category, start µs, duration µs)

    @property
    def kernel_s(self) -> float:
        """Seconds of kernel execution, summed."""
        return sum(e[3] for e in self.events if e[1] == "kernel") / 1e6

    def busy_intervals(self) -> list[tuple[float, float, str]]:
        """The union of the device operations' intervals, in µs, each
        with the name of the operation that ended it."""
        out: list = []
        for name, _cat, ts, dur in sorted(self.events, key=lambda e: e[2]):
            if out and ts <= out[-1][1]:
                if ts + dur > out[-1][1]:
                    out[-1] = (out[-1][0], ts + dur, name)
            else:
                out.append((ts, ts + dur, name))
        return out

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        return sum(e - s for s, e, _ in self.busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        after each kind of operation (what the card last did before the
        host gave it more), longest first; names shortened."""
        ops: dict = defaultdict(float)
        for name, _cat, _ts, dur in self.events:
            ops[short_name(name)] += dur / 1e6
        gaps: dict = defaultdict(float)
        iv = self.busy_intervals()
        for (_s0, e0, name), (s1, _e1, _n) in zip(iv, iv[1:]):
            gaps[f"after {short_name(name)}"] += (s1 - e0) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda x: -x[1])[:top]}


class DeviceTrace:
    """A profiler over the card that records only the window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.data: TraceData | None = None
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1),
                             on_trace_ready=self._ready)
        self._t_open = self._window_s = 0.0

    def start(self) -> None:
        """Start the profiler (warming up, recording nothing)."""
        self._prof.__enter__()

    def open(self) -> None:
        self._prof.step()
        self._t_open = time.perf_counter()

    def close(self) -> None:
        """Stop recording; the trace is read here."""
        import torch

        torch.cuda.synchronize()
        self._window_s = time.perf_counter() - self._t_open
        self._prof.step()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def _ready(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        events = [(e.get("name", "?"), e["cat"], float(e["ts"]),
                   float(e.get("dur", 0.0)))
                  for e in raw if e.get("cat") in DEVICE_CATS and "ts" in e]
        self.data = TraceData(self._window_s, events)
