"""The program's spans on the device trace's clock.

While the profiler records, the program's tracker keeps each span in a
ring (``utils/tracker.py``: request, span and parent ids, name, thread,
start and end in Unix-clock ns). The device trace (:mod:`.trace`) keeps
each operation's ``ts`` in µs after a base it does not keep. The base is
recovered from the spans themselves: a ``join_read_time`` span waits for
the statement's result copy (device → host) and ends just after it, so
its end, less the base, falls just after the end of such a copy. The base
is the offset at which the most span ends fall within :data:`PEAK_US`
after a copy's end; it holds when the median span end falls within
:data:`FIT_US` after one and :data:`MIN_WITHIN` of them within
:data:`LATE_US`. (A share of the span ends falls later: while another
thread holds the GIL, the engine thread resumes late from the copy; in a
slow stretch of a window most of them do. On the card the offset found
lay within 10 µs of the trace's own base, and 77.5–98.1 % of the span
ends lay within 1 ms after a copy's end, in five traced runs.)
"""

from __future__ import annotations

import bisect
import statistics
from collections import Counter, defaultdict

#: the span whose end follows a device → host copy's end
ANCHOR = "join_read_time"
#: the engine-thread spans in which the statement searches and reads
SEARCH_SPANS = ("join_search_time", "join_read_time")
#: a span end this close after a copy's end fits it (µs)
FIT_US = 100.0
#: the width of the densest cluster of span ends after copy ends that
#: sets the offset (µs): the read's own copy is followed by its span's end
#: after the thread's wake-up alone, more tightly than any other copy by
#: any other span end (the done check's copy by the search's return, the
#: counts' copies by the read's end)
PEAK_US = 20.0
#: span ends reported as late after their copy's end beyond this (µs)
LATE_US = 1000.0
#: the least share of span ends within LATE_US after a copy's end for an
#: alignment to hold: below the five readings on the card (0.775–0.981),
#: above the half that a median within FIT_US implies
MIN_WITHIN = 0.6
#: anchors used to find the offset roughly, and how far around it the
#: exact offset is looked for (µs)
COARSE_ANCHORS = 48
NEAR_US = 5000.0
#: fewest anchors an alignment is tried on
MIN_ANCHORS = 8


def ring_records() -> list:
    """The program's span ring, oldest first; [] where the program keeps
    none."""
    try:
        from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER
    except ImportError:
        return []
    return list(getattr(GLOBAL_TRACKER, "ring", ()))


def copy_ends(trace) -> list[float]:
    """The ends of the trace's device → host copies (trace µs), sorted."""
    return sorted(ts + dur for name, cat, ts, dur in trace.events
                  if cat == "gpu_memcpy" and name.startswith("Memcpy DtoH"))


def _best_offset(anchors: list[float], ends: list[float], width: float,
                 near: float | None = None, around: float = 0.0) -> float:
    """The offset ``o`` at which most anchors ``a`` have a copy end in
    ``[a - o - width, a - o]``, the largest such (the one at which the
    closest anchor's copy ends at its very end). ``near`` limits the pairs
    to offsets within ``near`` of ``around``."""
    marks = []
    for a in anchors:
        if near is None:
            js = range(len(ends))
        else:
            js = range(bisect.bisect_left(ends, a - around - near),
                       bisect.bisect_right(ends, a - around + near))
        for j in js:
            d = a - ends[j]
            marks.append((d - width, 1))     # the window reaches the copy
            marks.append((d, -1))            # and leaves it past ``d``
    marks.sort(key=lambda m: (m[0], -m[1]))
    best, best_at, n = -1, 0.0, 0
    for x, step in marks:
        n += step
        if step > 0 and n >= best:
            best = n
        elif step < 0 and n + 1 == best:
            best_at = x
    return best_at


def residuals(anchors: list[float], ends: list[float],
              offset: float) -> list[float]:
    """How long after the last copy end before it each anchor falls, at
    ``offset`` (µs); inf where no copy ended before it."""
    out = []
    for a in anchors:
        x = a - offset
        j = bisect.bisect_right(ends, x) - 1
        out.append(x - ends[j] if j >= 0 else float("inf"))
    return out


def align(anchors_ns: list[int], ends: list[float]):
    """The offset (Unix ns, an integer) whose difference from a span's
    Unix-clock ns, in µs, is the trace's clock, with the anchors'
    residuals there (µs); (None, residuals) where the alignment does not
    hold. (Unix µs need more digits than a float keeps below 1 µs, so
    the search runs on times after the first anchor.)"""
    if len(anchors_ns) < MIN_ANCHORS or not ends:
        return None, []
    ref = min(anchors_ns)
    anchors = sorted((a - ref) / 1e3 for a in anchors_ns)
    step = max(1, len(anchors) // COARSE_ANCHORS)
    rough = _best_offset(anchors[::step], ends, LATE_US)
    offset = _best_offset(anchors, ends, PEAK_US, near=NEAR_US, around=rough)
    res = residuals(anchors, ends, offset)
    if not holds(res):
        return None, res
    return ref + round(offset * 1e3), res


def holds(res: list[float]) -> bool:
    """The median anchor falls within FIT_US after a copy's end, and
    MIN_WITHIN of them within LATE_US."""
    return (bool(res) and statistics.median(res) <= FIT_US
            and within(res) >= MIN_WITHIN)


def within(res: list[float]) -> float:
    """The share of anchors within LATE_US after a copy's end."""
    return sum(1 for r in res if r <= LATE_US) / len(res)


def innermost(spans: list[tuple[float, float, str]]
              ) -> list[tuple[float, float, str]]:
    """The timeline cut where the innermost open span changes: segments
    (start, end, name of the span open there that began last); no segment
    where none is open."""
    marks = sorted([(s, 1, i) for i, (s, e, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (s, e, _) in enumerate(spans)])
    out, open_ = [], {}
    last = None
    for x, kind, i in marks:
        if open_ and last is not None and x > last:
            top = max(open_, key=lambda k: spans[k][0])
            out.append((last, x, spans[top][2]))
        if kind:
            open_[i] = True
        else:
            open_.pop(i, None)
        last = x
    return out


def idle_intervals(busy: list[tuple[float, float, str]], w0: float,
                   w1: float) -> list[tuple[float, float]]:
    """The gaps of the window [w0, w1] that no busy interval covers."""
    out, t = [], w0
    for s, e, _ in busy:
        if e <= t:
            continue
        if s >= w1:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def overlap_by_label(gaps: list[tuple[float, float]],
                     segs: list[tuple[float, float, str]]) -> dict:
    """µs of ``gaps`` under each label of ``segs`` (both sorted, neither
    overlapping itself); the rest under ``none``."""
    out: dict = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            d = min(g1, s1) - max(g0, s0)
            if d > 0:
                out[name] += d
                covered += d
            k += 1
        out["none"] += (g1 - g0) - covered
    return dict(out)


def idle_by_span(trace, records: list) -> dict | None:
    """The traced window's idle time by the innermost engine-thread span
    open during it: ``{"seconds": {span name or "none": s}, "idle_s",
    "anchors", "residual_median_us", "within_1ms"}`` (the share of anchors
    within LATE_US after a copy's end); None without a trace, anchors or
    an alignment that holds. The engine thread is the one that ran the
    anchors."""
    if trace is None or not trace.events or trace.window_s <= 0:
        return None
    anchors = [r for r in records if r.name == ANCHOR]
    if not anchors:
        return None
    offset, res = align([r.end_ns for r in anchors], copy_ends(trace))
    if offset is None:
        return None
    engine = Counter(r.thread for r in anchors).most_common(1)[0][0]
    busy = trace.busy_intervals()
    w1 = max(e for _, e, _ in busy)
    w0 = w1 - trace.window_s * 1e6
    spans = sorted(((r.start_ns - offset) / 1e3, (r.end_ns - offset) / 1e3,
                    r.name) for r in records if r.thread == engine)
    by = overlap_by_label(idle_intervals(busy, w0, w1), innermost(spans))
    return {"seconds": {k: v / 1e6 for k, v in sorted(by.items())},
            "idle_s": sum(by.values()) / 1e6, "anchors": len(res),
            "residual_median_us": statistics.median(res),
            "within_1ms": within(res)}
