"""The readers of the program's spans and counters on a synthetic run:
the front end's and the façade's span means, the host reads a statement,
and the idle time inside the search, with the program's spans put on the
device trace's clock (``freddy_bench/spans.py``); a trace whose span ends
do not follow its copies reads nothing."""

import random
import statistics
import types
from collections import deque

import pytest

from freddy_bench import manifest, spans
from freddy_bench.trace import TraceData
from postgres_word2vec_tpu_torch.utils.tracker import (GLOBAL_TRACKER,
                                                       SpanRecord)

SPAN_READERS = {"join_queue_ms": "fe_queue_time",
                "join_reply_ms": "fe_reply_time",
                "join_format_ms": "join_format_time"}
#: the trace's base, Unix µs, and a statement's period on the card (µs)
BASE_US = 1_790_857_026_000_000
PERIOD = 35_000
STATEMENTS = 40


def ctx_of(tracker: dict, endpoint: str = "/knn_join", trace=None):
    return types.SimpleNamespace(workload={"endpoint": endpoint},
                                 counters={"tracker": tracker}, trace=trace)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_read_the_windows_mean_in_ms(metric):
    read = manifest.metric_reader(metric)
    name = SPAN_READERS[metric]
    assert read(ctx_of({name: [0.002, 0.004]})) == pytest.approx(3.0)
    assert read(ctx_of({})) is None                 # a program without it
    assert read(ctx_of({name: [0.002]}, "/knn")) is None


def test_host_reads_reads_the_mean_a_statement():
    read = manifest.metric_reader("join_host_reads")
    assert read(ctx_of({"join_host_reads": [5.0, 5.0, 6.0]})) == \
        pytest.approx(16 / 3)
    assert read(ctx_of({})) is None
    assert read(ctx_of({"join_host_reads": [5.0]}, "/knn")) is None


def synthetic_run(jitter_us: float = 0.0, seed: int = 0):
    """A served window of STATEMENTS statements: the engine thread's spans
    (Unix ns) and the device's operations (µs after BASE_US), as the
    program records them. Each statement: a search with two kernels and
    the done check's copy; the read's copy, which its span ends 1 µs
    after; the two counts' copies; the formatting with the distances'
    copy. Host gaps vary by up to 40 µs; ``jitter_us`` moves each span
    end off its copy by up to that. → (records, events, window_s, the
    idle µs a statement inside the search and read spans)."""
    rng = random.Random(seed)
    recs, events, sid = [], [], 0

    def rec(req, name, parent, s, e, thread="engine_0"):
        nonlocal sid
        sid += 1
        recs.append(SpanRecord(req, sid, parent, name, thread,
                               BASE_US * 1000 + round(s * 1e3),
                               BASE_US * 1000 + round(e * 1e3)))
        return sid

    def op(name, cat, s, e):
        events.append((name, cat, float(s), float(e - s)))

    for i in range(STATEMENTS):
        t = 10_000 + i * PERIOD
        h = [rng.uniform(0, 40) for _ in range(4)]
        rec(i + 1, "fe_queue_time", 0, t - 5_000, t - 50, "frontend")
        top = rec(i + 1, "total_time", 0, t, t + 25_000)
        rec(i + 1, "query_construction_time", top, t + 100, t + 600)
        op("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t + 400,
           t + 410)
        rec(i + 1, "join_search_time", top, t + 700, t + 20_000)
        op("kernel_a", "kernel", t + 1_000, t + 1_500)
        op("kernel_b", "kernel", t + 5_000, t + 6_000)
        op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 19_900,
           t + 19_910)
        rec(i + 1, "join_read_time", top, t + 20_050 + h[0],
            t + 20_300 + h[0] + rng.uniform(-jitter_us, jitter_us))
        op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
           t + 20_100 + h[0], t + 20_299 + h[0])
        op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
           t + 20_350 + h[0] + h[1], t + 20_360 + h[0] + h[1])
        op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
           t + 20_400 + h[0] + h[1] + h[2], t + 20_410 + h[0] + h[1] + h[2])
        rec(i + 1, "join_format_time", 0, t + 25_100, t + 28_000)
        op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
           t + 25_120 + h[3], t + 25_140 + h[3])
        rec(i + 1, "fe_reply_time", 0, t + 28_100, t + 33_000)
    last = max(s + d for _, _, s, d in events)
    window_s = (last - 5_000) / 1e6
    # idle µs a statement inside join_search_time and join_read_time: the
    # search's 19,300 less its kernels and copy; the read's span less its
    # copy
    inside = (19_300 - 500 - 1_000 - 10) + (250 - 199)
    return recs, events, window_s, inside


@pytest.fixture
def ring(monkeypatch):
    """The program's span ring, replaced for one test."""
    ring = deque()
    monkeypatch.setattr(GLOBAL_TRACKER, "ring", ring)
    return ring


def test_the_trace_base_is_recovered_from_the_read_spans():
    recs, events, window_s, _ = synthetic_run()
    trace = TraceData(window_s, events)
    ends = [r.end_ns for r in recs if r.name == spans.ANCHOR]
    offset, res = spans.align(ends, spans.copy_ends(trace))
    # the read spans end 1 µs after their copies: the offset is the base's
    # (to the µs of the program's rounding), plus that µs
    assert abs(offset - (BASE_US + 1) * 1000) < 100
    assert len(res) == STATEMENTS and max(res) < 1


def test_idle_in_search_reads_the_idle_share_inside_the_search(ring,
                                                               capsys):
    recs, events, window_s, inside = synthetic_run()
    ring.extend(recs)
    trace = TraceData(window_s, events)
    read = manifest.metric_reader("idle_in_search.join")
    got = read(ctx_of({}, trace=trace))
    assert got == pytest.approx(100 * STATEMENTS * inside / 1e6 / window_s,
                                rel=1e-3)
    idle = manifest.metric_reader("device_idle.join")(ctx_of({}, trace=trace))
    assert got <= idle
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith("idle_in_search.join: ")
    by = spans.idle_by_span(trace, recs)
    assert sum(by["seconds"].values()) == pytest.approx(
        window_s - trace.busy_s, rel=1e-6)
    assert by["seconds"]["none"] > 0
    assert set(by["seconds"]) <= {"none", "total_time", "join_search_time",
                                  "join_read_time", "query_construction_time",
                                  "join_format_time", "fe_reply_time"}


def test_idle_in_search_reads_nothing_when_the_anchors_disagree(ring):
    """Span ends scattered over ±3 ms around their copies: no offset puts
    half of them within 100 µs after a copy's end."""
    recs, events, window_s, _ = synthetic_run(jitter_us=3_000, seed=1)
    ring.extend(recs)
    trace = TraceData(window_s, events)
    ends = [r.end_ns for r in recs if r.name == spans.ANCHOR]
    offset, res = spans.align(ends, spans.copy_ends(trace))
    assert offset is None and not spans.holds(res)
    read = manifest.metric_reader("idle_in_search.join")
    assert read(ctx_of({}, trace=trace)) is None


def test_idle_in_search_reads_nothing_when_half_the_anchors_fit(ring):
    """The median read span ends on its copy, but 45 % end 2 ms late: an
    offset that fits only half of them does not hold."""
    recs, events, window_s, _ = synthetic_run()
    late = 0
    for j, r in enumerate(recs):
        if r.name == spans.ANCHOR and late < 0.45 * STATEMENTS:
            recs[j] = r._replace(end_ns=r.end_ns + 2_000_000)
            late += 1
    ring.extend(recs)
    trace = TraceData(window_s, events)
    ends = [r.end_ns for r in recs if r.name == spans.ANCHOR]
    offset, res = spans.align(ends, spans.copy_ends(trace))
    assert statistics.median(res) <= spans.FIT_US
    assert offset is None and spans.within(res) < spans.MIN_WITHIN
    read = manifest.metric_reader("idle_in_search.join")
    assert read(ctx_of({}, trace=trace)) is None


def test_idle_in_search_reads_nothing_without_a_trace_or_spans(ring):
    recs, events, window_s, _ = synthetic_run()
    read = manifest.metric_reader("idle_in_search.join")
    trace = TraceData(window_s, events)
    assert read(ctx_of({}, trace=trace)) is None     # the parent: no spans
    ring.extend(recs)
    assert read(ctx_of({}, trace=None)) is None
    assert read(ctx_of({}, "/knn", trace=trace)) is None


def test_innermost_span_labels_nested_and_overlapping_spans():
    segs = spans.innermost([(0, 10, "outer"), (2, 4, "inner"),
                            (8, 12, "late")])
    assert segs == [(0, 2, "outer"), (2, 4, "inner"), (4, 8, "outer"),
                    (8, 10, "late"), (10, 12, "late")]
    by = spans.overlap_by_label([(1, 3), (11, 14)], segs)
    assert by == pytest.approx({"outer": 1, "inner": 1, "late": 1,
                                "none": 2})
