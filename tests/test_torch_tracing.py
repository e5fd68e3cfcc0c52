"""The port's spans and counters (``utils/tracker.py``) on a served
/knn_join statement, on the CPU: one value a statement in each tracker
list; the span ring, empty without a profiler and filled under one, its
spans on the profiler's clock; the ring's bound; the statement's
device → host reads; results read while other threads record."""

import functools
import json
import sys
import threading
import time
import urllib.request
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch.evaluation import harness
from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer
from postgres_word2vec_tpu_torch.utils import profiling
from postgres_word2vec_tpu_torch.utils.tracker import (GLOBAL_TRACKER,
                                                       RING_SIZE,
                                                       TRACK_METRICS,
                                                       Tracker, host_reads)

N = 2048
WORDS = [f"w{i}" for i in range(0, 64, 8)]
JOIN = {"queries": WORDS, "k": 3, "targets": "t"}
#: the spans of a served /knn_join statement: name → parent's name
SPANS = {"fe_queue_time": None, "total_time": None,
         "query_construction_time": "total_time",
         "join_search_time": "total_time", "join_read_time": "total_time",
         "join_format_time": None, "fe_reply_time": None}
#: the tracker lists a served /knn_join statement appends one value to
PER_STATEMENT = ("fe_queue_time", "join_search_time", "join_read_time",
                 "join_format_time", "fe_reply_time", "join_host_reads",
                 "join_short_codes", "join_scan_slots", "join_graph_rounds")


@pytest.fixture(scope="module")
def served(request):
    g = torch.Generator().manual_seed(0)
    v = torch.nn.functional.normalize(torch.randn(N, 16, generator=g), dim=1)
    store = VectorStore.from_arrays([f"w{i}" for i in range(N)], v,
                                    normalized=True)
    eng = Freddy.build(store, seed=0, with_pq=False, with_ivfadc=False,
                       with_ivpq=True, ivpq_m=4, ivpq_k=16, ivpq_k_coarse=4,
                       train_size=N, iters=2)
    srv = AsyncQueryServer(eng, port=0).start()
    request.addfinalizer(srv.stop)
    post(srv, "/prepare_targets", {"name": "t",
                                   "targets": list(range(0, N, 4))})
    post(srv, "/config", {"set_knn_join_function": "knn_in_ivpq_batch",
                          "set_alpha": 50})
    return eng, srv


def post(srv, path: str, body: dict):
    """One request through the server, returned once its ``fe_reply_time``
    span has ended: the loop ends it after the write, when the client may
    already have read the answer."""
    def replies():
        return len(GLOBAL_TRACKER.get_results().get("fe_reply_time", []))

    n = replies()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
        result = json.loads(r.read())["result"]
    deadline = time.monotonic() + 10
    while replies() <= n:
        assert time.monotonic() < deadline, "the reply span never ended"
        time.sleep(0.001)
    return result


def lengths() -> dict:
    return {k: len(v) for k, v in GLOBAL_TRACKER.get_results().items()}


def test_a_served_join_appends_one_value_to_each_list(served):
    _, srv = served
    before = lengths()
    rows = post(srv, "/knn_join", JOIN)
    after = GLOBAL_TRACKER.get_results()
    assert len(rows) == len(WORDS) * 3
    for name in PER_STATEMENT + ("total_time",):
        assert len(after[name]) == before.get(name, 0) + 1, name
        assert after[name][-1] >= 0
    assert after["join_host_reads"][-1] == 5.0


def test_without_a_profiler_the_ring_stays_empty(served):
    _, srv = served
    GLOBAL_TRACKER.ring.clear()
    post(srv, "/knn_join", JOIN)
    assert len(GLOBAL_TRACKER.ring) == 0


def test_under_a_profiler_a_statements_spans_share_a_request_and_nest(
        served):
    _, srv = served
    GLOBAL_TRACKER.ring.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        post(srv, "/knn_join", JOIN)
    recs = list(GLOBAL_TRACKER.ring)
    assert sorted(r.name for r in recs) == sorted(SPANS)
    assert len({r.request for r in recs}) == 1 and recs[0].request > 0
    by_id = {r.span: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns
        want = SPANS[r.name]
        if want is None:
            assert r.parent == 0, r
        else:
            p = by_id[r.parent]
            assert p.name == want
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    threads = {r.name: r.thread for r in recs}
    assert threads["fe_queue_time"] == "frontend"
    assert threads["total_time"].startswith("engine")


def test_spans_lie_on_the_profilers_clock(served, tmp_path):
    """A statement run on the thread that runs the profiler: each span's
    Unix-ns interval, written into the trace by ``device_trace``, holds
    the torch operators it ran by the trace's own clock
    (``baseTimeNanoseconds + ts``), within 1 ms: the read span its copy
    of the ids, the format span its copy of the distances."""
    eng, _ = served
    eng.knn_in_ivpq_batch(WORDS, 3, "t")
    GLOBAL_TRACKER.ring.clear()
    with profiling.device_trace(tmp_path / "tr"):
        with GLOBAL_TRACKER.request(GLOBAL_TRACKER.new_request()):
            eng.knn_in_ivpq_batch(WORDS, 3, "t")
    trace = json.loads((tmp_path / "tr" / profiling.TRACE_FILE).read_text())
    base = trace["baseTimeNanoseconds"]
    spans = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "span"}
    assert set(spans) == set(SPANS) - {"fe_queue_time", "fe_reply_time"}
    for r in GLOBAL_TRACKER.ring:
        e = spans[r.name]
        assert abs(base + e["ts"] * 1e3 - r.start_ns) < 1e3, r
    copies = [e for e in trace["traceEvents"]
              if e.get("cat") == "cpu_op" and e["name"] == "aten::_to_copy"]
    for name in ("join_read_time", "join_format_time"):
        s0 = spans[name]["ts"]
        s1 = s0 + spans[name]["dur"]
        assert any(s0 - 1e3 <= c["ts"] and c["ts"] + c["dur"] <= s1 + 1e3
                   for c in copies), name


def test_device_trace_adds_the_other_threads_spans(served, tmp_path):
    """… each on its thread's track, at the trace's ``ts`` (µs after its
    ``baseTimeNanoseconds``) of the span's Unix-clock times."""
    _, srv = served
    t0 = time.time_ns()
    with profiling.device_trace(tmp_path / "tr"):
        post(srv, "/knn_join", JOIN)
    t1 = time.time_ns()
    trace = json.loads((tmp_path / "tr" / profiling.TRACE_FILE).read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert sorted(e["name"] for e in spans) == sorted(SPANS)
    named = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {e["tid"] for e in spans} == {named["frontend"],
                                         named["engine_0"]}
    base = trace["baseTimeNanoseconds"]
    assert all(t0 <= base + e["ts"] * 1e3
               <= base + (e["ts"] + e["dur"]) * 1e3 <= t1 for e in spans)


def test_the_ring_is_bounded():
    assert Tracker().ring.maxlen == RING_SIZE
    t = Tracker()
    t.ring = deque(maxlen=4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with t.span(f"s{i}"):
                pass
    assert [r.name for r in t.ring] == ["s6", "s7", "s8", "s9"]
    assert len(t.get_results()) == 10


@pytest.mark.parametrize("targets", ["t", [f"w{i}" for i in range(0, N, 4)]],
                         ids=["prepared", "adhoc"])
def test_a_join_statement_reads_the_device_five_times(served, targets):
    """The round's done check, the ids, the two per-query counts and the
    distances."""
    eng, _ = served
    eng.knn_in_ivpq_batch(WORDS, 3, targets)
    assert GLOBAL_TRACKER.get_results()["join_host_reads"][-1] == 5.0


def test_join_graph_rounds_reads_1_on_replay_and_0_eager(served,
                                                        monkeypatch):
    """One value a statement: 0 on the CPU's dense round; on the budget
    round with capture and replay injected (the card's path) 0 while the
    round runs eager (the first statement; the second, whose scan is seen
    first), then 1 once both of its graphs replay; the reads stay five."""
    from test_torch_join_graphs import capture, replay

    from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs

    eng, srv = served

    def graph_rounds():
        post(srv, "/knn_join", JOIN)
        res = GLOBAL_TRACKER.get_results()
        assert res["join_host_reads"][-1] == 5.0
        return res["join_graph_rounds"][-1]

    assert graph_rounds() == 0.0
    ivpq_index = eng.ivpq
    monkeypatch.setattr(ivpq_index, "search_join", functools.partial(
        type(ivpq_index).search_join, ivpq_index, impl="budget"))
    monkeypatch.setattr(ivpq_index, "_round_graphs", RoundGraphs(
        capture=capture, replay=replay, engages=lambda x: True))
    eng.create_statistics("graphs", [f"w{i}" for i in range(0, N, 4)])
    try:
        assert [graph_rounds() for _ in range(4)] == [0.0, 0.0, 1.0, 1.0]
    finally:
        eng.params.statistics_table = None
        eng.statistics.pop("graphs")


def test_search_join_counts_its_reads(served):
    """The budget round's tile build and the ad hoc cache key are reads
    too: a prepared set's first call builds its tiles (1) before its done
    check (1); an ad hoc set's key copies its ids and mask (2), and a miss
    waits for the build (1)."""
    eng, _ = served
    idx = eng.ivpq
    q = eng._query_matrix(WORDS)
    tids = torch.arange(0, N, 4)
    kw = dict(impl="budget", alpha=50, return_info=True)

    def reads(*args, **kwargs):
        n = host_reads()
        idx.search_join(q, 3, *args, **kw, **kwargs)
        return host_reads() - n

    ph = idx.prepare_join(tids, with_tiles=False)
    assert [reads(prepared=ph) for _ in range(2)] == [2, 1]
    idx._join_cache.clear()
    assert [reads(tids) for _ in range(2)] == [4, 3]


def test_results_read_while_another_thread_adds_names():
    """The results are copied while another thread adds names (the thread
    switches every microsecond)."""
    t = Tracker()
    names = [f"m{i}" for i in range(20000)]

    def add():
        for i, name in enumerate(names):
            t.track(name, i)

    th = threading.Thread(target=add)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th.start()
        while th.is_alive():
            assert all(len(v) <= 1 for v in t.get_results().values())
    finally:
        sys.setswitchinterval(interval)
        th.join(timeout=60)
    assert not th.is_alive()
    assert t.get_results() == {name: [float(i)]
                               for i, name in enumerate(names)}


def test_track_statistics_keep_the_reference_names(served):
    eng, _ = served
    got = harness.create_track_statistics(eng, "knn_in_ivpq_batch", WORDS,
                                          3, "t")
    assert set(got) <= set(TRACK_METRICS)
    assert {"total_time", "retrieved", "target_count"} <= set(got)
    assert Tracker.stage is Tracker.span
