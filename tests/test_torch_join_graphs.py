"""The host rules of the IVPQ join's round graphs
(``models/join_graphs.py``, ``IVPQIndex._graph_round``) on the CPU, with
capture and replay injected: the capture keeps the function, the replay
reruns it into the captured outputs. What is held: the key, capture on
the second sighting, the LRU and its eviction, the end of an entry with
its statistics table or prepared set, launch counts per replay, and the
eager rounds (escalation, the dense round, the mesh, the CPU, unprepared
calls). The replayed rounds answer as the eager ones, bit for bit."""

import pytest
import torch

from freddy_bench.traffic import synth
from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch.models import ivpq
from postgres_word2vec_tpu_torch.models.ivpq import PQ_PV_CALC, IVPQIndex
from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs
from postgres_word2vec_tpu_torch.ops import kernels

N, D, T, K = 8192, 64, 3000, 5


def capture(fn):
    return fn, fn()


def replay(graph, outputs):
    """Rerun the function into the outputs; a graph's replay runs no
    Python, so the wrappers' launch counts are put back."""
    saved = kernels.launch_counts()
    new = graph()
    for name, n in saved.items():
        kernels.KERNELS[name].launches = n
    for buf, x in zip(outputs, new):
        buf.copy_(x)


def frozen_capture(fn):
    """A CUDA graph holds no Python object: this capture keeps none, and
    its replay (:func:`frozen_replay`) leaves the captured outputs as they
    are (the tests that use it replay the same queries)."""
    return None, fn()


def frozen_replay(graph, outputs):
    pass


def is_scan(key) -> bool:
    return "scan" in key


def graphs(cap: int = 16) -> RoundGraphs:
    return RoundGraphs(cap, capture=capture, replay=replay,
                       engages=lambda x: True)


@pytest.fixture(scope="module")
def case():
    g = torch.Generator().manual_seed(2 ** 31 + 5)
    x = synth.generate_wordlike(g, N, D)
    idx = IVPQIndex.build(g, x, m=8, k=16, k_coarse=8, coarse_positions=2,
                          train_size=4096, iters=3)
    tg = torch.sort(torch.randperm(N, generator=g)[:T]).values
    stats = ivpq.build_statistics(idx.cell_of, tg, idx.num_cells)
    return g, x, idx, tg, stats


def twin(idx, rg=None) -> IVPQIndex:
    """The same tables with a round-graph cache of their own (none taken
    by default: eager)."""
    out = IVPQIndex(idx.coarse, idx.codebook, idx.codes, idx.cell_of)
    out._round_graphs = (rg if rg is not None
                         else RoundGraphs(engages=lambda x: False))
    return out


def join(idx, q, ph, stats, k=K, **kw):
    args = dict(prepared=ph, statistics=stats, alpha=20, pvf=20,
                method=PQ_PV_CALC, impl="budget", return_info=True)
    args.update(kw)
    return idx.search_join(q, k, **args)


def same(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for key in ("retrieved", "target_count"):
        assert torch.equal(a[2][key], b[2][key]), key
    for key in ("rounds", "final_alpha", "scan_slots", "short_codes"):
        assert a[2][key] == b[2][key], key


def queries(case, n=700):
    g, x = case[0], case[1]
    return x[torch.randint(0, N, (n,), generator=g)]


@pytest.mark.parametrize("method,threshold", [
    (PQ_PV_CALC, 1e7), (PQ_PV_CALC, 0.0), (0, 1e7), (1, 1e7)],
    ids=["pv_long", "pv_short", "adc", "exact"])
def test_second_sighting_captures_and_replays_answer_as_eager(
        case, method, threshold):
    _, x, idx, tg, stats = case
    rg = graphs()
    gi, ei = twin(idx, rg), twin(idx)
    ph = idx.prepare_join(tg, vectors=x)
    rounds = []
    q1, q2 = queries(case), queries(case)
    for q in (q1,) * 4 + (q2,) * 3:
        got = join(gi, q, ph, stats, method=method,
                   long_codes_threshold=threshold)
        same(got, join(ei, q, ph, stats, method=method,
                       long_codes_threshold=threshold))
        rounds.append(got[2]["graph_rounds"])
    # 1: eager; 2: the selection captured, the scan eager; 3: the scan
    # captured; 4: both replayed; other queries through the same graphs,
    # or a scan of their own where their plan is another size
    assert rounds[:4] == [0.0, 0.0, 1.0, 1.0] and rounds[-1] == 1.0
    assert rg.captures == len(rg) in (2, 3)


def test_the_key(case):
    """k, alpha, confidence, the block sizes and the statistics table's
    identity each make a selection key of their own; a scan key adds the
    plan's size and the round's settings."""
    _, x, idx, tg, stats = case
    rg = graphs(cap=64)
    gi = twin(idx, rg)
    ph = idx.prepare_join(tg, vectors=x)
    q = queries(case)
    base = dict(alpha=20, confidence=0.8)
    variants = [base, dict(base, alpha=21), dict(base, confidence=0.7),
                dict(base, pvf=10), dict(base, method=0)]
    for kw in variants:
        for _ in range(3):
            join(gi, q, ph, stats, **kw)
    for n in (300, 512, 1024):
        qn = queries(case, n)
        for _ in range(3):
            join(gi, qn, ph, stats)
    st = stats.clone()
    for _ in range(3):
        join(gi, q, ph, st)
    selects = [k for k in rg._graphs if not is_scan(k)]
    # alpha, confidence, three more block sizes, a second table: new keys
    assert len(selects) == 1 + 2 + 3 + 1
    # pvf and method: scans of their own over the first selection
    assert len(rg) - len(selects) == len(selects) + 2
    # k differs: a key of its own
    before = len(rg)
    for _ in range(3):
        gi.search_join(q, K + 1, prepared=ph, statistics=stats, alpha=20,
                       impl="budget")
    assert len(rg) == before + 2


def test_lru_evicts_the_least_recently_used_with_its_scans(case):
    _, x, idx, tg, stats = case
    rg = graphs(cap=4)
    gi, ei = twin(idx, rg), twin(idx)
    ph = idx.prepare_join(tg, vectors=x)
    q = queries(case)
    for alpha in (20, 30):
        for _ in range(3):
            join(gi, q, ph, stats, alpha=alpha)
    assert len(rg) == 4
    first = [k for k in rg._graphs]
    for _ in range(3):
        got = join(gi, q, ph, stats, alpha=40)
    same(got, join(ei, q, ph, stats, alpha=40))
    assert len(rg) == 4 and got[2]["graph_rounds"] == 1.0
    # alpha 20's selection and its scan went: a scan leaves with the
    # selection whose outputs it reads
    assert not set(first[:2]) & set(rg._graphs)
    assert set(first[2:]) <= set(rg._graphs)
    for k, e in rg._graphs.items():
        assert e.parent is None or e.parent in rg._graphs


def test_entries_end_with_their_statistics_or_prepared_set(case):
    _, x, idx, tg, stats = case
    rg = RoundGraphs(capture=frozen_capture, replay=frozen_replay,
                     engages=lambda x: True)
    gi, ei = twin(idx, rg), twin(idx)
    ph = idx.prepare_join(tg, vectors=x)
    st = stats.clone()
    q = queries(case)
    for _ in range(3):
        join(gi, q, ph, st)
    assert len(rg) == 2
    st.mul_(1.0)                             # in place: a new version
    got = join(gi, q, ph, st)
    assert len(rg) == 0 and got[2]["graph_rounds"] == 0.0
    for _ in range(2):
        got = join(gi, q, ph, st)
    assert len(rg) == 2 and got[2]["graph_rounds"] == 1.0
    st = stats.clone()                       # replaced: the old one ends
    got = join(gi, q, ph, st)
    assert len(rg) == 0 and got[2]["graph_rounds"] == 0.0
    same(got, join(ei, q, ph, st))
    for _ in range(2):
        join(gi, q, ph, st)
    assert len(rg) == 2
    ph = idx.prepare_join(tg, vectors=x)     # the set prepared again
    got = join(gi, q, ph, st)
    assert len(rg) == 0 and got[2]["graph_rounds"] == 0.0
    same(got, join(ei, q, ph, st))


def test_a_replay_counts_the_launches_of_its_capture():
    """``fn`` counts a launch of K6 as its wrapper would: the capture's
    own call is taken back, each replay adds it."""
    rg = graphs()
    x = torch.arange(4.0)

    def fn(a):
        kernels.KERNELS["budget_adc"].launches += 1
        return (a * 2,)

    kernels.reset_launch_counts()
    assert rg.run("k", fn, (x,)) is None
    e = rg.run("k", fn, (x,))
    assert kernels.launch_counts()["budget_adc"] == 1
    for i in range(3):
        e = rg.run("k", fn, (x + i,))
        assert torch.equal(e.outputs[0], (x + i) * 2)
    assert kernels.launch_counts()["budget_adc"] == 4
    assert rg.captures == 1 and rg.replays == 4


@pytest.mark.parametrize("what", ["escalation", "dense", "cpu", "adhoc"])
def test_rounds_that_stay_eager(case, what):
    """Escalation rounds (a one-tile cap leaves every query short of k), the
    dense round, the default cache on the CPU and unprepared calls take no
    graph; the first round of an escalating call still does."""
    _, x, idx, tg, stats = case
    rg = graphs() if what != "cpu" else RoundGraphs()
    gi, ei = twin(idx, rg), twin(idx)
    ph = idx.prepare_join(tg, vectors=x)
    q = queries(case)
    kw = {"escalation": dict(alpha=1, budget_tiles=1, k=200),
          "dense": dict(impl="dense"), "cpu": {}, "adhoc": {}}[what]
    for _ in range(4):
        if what == "adhoc":
            got = gi.search_join(q, K, tg, vectors=x, statistics=stats,
                                 alpha=20, pvf=20, method=PQ_PV_CALC,
                                 impl="budget", return_info=True)
            want = ei.search_join(q, K, tg, vectors=x, statistics=stats,
                                  alpha=20, pvf=20, method=PQ_PV_CALC,
                                  impl="budget", return_info=True)
        else:
            got, want = join(gi, q, ph, stats, **kw), join(ei, q, ph, stats,
                                                           **kw)
        same(got, want)
    if what == "escalation":
        assert got[2]["rounds"] > 1 and got[2]["graph_rounds"] == 1.0
        # round 1's two graphs; the later rounds never asked for one
        assert len(rg) == 2 and len(rg._seen) == 0
    else:
        assert got[2]["graph_rounds"] == 0.0
        assert len(rg) == 0 and rg.replays == 0
        # an unprepared call's handle ends with the call, and its sighting
        assert len(rg._seen) == (what == "adhoc")


def test_the_mesh_join_takes_no_graph(case):
    from postgres_word2vec_tpu_torch.parallel import sharding

    _, x, idx, tg, stats = case
    store = VectorStore.from_arrays([f"w{i}" for i in range(N)], x,
                                    normalized=True)
    eng = Freddy.build(store, seed=1, with_pq=False, with_ivfadc=False,
                       with_ivpq=True, ivpq_m=8, ivpq_k=16, ivpq_k_coarse=8,
                       train_size=4096, iters=2)
    eng.enable_sharding(sharding.make_mesh(["cpu"] * 2, rows=2))
    eng.ivpq._round_graphs = graphs()
    eng.prepare_targets([f"w{i}" for i in tg.tolist()], name="t")
    eng.create_statistics("s", [f"w{i}" for i in tg.tolist()])
    words = [f"w{i}" for i in range(0, 400, 7)]
    for _ in range(3):
        rows = eng.knn_in_ivpq_batch(words, K, "t")
    assert len(rows) == len(words) * K
    assert len(eng.ivpq._round_graphs) == 0
    assert len(eng.ivpq._round_graphs._seen) == 0


def test_threads_sharing_the_graphs_get_their_own_answers(case):
    """Eight threads join their own queries through one index's graphs
    (one static query buffer a key), the interpreter switching threads
    every microsecond: each answer is the eager round's for its queries."""
    import sys
    import threading

    _, x, idx, tg, stats = case
    gi, ei = twin(idx, graphs()), twin(idx)
    ph = idx.prepare_join(tg, vectors=x)
    qs = [queries(case) for _ in range(8)]
    want = [join(ei, q, ph, stats) for q in qs]
    for q in qs[:3]:
        join(gi, q, ph, stats)                # capture before the race
    errors = []

    def worker(i):
        try:
            for _ in range(3):
                same(join(gi, qs[i], ph, stats), want[i])
        except Exception as e:                # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert gi._round_graphs.replays >= 8 * 3
