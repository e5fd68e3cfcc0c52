"""The port's IVPQ kNN-join (method 2) held to the plain reference of the
benchmark (``freddy_bench/reference/ivpq_join.py``) in both code forms,
long codes and fused-pair short codes, on both rounds ("budget" and
"dense"), on the CPU; the rule that picks the form; and the counters a
statement records of it.

Tolerances: a query's k rows are the reference's, except rows whose
float64 similarities lie within 1e-6 of one another (float32 re-rank
sums); the served similarities within 1e-6 of the float64 similarities
of the reference's rows; at the shortlist's edge the reference's own
1e-5 on ADC distances (float32 sums of 30 or 15 LUT entries)."""

import math

import pytest
import torch

from freddy_bench.reference.ivpq_join import IVPQJoinReference, hold
from freddy_bench.reference.knn import true_sims
from freddy_bench.traffic import synth
from postgres_word2vec_tpu_torch import Freddy, VectorStore
from postgres_word2vec_tpu_torch.models import ivpq
from postgres_word2vec_tpu_torch.models.ivpq import PQ_PV_CALC, IVPQIndex
from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER

N, D, T, B = 16384, 300, 2000, 64
K, PVF, ALPHA = 5, 20, T // (2 * 5)
TIE = 1e-6


@pytest.fixture(scope="module")
def case():
    """Word-like rows, the index (m 30, k 16, 8 × 2 coarse cells), a
    2,000-row target set with its statistics, 64 query rows."""
    g = torch.Generator().manual_seed(2 ** 31 + 77)
    x = synth.generate_wordlike(g, N, D)
    idx = IVPQIndex.build(g, x, m=30, k=16, k_coarse=8, coarse_positions=2,
                          train_size=8192, iters=5)
    tg = torch.sort(torch.randperm(N, generator=g)[:T]).values
    stats = ivpq.build_statistics(idx.cell_of, tg, idx.num_cells)
    qids = torch.randint(0, N, (B,), generator=g)
    ref = IVPQJoinReference(x, idx.coarse.centroids, idx.codebook.centroids,
                            idx.codes, idx.cell_of, tg)
    return x, idx, tg, stats, qids, ref


def _join(case, threshold, impl, alpha=ALPHA, **kw):
    x, idx, tg, stats, qids, _ = case
    ph = idx.prepare_join(tg, vectors=x)
    return idx.search_join(x[qids], K, prepared=ph, statistics=stats,
                           alpha=alpha, pvf=PVF, method=PQ_PV_CALC,
                           confidence=0.8, long_codes_threshold=threshold,
                           impl=impl, return_info=True, **kw)


@pytest.mark.parametrize("impl", ["budget", "dense"])
@pytest.mark.parametrize("threshold", [0.0, 1e7], ids=["short", "long"])
def test_search_join_matches_the_reference(case, threshold, impl):
    x, _, _, _, qids, ref = case
    d, ids, info = _join(case, threshold, impl)
    assert info["short_codes"] is (threshold == 0.0)
    lists = ref.shortlists(qids, K, alpha=ALPHA, pvf=PVF, confidence=0.8,
                           long_codes_threshold=threshold)
    assert sum(sl is None for sl in lists) <= 2
    assert all(sl["short"] is (threshold == 0.0) for sl in lists if sl)
    # every selected cell scanned whole: no budget cuts a query short
    for b, sl in enumerate(lists):
        assert sl is None or int(info["retrieved"][b]) == sl["candidates"]
    served = true_sims(x, qids, ids)
    h = hold(lists, ids, served, K)
    assert h["outside"] == 0 and h["gap"] <= TIE, h
    # the served similarities are the float32 re-rank's: 1 − d²/2
    assert float(torch.max(torch.abs(1.0 - d.double() / 2 - served))) \
        <= TIE
    exact_queries = 0
    for b, sl in enumerate(lists):
        # a shortlist whose edge no other row comes within 1e-5 of
        if sl is None or sl["ids"].shape[0] != min(K * PVF,
                                                   sl["candidates"]):
            continue
        exact_queries += 1
        top = torch.topk(sl["sims"], K)
        want = set(sl["ids"][top.indices].tolist())
        kth = float(top.values[-1])
        for row, s in zip(ids[b].tolist(), served[b].tolist()):
            assert row in want or abs(s - kth) <= TIE, (b, row)
        assert torch.allclose(torch.sort(served[b], descending=True).values,
                              top.values, atol=TIE, rtol=0)
    assert exact_queries >= B // 2


def test_the_reference_selects_whole_cells_until_alpha_k(case):
    """With the statistics of the target set itself the spread's
    correction is 0, so the confidence rule reads the cells' target
    counts: each query's cells hold α·k targets or more, and without the
    last one fewer."""
    x, _, _, _, qids, ref = case
    from freddy_bench.reference.ivpq_join import cell_distances

    cd = cell_distances(x[qids].double(), ref.coarse)
    sel, exhausted, _ = ref._select(cd, K, ALPHA, 0.8, 1e-5, 1e-5)
    held = (sel.double() * ref.counts).sum(1)
    assert bool(torch.all(held >= ALPHA * K)) and not bool(exhausted.any())
    far = torch.where(sel & (ref.counts > 0), cd,
                      torch.full_like(cd, -1.0)).argmax(1)
    assert bool(torch.all(held - ref.counts[far] < ALPHA * K))


@pytest.mark.parametrize("impl", ["budget", "dense"])
def test_alpha_k_at_the_threshold_keeps_long_codes(case, impl):
    """``alpha·k > long_codes_threshold`` takes short codes
    (ivpq_search_in.c:262): equal keeps the long ones, one more switches."""
    at = _join(case, float(ALPHA * K), impl)
    above = _join(case, float(ALPHA * K - 1), impl)
    assert at[2]["short_codes"] is False and above[2]["short_codes"] is True
    # the two forms sum the same LUT entries: the same rows either way
    assert torch.equal(at[2]["retrieved"], above[2]["retrieved"])


def test_scan_slots_count_a_rounds_plan(case):
    """A dense round scores every target; a budget round its plan's P
    tiles: the most tiles a query's selected cells take (in sixteens),
    where the JAX package's power of two for α·k rows would cut some, or
    a given cap."""
    x, idx, tg, stats, qids, _ = case
    _, _, dense = _join(case, 0.0, "dense")
    assert dense["scan_slots"] == T
    _, _, budget = _join(case, 0.0, "budget")
    jt = idx.prepare_join(tg).tiles(with_vecs=False)
    need = int(ivpq.select_tiles(x[qids], idx.coarse.centroids, stats, jt,
                                 K, ALPHA, 0.8)[1].sum(1).max())
    rule = 1 << math.ceil(math.log2(max(8, 2 * K * ALPHA // jt.block_t
                                        + 4)))
    assert need > rule          # the JAX package's rule would cut some
    assert budget["scan_slots"] == (-(-need // 16) * 16) * jt.block_t
    assert bool(torch.all(budget["retrieved"] <= budget["scan_slots"]))
    _, _, capped = _join(case, 0.0, "budget", budget_tiles=4)
    assert capped["scan_slots"] == 4 * jt.block_t


def test_escalation_rounds_add_their_slots(case):
    """A round per α doubling, each adding its plan. The coverage floor
    gives every query k targets in its cells, so no round follows the
    first unless the budget cuts them: a one-tile cap leaves a query short
    of k, and α doubles through every round."""
    _, idx, tg, _, _, _ = case
    _, _, info = _join(case, 1e7, "budget", alpha=1, budget_tiles=1)
    jt = idx.prepare_join(tg).tiles(with_vecs=False)
    assert info["rounds"] == 8 and info["final_alpha"] == 128
    assert info["scan_slots"] == 8 * jt.block_t
    assert info["short_codes"] is False


def test_a_served_statement_records_its_code_form_and_slots(case):
    x, _, tg, _, qids, _ = case
    store = VectorStore.from_arrays([f"w{i}" for i in range(N)], x,
                                    normalized=True)
    eng = Freddy.build(store, seed=3, with_pq=False, with_ivfadc=False,
                       with_ivpq=True, ivpq_m=30, ivpq_k=16,
                       ivpq_k_coarse=8, train_size=8192, iters=3)
    eng.prepare_targets([f"w{i}" for i in tg.tolist()], name="t")
    eng.set_alpha(ALPHA)
    eng.set_method_flag(PQ_PV_CALC)
    words = [f"w{i}" for i in qids.tolist()]
    got = []
    for threshold in (1e7, 0):
        eng.set_long_codes_threshold(threshold)
        before = {n: len(GLOBAL_TRACKER.get_results().get(n, []))
                  for n in ("join_short_codes", "join_scan_slots")}
        eng.knn_in_ivpq_batch(words, K, "t")
        res = GLOBAL_TRACKER.get_results()
        for n, v in before.items():
            assert len(res[n]) == v + 1, n
        got.append((res["join_short_codes"][-1], res["join_scan_slots"][-1]))
    assert got[0][0] == 0.0 and got[1][0] == 1.0
    assert got[0][1] == got[1][1] > 0


def test_the_mesh_budget_round_scans_every_selected_cell(case):
    """The sharded budget round fits each shard's plan to its largest
    selection, as the single-device round does: where the JAX package's
    power of two for α·k rows over the shards would cut some query's
    cells, it answers as the sharded dense round does."""
    from postgres_word2vec_tpu_torch.parallel import sharding

    x, idx, tg, stats, qids, _ = case
    mesh = sharding.make_mesh(["cpu"] * 2, rows=2)
    bundle = sharding.shard_join_tiles(
        idx, tg, torch.ones(T, dtype=torch.bool), None, mesh)
    jt = bundle["jt"][0][mesh.devices[0][0]]
    need = int(ivpq.select_tiles(
        x[qids], idx.coarse.centroids, stats, jt, K, ALPHA, 0.8,
        bundle["t_real"], bundle["cell_counts"])[1].sum(1).max())
    rule = 1 << math.ceil(math.log2(max(
        8, 2 * K * ALPHA // (bundle["block_t"] * 2) + 4)))
    assert need > rule
    kw = dict(vectors=x, statistics=stats, alpha=ALPHA, pvf=PVF,
              method=PQ_PV_CALC, confidence=0.8)
    dense = sharding.sharded_ivpq_join(mesh, idx, x[qids], K, tg,
                                       impl="dense", **kw)
    budget = sharding.sharded_ivpq_join(mesh, idx, x[qids], K, tg,
                                        impl="budget", **kw)
    assert torch.equal(budget[1], dense[1])
    assert torch.allclose(budget[0], dense[0], atol=1e-5, rtol=0)
