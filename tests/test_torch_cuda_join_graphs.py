"""The IVPQ join's first budget round replayed from captured CUDA graphs
on the card (marker ``cuda``; skipped where no CUDA device is present),
held bit for bit to the same round run eager, with the same kernel
launches: α 200 in long codes (K7 and its pair layout), α 10,000 in short
codes at threshold 0 (K6 over int16 fused codes), two plan sizes P under
one selection graph, a partial last block, and a statistics table that
changes between statements. 262,144 × 300 rows, 100,000 targets, k 5,
PQ + PV (pvf 20), as the benchmark's two join cells at a smaller table.

Run on an H100: ``python -m pytest tests/test_torch_cuda_join_graphs.py
-q --noconftest``."""

import pytest
import torch

from postgres_word2vec_tpu_torch.ops import kernels

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device"),
]

N, D, T, K, PVF = 262144, 300, 100_000, 5, 20


@pytest.fixture(scope="module")
def case():
    from freddy_bench.traffic import synth
    from postgres_word2vec_tpu_torch.models import ivpq
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex

    g = torch.Generator(device="cuda").manual_seed(2 ** 31 + 23)
    x = synth.generate_wordlike(g, N, D)
    idx = IVPQIndex.build(g, x, m=30, k=32, k_coarse=32, coarse_positions=2,
                          train_size=100000, iters=10)
    tg = torch.sort(torch.randperm(N, generator=g, device="cuda")[:T]).values
    stats = ivpq.build_statistics(idx.cell_of, tg, idx.num_cells)
    ph = idx.prepare_join(tg, vectors=x)
    return g, x, idx, ph, stats


def _eager_twin(idx):
    """The same tables with graphs switched off."""
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
    from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs

    twin = IVPQIndex(idx.coarse, idx.codebook, idx.codes, idx.cell_of)
    twin._round_graphs = RoundGraphs(engages=lambda x: False)
    return twin


def _statement(idx, q, ph, stats, alpha, threshold):
    from postgres_word2vec_tpu_torch.models.ivpq import PQ_PV_CALC

    kernels.reset_launch_counts()
    d, i, info = idx.search_join(q, K, prepared=ph, statistics=stats,
                                 alpha=alpha, pvf=PVF, method=PQ_PV_CALC,
                                 confidence=0.8,
                                 long_codes_threshold=threshold,
                                 return_info=True)
    torch.cuda.synchronize()
    return d, i, info, kernels.launch_counts()


def _same(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for key in ("retrieved", "target_count"):
        assert torch.equal(a[2][key], b[2][key]), key
    assert a[2]["scan_slots"] == b[2]["scan_slots"]
    assert a[2]["rounds"] == b[2]["rounds"] == 1
    assert a[3] == b[3], (a[3], b[3])


@pytest.mark.parametrize("alpha,threshold,kernel", [
    (200, 1e7, "budget_adc_grouped"), (10_000, 0.0, "budget_adc")],
    ids=["long_k7", "short_k6"])
def test_replayed_round_is_bit_equal_to_eager(case, alpha, threshold,
                                              kernel):
    """Statements over query sets whose plans differ: the first runs
    eager, the second captures the selection graph, each plan size's
    second sighting captures its scan graph; every statement answers as
    the eager round, and every replayed one launches what it does. Random
    queries take the largest plan (a sparse region's many small cells);
    queries from the target set's most populous cells, a smaller one."""
    g, x, idx, ph, stats = case
    from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs

    idx._round_graphs = RoundGraphs()
    twin = _eager_twin(idx)
    sizes_t = torch.bincount(ph.target_cells, minlength=idx.num_cells)
    big = torch.topk(sizes_t, 4).indices
    dense = ph.target_ids[torch.isin(ph.target_cells, big)]
    sets = [x[torch.randint(0, N, (1024,), generator=g, device="cuda")]
            for _ in range(4)]
    sets += [x[dense[torch.randint(0, dense.numel(), (1024,), generator=g,
                                   device="cuda")]] for _ in range(4)]
    sizes, replayed = set(), set()
    for rep in range(3):
        for q in sets:
            got = _statement(idx, q, ph, stats, alpha, threshold)
            want = _statement(twin, q, ph, stats, alpha, threshold)
            p = got[2]["scan_slots"] // ph.block_t
            if got[2]["graph_rounds"] == 1.0 and p in replayed:
                _same(got, want)       # a replay of a scan captured before
                assert got[3][kernel] >= 2, got[3]
            else:                      # a capture also ran its warm-up
                _same(got[:3] + (None,), want[:3] + (None,))
            if got[2]["graph_rounds"] == 1.0:
                replayed.add(p)
            sizes.add(p)
    graphs = idx._round_graphs
    assert graphs.captures == len(graphs) == 1 + len(sizes)
    assert len(sizes) >= 2, sizes            # two plan sizes, one selection
    assert replayed == sizes


def test_a_partial_last_block_and_a_statistics_change(case):
    """700 queries (blocks of 512 and 188) at α 200; then the statistics
    table changes in place, and then it is replaced: each change ends the
    graphs captured over it, and the next statements answer as eager with
    the new table."""
    g, x, idx, ph, stats = case
    from postgres_word2vec_tpu_torch.models import ivpq
    from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs

    idx._round_graphs = RoundGraphs()
    twin = _eager_twin(idx)
    st = stats.clone()
    q = x[torch.randint(0, N, (700,), generator=g, device="cuda")]
    for _ in range(3):
        got = _statement(idx, q, ph, st, 200, 1e7)
        _same(got[:3] + (None,), _statement(twin, q, ph, st, 200, 1e7)[:3]
              + (None,))
    assert got[2]["graph_rounds"] == 1.0 and len(idx._round_graphs) == 2
    _same(_statement(idx, q, ph, st, 200, 1e7),
          _statement(twin, q, ph, st, 200, 1e7))
    # an in-place change: a new version, the old graphs gone
    other = ivpq.build_statistics(idx.cell_of, ph.target_ids[::3],
                                  idx.num_cells)
    st.copy_(other)
    got = _statement(idx, q, ph, st, 200, 1e7)
    assert got[2]["graph_rounds"] == 0.0 and len(idx._round_graphs) == 0
    _same(got, _statement(twin, q, ph, st, 200, 1e7))
    # a new table: the graphs over the old one end with it
    for _ in range(3):
        got = _statement(idx, q, ph, st, 200, 1e7)
    assert got[2]["graph_rounds"] == 1.0
    st = other.clone()
    got = _statement(idx, q, ph, st, 200, 1e7)
    assert got[2]["graph_rounds"] == 0.0
    _same(got, _statement(twin, q, ph, st, 200, 1e7))
    assert len(idx._round_graphs) == 0
