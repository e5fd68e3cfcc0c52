"""The IVPQ kNN-join in short codes on the card (marker ``cuda``; skipped
where no CUDA device is present): at α·k above ``long_codes_threshold``
the budget round runs the per-query K6 over fused-pair int16 codes, its
(B, P·block_t) plan past the grouped kernel's memory guard and fitted to
the largest selection, and the served rows hold to the plain reference's
shortlist (``freddy_bench/reference/ivpq_join.py``) at 262,144 × 300,
20,000 targets, 256 queries.

Run on an H100: ``python -m pytest tests/test_torch_cuda_ivpq_short.py -q
--noconftest``.

Tolerances: a served row inside the reference's shortlist, counting a
row within 1e-5 of its edge in ADC distance as inside (float32 sums of 15
fused LUT entries against float64 ones); the served j-th best at most
1e-5 below the reference's."""

import pytest
import torch

from postgres_word2vec_tpu_torch.ops import kernels

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA device"),
]

N, D, T, B, K, PVF = 262144, 300, 20000, 256, 5, 20
ALPHA = T // (2 * K)


@pytest.fixture(scope="module")
def join_case():
    from freddy_bench.reference.ivpq_join import IVPQJoinReference
    from freddy_bench.traffic import synth
    from postgres_word2vec_tpu_torch.models import ivpq
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex

    g = torch.Generator(device="cuda").manual_seed(2 ** 31 + 99)
    x = synth.generate_wordlike(g, N, D)
    idx = IVPQIndex.build(g, x, m=30, k=32, k_coarse=32, coarse_positions=2,
                          train_size=100000, iters=10)
    tg = torch.sort(torch.randperm(N, generator=g, device="cuda")[:T]).values
    stats = ivpq.build_statistics(idx.cell_of, tg, idx.num_cells)
    qids = torch.randint(0, N, (B,), generator=g, device="cuda")
    ph = idx.prepare_join(tg, vectors=x)
    ref = IVPQJoinReference(x, idx.coarse.centroids, idx.codebook.centroids,
                            idx.codes, idx.cell_of, tg)
    return x, idx, ph, stats, qids, ref


def test_short_codes_join_runs_k6_and_holds_to_the_reference(
        join_case, monkeypatch):
    from freddy_bench.reference.ivpq_join import hold
    from freddy_bench.reference.knn import true_sims
    from postgres_word2vec_tpu_torch.models.ivpq import PQ_PV_CALC

    x, idx, ph, stats, qids, ref = join_case
    seen = []
    k6 = kernels.budget_adc

    def spy(luts, codes_t, rowterm, tiles, *, block_t):
        out = k6(luts, codes_t, rowterm, tiles, block_t=block_t)
        seen.append((tuple(luts.shape), codes_t.dtype, tuple(tiles.shape),
                     tuple(out.shape), block_t))
        return out

    monkeypatch.setattr(kernels, "budget_adc", spy)
    kernels.reset_launch_counts()
    d, ids, info = idx.search_join(
        x[qids], K, prepared=ph, statistics=stats, alpha=ALPHA, pvf=PVF,
        method=PQ_PV_CALC, confidence=0.8, long_codes_threshold=0,
        return_info=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["budget_adc_grouped"] == 0 and counts["budget_adc"] == 1
    (luts, dtype, tiles, out, bt), = seen
    p = tiles[1]
    assert luts == (B, 15, 32 * 32) and dtype == torch.int16
    assert tiles[0] == B and out == (B, p * bt)
    assert info["short_codes"] is True and info["scan_slots"] == p * bt
    assert not kernels._grouped_wins(B * p, ph.tiles(False).codes_t.shape[1]
                                     // bt, kernels.GROUPED_ROWS_DEFAULT,
                                     15 * 1024 * 2)
    lists = ref.shortlists(qids, K, alpha=ALPHA, pvf=PVF, confidence=0.8,
                           long_codes_threshold=0)
    h = hold(lists, ids, true_sims(x, qids, ids), K)
    assert h["skipped"] <= B // 16, h
    assert h["outside"] == 0 and h["gap"] <= 1e-5, h
    # the plan holds every selected cell: α·k rows or more a query
    assert bool(torch.all(info["retrieved"] >= ALPHA * K))
    for b, sl in enumerate(lists):
        assert sl is None or int(info["retrieved"][b]) == sl["candidates"]
