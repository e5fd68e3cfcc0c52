"""The plain reference against brute-force float64 numpy, at toy sizes."""

import numpy as np
import pytest
import torch

from freddy_bench import check
from freddy_bench.reference import ivfadc, knn, lowp


def _data(n=3000, d=24, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, torch.from_numpy(v)


def _sims(v, q):
    v64, q64 = v.astype(np.float64), q.astype(np.float64)
    d2 = ((q64 ** 2).sum(1)[:, None] + (v64 ** 2).sum(1)[None]
          - 2 * q64 @ v64.T)
    return 1 - np.maximum(d2, 0) / 2


def test_true_sims_match_numpy():
    v, vt = _data()
    qids = np.array([3, 7, 11])
    rows = np.array([[1, 2, 3], [4, 5, -1], [0, 9, 8]])
    got = knn.true_sims(vt, torch.from_numpy(qids),
                        torch.from_numpy(rows)).numpy()
    want = _sims(v, v[qids])
    for b in range(3):
        for j in range(3):
            if rows[b, j] < 0:
                assert np.isnan(got[b, j])
            else:
                assert got[b, j] == pytest.approx(want[b, rows[b, j]],
                                                  abs=1e-12)


def test_exact_top_k_over_targets_matches_numpy():
    v, vt = _data()
    qids = np.arange(0, 300, 7)
    targets = np.sort(np.random.default_rng(1).choice(3000, 500, False))
    ids, sims = knn.exact_top_k(vt, torch.from_numpy(qids), 5,
                                targets=torch.from_numpy(targets), chunk=128)
    s = _sims(v[targets], v[qids])
    want = targets[np.argsort(-s, axis=1)[:, :5]]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(sims.numpy(), np.sort(s, axis=1)[:, ::-1][:, :5],
                       atol=1e-12)


def test_binned_top_k_matches_numpy():
    v, vt = _data(n=2 * 256 + 100)
    qids = np.arange(0, 60, 3)
    block_n, bins = 256, 16
    ids, sims = knn.binned_top_k(vt, torch.from_numpy(qids), 4,
                                 block_n=block_n, bins=bins,
                                 tiles_per_chunk=1)
    s = _sims(v, v[qids])
    n = v.shape[0]
    for b in range(len(qids)):
        best = {}
        for r in range(n):
            key = (r // block_n, r % bins)
            if key not in best or s[b, r] > s[b, best[key]]:
                best[key] = r
        surv = sorted(best.values(), key=lambda r: -s[b, r])[:4]
        assert ids[b].tolist() == surv
        assert np.allclose(sims[b].numpy(), s[b, surv], atol=1e-12)


def test_bf16_operand_sims_round_the_product_only():
    v, vt = _data()
    qids = torch.tensor([5])
    rows = torch.tensor([[6]])
    got = float(knn.true_sims(vt, qids, rows, torch.bfloat16)[0, 0])
    vb = vt.to(torch.bfloat16).double().numpy()
    qq = (v[5].astype(np.float64) ** 2).sum()
    vv = (v[6].astype(np.float64) ** 2).sum()
    want = 1 - max(qq + vv - 2 * vb[5] @ vb[6], 0) / 2
    assert got == pytest.approx(want, abs=1e-12)


def _ivf_tables(v, c=8, m=4, ks=16, seed=2):
    rng = np.random.default_rng(seed)
    coarse = v[rng.choice(len(v), c, False)].astype(np.float64)
    assign = np.argmin(((v[:, None, :] - coarse[None]) ** 2).sum(-1), 1)
    resid = v - coarse[assign]
    dsub = v.shape[1] // m
    cb = rng.standard_normal((m, ks, dsub)) * 0.1
    codes = np.stack([np.argmin(((resid[:, j * dsub:(j + 1) * dsub, None]
                                  .transpose(0, 2, 1) - cb[j][None]) ** 2)
                                .sum(-1), 1) for j in range(m)], 1)
    return coarse, cb, assign, codes


def test_ivfadc_shortlists_match_numpy():
    v, vt = _data(n=2000, d=24)
    coarse, cb, assign, codes = _ivf_tables(v)
    ref = ivfadc.IVFADCReference(
        vt, torch.from_numpy(coarse), torch.from_numpy(cb),
        torch.from_numpy(assign), torch.from_numpy(codes))
    qids = np.arange(0, 40)
    k, pvf, w = 3, 5, 2
    lists = ref.shortlists(torch.from_numpy(qids), k, pvf, w, eps=0.0,
                           eps_cell=0.0)
    m, ks, dsub = cb.shape
    v64 = v.astype(np.float64)
    for b, q in enumerate(qids):
        cd = ((v64[q] - coarse) ** 2).sum(1)
        cells = np.argsort(cd)[:w]
        rows = np.nonzero(np.isin(assign, cells))[0]
        r = (v64[q][None] - coarse[assign[rows]]).reshape(-1, m, dsub)
        adc = sum(((r[:, j] - cb[j][codes[rows, j]]) ** 2).sum(1)
                  for j in range(m))
        cut = np.sort(adc)[k * pvf - 1]
        want = set(rows[adc <= cut].tolist())
        got_ids, got_s, strict = lists[b]
        assert set(got_ids.tolist()) == want
        s = _sims(v[got_ids.numpy()], v[[q]])[0]
        assert np.allclose(got_s.numpy(), s, atol=1e-12)


def test_build_misses_counts_a_wrong_code():
    v, vt = _data(n=2000, d=24)
    coarse, cb, assign, codes = _ivf_tables(v)
    args = [torch.from_numpy(x) for x in (coarse, cb, assign, codes)]
    rows = torch.arange(2000)
    assert ivfadc.build_misses(vt, rows, *args) == 0
    bad = codes.copy()
    bad[17, 1] = (bad[17, 1] + 1) % 16
    args[3] = torch.from_numpy(bad)
    assert ivfadc.build_misses(vt, rows, *args) == 1


def test_int8_control_reads_worse_than_the_reference():
    v, vt = _data()
    qids = torch.arange(0, 200, 3)
    ids, sims = lowp.top_k(vt, qids, 5, "int8")
    bad = torch.zeros(qids.shape[0], dtype=torch.bool)
    num = check.compare("join", (qids, ids, sims, bad), vt, 5,
                        targets=torch.arange(3000))
    assert num["sim_err"] > 1e-4 and num["bad_rows"] == 0
    ids, sims = knn.exact_top_k(vt, qids, 5)
    num = check.compare("join", (qids, ids, sims, bad), vt, 5,
                        targets=torch.arange(3000))
    assert num["sim_err"] < 1e-12 and num["miss_rate"] == 0.0


def test_parse_flags_malformed_answers():
    import json
    good = json.dumps({"result": [["w1", 0.9], ["w2", 0.8]]}).encode()
    short = json.dumps({"result": [["w1", 0.9]]}).encode()
    dup = json.dumps({"result": [["w1", 0.9], ["w1", 0.9]]}).encode()
    order = json.dumps({"result": [["w1", 0.8], ["w2", 0.9]]}).encode()
    unknown = json.dumps({"result": [["x1", 0.9], ["w2", 0.8]]}).encode()
    _, _, _, bad = check.parse([([0], p) for p in
                                (good, short, dup, order, unknown)],
                               2, 10, join=False)
    assert bad == [False, True, True, True, True]
    join = json.dumps({"result": [["w3", "w1", 0.9], ["w3", "w2", 0.8],
                                  ["w4", "w5", 0.7], ["w4", "w6", 0.6]]})
    qids, ids, _, bad = check.parse([([3, 4], join.encode())], 2, 10,
                                    join=True)
    assert qids == [3, 4] and ids == [[1, 2], [5, 6]] and bad == [False,
                                                                  False]
