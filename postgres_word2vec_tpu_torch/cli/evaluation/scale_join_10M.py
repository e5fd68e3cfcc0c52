"""A kNN-join at capacity scale: 5,000 queries joined against all
10,240,000 rows on one card, beside the bfloat16 exact scan.

The port's ``evaluation/scale_join_10M.py``: the selectivity regime
``ivpq_search_in`` exists for (ivpq_search_in.c:355-401: fetch only the
probed cells, so that the cost scales with selectivity, not |T|). The
exact comparator is the bf16 production scan (a float32 copy of the table
would take 12.3 GB beside it); the IVPQ probe reads the uint8 codes, the
coarse structure and, for its post-verify, the same bf16 table through a
pregathered handle (``prepare_join(vecs_pregathered=True)``, no second
copy of the rows).

The table is built as ``scale_capacity``'s (chunk ``i`` from seed
``1000 + i``, float32 norms before the bf16 cast); the queries are the
store's last ``--nq`` rows (also targets: the whole-store join has self
matches); the ground truth is the exact float32 top-10 of the first
``--eval-q`` queries over the bf16-rounded rows, computed on the card.
The IVPQ index is 30×32 over ``--k-coarse`` flat cells (4,096: at 1,024
a cell holds ~10k rows and an alpha-bounded probe reaches only one or two
cells); the joins run method 2, pvf 20, over the alpha ladder, median of
3 after a warm call, each with the scanned rows and rounds of the eval
queries.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.scale_join_10M \\
        [--n 10240000] [--nq 5000] [--alphas 600,1200,2400,4800] \\
        [--out reports/scale_join_10M_torch.json] [--device cpu]

Writes the record to ``--out`` and prints it; progress on stderr. On the
card the budget round is K6 or K7, as ``kernels.budget_adc_auto`` picks.
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    REPORTS, parse, wordlike_table, write_json)
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    exact_topk_chunks, last_samples, log, log_mem, recall_at_k, timeit)
from postgres_word2vec_tpu_torch.models.exact import exact_top_k_precast
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                     build_statistics)

#: queries per call of the exact baseline
EXACT_CHUNK = 512
#: timed trials (the median is reported), as bench.py's join protocol
TRIALS = 3


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--n", type=int, default=10_240_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=1_024_000)
    ap.add_argument("--nq", type=int, default=5000,
                    help="timed query-batch size")
    ap.add_argument("--eval-q", type=int, default=256,
                    help="queries scored against the ground truth")
    ap.add_argument("--alphas", default="600,1200,2400,4800")
    ap.add_argument("--k-coarse", type=int, default=4096)
    ap.add_argument("--out",
                    default=str(REPORTS / "scale_join_10M_torch.json"))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    N, D, NQ = args.n, args.d, args.nq
    log(f"scale_join: N={N} D={D} nq={NQ} device={dev}")
    results: dict = {"n": N, "d": D, "nq": NQ, "k": 5,
                     "ivpq": {"m": 30, "k": 32, "k_coarse": args.k_coarse}}

    t0 = time.perf_counter()
    table, norms = wordlike_table(N, D, args.chunk, dev)
    log(f"generated in {time.perf_counter() - t0:.1f}s")
    log_mem("table")
    qv = table[N - NQ:].float()

    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(torch.Generator(dev).manual_seed(3), table,
                           m=30, k=32, k_coarse=args.k_coarse,
                           coarse_positions=1, train_size=100_000, iters=25,
                           init="kmeans++")
    log(f"IVPQ built in {time.perf_counter() - t0:.1f}s "
        f"(codes {ivpq.codes.nbytes / 2**20:.0f} MiB)")
    log_mem("ivpq")

    t0 = time.perf_counter()
    _, gt10 = exact_topk_chunks(qv[:args.eval_q], table.split(args.chunk),
                                10)
    gt5 = gt10[:, :5]
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    # ------------------------------------------- exact bf16 scan baseline
    def ex_run(qb):
        return exact_top_k_precast(qb, table, norms, 5, chunk_size=262_144)

    def ex_all(q):
        for s in range(0, NQ, EXACT_CHUNK):
            _, ie = ex_run(q[s:s + EXACT_CHUNK])
        return ie

    ex_s, _ = timeit(ex_all, qv, iters=TRIALS)
    ex_trials = last_samples()
    _, ie = ex_run(qv[:args.eval_q])
    results["exact_bf16"] = {
        "total_s": ex_s, "trials_s": [round(t, 4) for t in ex_trials],
        "qps": NQ / ex_s, "recall5": recall_at_k(ie, gt5),
        "note": "bf16 production scan (a float32 table would take 12.3 GB "
                "at 10M)"}
    log(f"[exact_bf16] {ex_s:.3f}s qps={NQ / ex_s:.0f} "
        f"recall@5={results['exact_bf16']['recall5']:.3f}")
    log_mem("exact")

    # -------------------------------------------------- prepared IVPQ join
    tgt = torch.arange(N, device=dev)
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    t0 = time.perf_counter()
    ph = ivpq.prepare_join(tgt, vectors=table, vecs_pregathered=True)
    prep_s = time.perf_counter() - t0
    results["prepare_join"] = {"build_s": prep_s}
    log(f"prepare_join({N}) in {prep_s:.3f}s")
    log_mem("prepared")

    for a in (int(x) for x in args.alphas.split(",")):
        kw = dict(prepared=ph, statistics=stats, alpha=a, method=2,
                  confidence=0.8, pvf=20, impl="budget")
        j_s, _ = timeit(lambda q, kw=kw: ivpq.search_join(q, 5, **kw), qv,
                        iters=TRIALS)
        trials = last_samples()
        _, i2, info = ivpq.search_join(qv[:args.eval_q], 5,
                                       return_info=True, **kw)
        r = results[f"ivpq_join_pv_a{a}"] = {
            "total_s": j_s, "trials_s": [round(t, 4) for t in trials],
            "qps": NQ / j_s, "recall5": recall_at_k(i2, gt5),
            "scanned_rows_mean": float(info["retrieved"].float().mean()),
            "rounds": int(info["rounds"]), "alpha": a, "method": 2,
            "pvf": 20}
        log(f"[ivpq_join_pv_a{a}] {j_s:.3f}s qps={r['qps']:.0f} "
            f"recall@5={r['recall5']:.3f} "
            f"scanned~{r['scanned_rows_mean']:.0f}")

    write_json(args.out, results, 1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
