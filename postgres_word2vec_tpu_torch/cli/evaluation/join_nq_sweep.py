"""kNN-join query-batch-size sweep at 3M targets: the IVPQ probe against
the exact scan.

The port's ``evaluation/join_nq_sweep.py``. One full-table read
amortizes over a large query batch, which favours brute force; the
reference's serving pattern — interactive joins of modest query sets
against a statistics-table domain (ivpq_search_in.c:355-401, cost meant
to scale with selectivity) — issues far smaller batches, where the exact
scan still reads the whole table but the probe pays only the rows alpha
lets it scan. This sweep measures both at nq = 64…4096 against the whole
store (a prepared handle over all rows, pregathered), warm, median of
``--trials``, recall@5 of the first ``--eval-q`` queries against a
float32 ground truth:

- exact float32 full scan (recall 1.0), the ``knn_in_exact`` baseline;
- exact bfloat16 pre-cast scan, the production scan;
- the IVPQ probe, method 2 (ADC + post-verify), over an alpha ladder.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.join_nq_sweep \\
        [--n 3072000] [--nqs 64,256,1024,4096] [--alphas 600,1200,2400] \\
        [--out reports/join_nq_sweep_3M_torch.json] [--device cpu]

Writes the record to ``--out`` and prints ``{"out": ..., "nqs": ...}``;
progress on stderr. On the card the probe's budget round is K6 or K7, as
``kernels.budget_adc_auto`` picks.
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    REPORTS, parse, write_json)
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    last_samples, log, log_mem, recall_at_k, timeit)
from postgres_word2vec_tpu_torch.models.exact import (exact_top_k,
                                                      exact_top_k_precast)
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                     build_statistics)
from postgres_word2vec_tpu_torch.ops.vector_ops import row_sqnorms

#: queries per exact call: the (B, rows) score block of a 4096-query scan
#: would take ~8.6 GiB, so the exact comparators run 512 at a time
EXACT_CHUNK = 512


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--n", type=int, default=3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--nqs", default="64,256,1024,4096")
    ap.add_argument("--alphas", default="600,1200,2400")
    ap.add_argument("--pvf", type=int, default=20)
    ap.add_argument("--eval-q", type=int, default=256)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--out",
                    default=str(REPORTS / "join_nq_sweep_3M_torch.json"))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    N, D = args.n, args.d
    nqs = [int(x) for x in args.nqs.split(",")]
    alphas = [int(x) for x in args.alphas.split(",")]
    max_nq = max(nqs)
    log(f"join_nq_sweep: N={N} D={D} nqs={nqs} device={dev}")

    t0 = time.perf_counter()
    # bench.py's data
    V = synth.generate_wordlike(torch.Generator(dev).manual_seed(0), N, D)
    log(f"data generated in {time.perf_counter() - t0:.1f}s")

    # queries: the tail rows, also targets (a whole-store join with self
    # matches, the protocol of bench.py's 3M crossover rows)
    qv = V[N - max_nq:]
    V_bf = V.to(torch.bfloat16)
    norms = row_sqnorms(V)
    log_mem("tables")

    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(torch.Generator(dev).manual_seed(3), V, m=30,
                           k=32, k_coarse=1024, coarse_positions=1,
                           train_size=100_000, iters=25, init="kmeans++")
    log(f"IVPQ (flat 1024) built in {time.perf_counter() - t0:.1f}s")

    tgt = torch.arange(N, device=dev)
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    t0 = time.perf_counter()
    ph = ivpq.prepare_join(tgt, vectors=V, vecs_pregathered=True)
    prep_s = time.perf_counter() - t0
    log(f"prepare_join({N}) in {prep_s:.1f}s")
    log_mem("prepared")

    eq = min(args.eval_q, max_nq)
    _, gt = exact_top_k(qv[:eq], V, 5, chunk_size=524288)
    log("ground truth done")

    results: dict = {"n": N, "d": D, "nqs": nqs, "k": 5, "pvf": args.pvf,
                     "prepare_join_s": prep_s,
                     "ivpq": {"m": 30, "k": 32, "k_coarse": 1024},
                     "sweep": {}}

    def ex_f32(q):
        for s in range(0, len(q), EXACT_CHUNK):
            d_, i_ = exact_top_k(q[s:s + EXACT_CHUNK], V, 5,
                                 chunk_size=524288)
        return d_, i_

    def ex_bf16(q):
        for s in range(0, len(q), EXACT_CHUNK):
            d_, i_ = exact_top_k_precast(q[s:s + EXACT_CHUNK], V_bf, norms,
                                         5, chunk_size=524288)
        return d_, i_

    def row(fn, qb, nq):
        med, _ = timeit(fn, qb, iters=args.trials)
        ts = last_samples()
        _, ie = fn(qv[:eq])
        return {"total_s": med, "trials_s": [round(t, 4) for t in ts],
                "qps": nq / med, "recall5": recall_at_k(ie, gt)}

    for nq in nqs:
        qb = qv[:nq]
        sweep: dict = {}
        for name, fn in (("exact_f32", ex_f32), ("exact_bf16", ex_bf16)):
            sweep[name] = row(fn, qb, nq)
            log(f"[nq={nq} {name}] {sweep[name]['total_s']:.4f}s "
                f"qps={sweep[name]['qps']:.0f} "
                f"recall@5={sweep[name]['recall5']:.3f}")
        for a in alphas:
            def probe(q, a=a):
                return ivpq.search_join(
                    q, 5, prepared=ph, statistics=stats, alpha=a,
                    method=2, confidence=0.8, pvf=args.pvf,
                    query_chunk=min(nq, 512))
            key = f"ivpq_pv_a{a}"
            sweep[key] = row(probe, qb, nq)
            log(f"[nq={nq} {key}] {sweep[key]['total_s']:.4f}s "
                f"qps={sweep[key]['qps']:.0f} "
                f"recall@5={sweep[key]['recall5']:.3f}")
        results["sweep"][str(nq)] = sweep

    out = write_json(args.out, results, 1)
    print(json.dumps({"out": out, "nqs": nqs}))
    return results


if __name__ == "__main__":
    main()
