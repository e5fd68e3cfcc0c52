"""Recall-ceiling control: the recall a reference-equivalent quantizer
reaches on the synthetic data.

The port's ``evaluation/recall_ceiling.py``. The reference trains its
codebooks with scipy ``kmeans(train, k, iter=10)`` — 10 restarts of
Lloyd run to convergence, the best distortion kept
(quantizer_creation.py:13-33) — and encodes with exact 1-NN. The
``reference`` quality profile reproduces that (restarts=10, 30 Lloyd
iterations, random-row init); the search stage (full ADC scan, IVFADC
w=3 probe, exact re-rank) is the same math in every implementation, so
the recall is the data geometry's ceiling for FREDDY's method class at
these parameters. PQ@5/@10 and PQ+PV, IVFADC and IVFADC+PV against a
float32 exact scan of the first ``--queries`` rows.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.recall_ceiling \\
        --gen v3 --n 3072000 --quality reference [--out FILE] [--device cpu]

Prints one JSON dict; progress on stderr. On the card the PQ scan is K2,
its PV shortlist K4 and the IVFADC probe K6 (or K7).
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    parse, write_json)
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import (log,
                                                              recall_at_k)
from postgres_word2vec_tpu_torch.models.exact import exact_top_k
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex

QUALITY = {
    # scipy kmeans(iter=10): 10 restarts, converged Lloyd, random-row init.
    "reference": dict(restarts=10, iters=30, init="sample"),
    # the JAX package's round-1 build (single 10-iteration Lloyd run).
    "r1": dict(restarts=1, iters=10, init="sample"),
    # its round-2 production default: kmeans++ + longer single run.
    "ours": dict(restarts=1, iters=25, init="kmeans++"),
}

#: FREDDY's published recall at 3M (the reference's README.md:118-123)
REFERENCE_TARGETS = {"pq@5": 0.38, "pq_pv@5": 0.87, "ivfadc@5": 0.35,
                     "ivfadc_pv@5": 0.65,
                     "source": "reference README.md:118-123 (3M)"}


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--gen", choices=("v1", "v2", "v3"), default="v3")
    ap.add_argument("--n", type=int, default=307_200)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--quality", choices=sorted(QUALITY), default="reference")
    ap.add_argument("--pq-m", type=int, default=12)
    ap.add_argument("--pq-k", type=int, default=256)
    ap.add_argument("--k-coarse", type=int, default=1000)
    ap.add_argument("--train-size", type=int, default=100_000)
    ap.add_argument("--pvf", type=int, default=20)
    ap.add_argument("--w", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    q = QUALITY[args.quality]
    log(f"recall_ceiling: gen={args.gen} n={args.n} quality={args.quality} "
        f"{q} device={dev}")

    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(args.seed)
    if args.gen == "v1":
        V = synth.generate_mixture(gen, args.n, args.d)
    else:
        params = synth.V2_PARAMS if args.gen == "v2" else synth.V3_PARAMS
        V = synth.generate_wordlike(gen, args.n, args.d, **params)
    log(f"data in {time.perf_counter() - t0:.1f}s")

    queries = V[:args.queries]
    t0 = time.perf_counter()
    gt = {kk: exact_top_k(queries, V, kk, chunk_size=524288)[1]
          for kk in (5, 10)}
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    results = {"gen": args.gen, "n": args.n, "d": args.d,
               "quality": args.quality, "quality_params": q,
               "pq_m": args.pq_m, "pq_k": args.pq_k,
               "k_coarse": args.k_coarse, "pvf": args.pvf, "w": args.w,
               "reference_targets": REFERENCE_TARGETS}

    # ---------------------------------------------------------------- PQ
    t0 = time.perf_counter()
    pq = PQIndex.build(torch.Generator(dev).manual_seed(args.seed + 1), V,
                       m=args.pq_m, k=args.pq_k,
                       train_size=args.train_size, **q)
    log(f"PQ built in {time.perf_counter() - t0:.1f}s")
    for kk in (5, 10):
        _, ids = pq.search(queries, kk)
        results[f"pq@{kk}"] = recall_at_k(ids, gt[kk])
        _, ids = pq.search_pv(queries, kk, args.pvf, V)
        results[f"pq_pv@{kk}"] = recall_at_k(ids, gt[kk])
    log(f"PQ: @5={results['pq@5']:.3f} pv@5={results['pq_pv@5']:.3f} "
        f"@10={results['pq@10']:.3f} pv@10={results['pq_pv@10']:.3f}")
    del pq

    # ------------------------------------------------------------ IVFADC
    t0 = time.perf_counter()
    ivf = IVFADCIndex.build(torch.Generator(dev).manual_seed(args.seed + 2),
                            V, m=args.pq_m, k=args.pq_k,
                            k_coarse=args.k_coarse,
                            train_size=args.train_size, **q)
    log(f"IVFADC built in {time.perf_counter() - t0:.1f}s "
        f"(list_cap={ivf.list_cap})")
    for kk in (5, 10):
        _, ids = ivf.search(queries, kk, w=args.w)
        results[f"ivfadc@{kk}"] = recall_at_k(ids, gt[kk])
        _, ids = ivf.search_pv(queries, kk, args.pvf, V, w=args.w)
        results[f"ivfadc_pv@{kk}"] = recall_at_k(ids, gt[kk])
    log(f"IVFADC: @5={results['ivfadc@5']:.3f} "
        f"pv@5={results['ivfadc_pv@5']:.3f} @10={results['ivfadc@10']:.3f} "
        f"pv@10={results['ivfadc_pv@10']:.3f}")

    print(json.dumps(results))
    if args.out:
        log(f"wrote {write_json(args.out, results, 1)}")
    return results


if __name__ == "__main__":
    main()
