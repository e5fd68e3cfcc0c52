"""Capacity on one card: 10,240,000 × 300 rows, exact and PQ search at
production batch sizes.

The port's ``evaluation/scale_capacity.py``. The reference's headline
dataset is 3M × 300 (GoogleNews), bounded by Postgres shared buffers and
per-query SPI streaming; this run holds 10.24M rows on the card: the
bfloat16 table (6.1 GB), its float32 norms, the PQ codes and the
ground truth.

- The table is ``⌈n / chunk⌉`` chunks of word-like rows, chunk ``i``
  drawn from seed ``1000 + i``, norms taken in float32 before the bf16
  cast (``_research.wordlike_table``).
- The ground truth is the exact float32 top-10 of the first ``--eval-q``
  rows over the bf16-rounded rows (``benchutil.exact_topk_chunks``, on the
  card), and ``bin_collision`` counts the ground-truth pairs that share a
  slot of the binned scan (one survivor per (tile, strided bin)).
- ``exact_batch``: the bf16 pre-cast scan at B = 1024 (exact top-k);
  ``pq_scan`` and ``pq_pv_<pvf>``: the PQ scan at B = 64, and the scan
  shortlisting k·pvf rows re-ranked exactly against the bf16 table.
- ``--pq reference``: PQ 12×256 (uint8); ``--pq quality``: OPQ × 4-bit
  60×16, the rotation and codebook trained on the first 100,000 rows
  (``opq_iters=10, kmeans_iters=6``).
- ``--impl``: ``kernel_binned`` (K4, the default), ``kernel`` (K2) or
  ``plain`` (the plain PyTorch scan, only when asked for); the JAX
  script's ``pallas_binned`` / ``pallas`` / ``xla`` name the same three.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.scale_capacity \\
        [--n 10240000] [--pq reference|quality] [--pvf 20] [--skip-exact] \\
        [--out reports/scale_10M_torch.json] [--device cpu]

Writes the record to ``--out`` and prints it; progress on stderr.
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    REPORTS, parse, scan_impl, wordlike_table, write_json)
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    exact_topk_chunks, log, log_mem, recall_at_k, timeit)
from postgres_word2vec_tpu_torch.models.exact import exact_top_k_precast
from postgres_word2vec_tpu_torch.models.pq import (PQIndex, recount,
                                                   train_opq_rotation)
from postgres_word2vec_tpu_torch.ops import kernels, kmeans

def build_pq(table: torch.Tensor, regime: str, chunk: int) -> PQIndex:
    """The run's PQ index over the bf16 ``table``: ``reference`` 12×256
    trained on 100,000 sampled rows (kmeans++, 25 iterations), or
    ``quality``, OPQ × 4-bit 60×16 trained on the first 100,000 rows of
    the first ``chunk``-row chunk."""
    gen = torch.Generator(table.device).manual_seed(7)
    if regime == "reference":
        return PQIndex.build(gen, table, train_size=100_000, iters=25,
                             init="kmeans++", m=12, k=256)
    rot, cb = train_opq_rotation(gen, table[:min(100_000, chunk)].float(),
                                 60, 16,
                                 opq_iters=10, kmeans_iters=6)
    codes = kmeans.encode_subspaces(table, cb.centroids, rotation=rot)
    return PQIndex(recount(cb, codes), codes, rotation=rot)


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--n", type=int, default=10_240_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=1_280_000)
    ap.add_argument("--eval-q", type=int, default=256)
    ap.add_argument("--pq", default="reference",
                    choices=("reference", "quality"),
                    help="PQ regime: reference=12x256 uint8; quality="
                         "OPQ x 4-bit 60x16")
    ap.add_argument("--pvf", default="20",
                    help="comma-separated pvf sweep for the PV point")
    ap.add_argument("--impl", default="kernel_binned",
                    help="PQ scan: kernel_binned (K4), kernel (K2) or "
                         "plain; the JAX names pallas_binned, pallas and "
                         "xla name the same three")
    ap.add_argument("--skip-exact", action="store_true",
                    help="skip the exact batch scan (it does not depend on "
                         "the PQ regime; the reference-regime run measures "
                         "it)")
    ap.add_argument("--out", default=str(REPORTS / "scale_10M_torch.json"))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    impl = scan_impl(args.impl)
    N, D = args.n, args.d
    log(f"scale_capacity: N={N} D={D} pq={args.pq} impl={impl} "
        f"device={dev}")
    results = {"n": N, "d": D}

    t0 = time.perf_counter()
    table, norms = wordlike_table(N, D, args.chunk, dev)
    log(f"generated in {time.perf_counter() - t0:.1f}s "
        f"({table.nbytes / 2**30:.2f} GiB bf16)")
    log_mem("table")
    # the queries: rows of the first chunk
    head = table[:args.chunk]
    queries_eval = head[:args.eval_q].float()
    qb_64 = head[:64].float()

    t0 = time.perf_counter()
    results["pq_regime"] = args.pq
    pq = build_pq(table, args.pq, args.chunk)
    log(f"PQ built in {time.perf_counter() - t0:.1f}s (codes "
        f"{pq.codes.nbytes / 2**20:.0f} MiB {pq.codes.dtype})")
    log_mem("pq")

    t0 = time.perf_counter()
    _, gt10 = exact_topk_chunks(queries_eval, table.split(args.chunk), 10)
    gt5 = gt10[:, :5]
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    # The binned scan keeps ONE survivor per strided bin — bin key
    # (row // block_n, row % bins) — so two true neighbours whose row ids
    # collide lose one candidate before the top-k. Count the colliding
    # ground-truth pairs per query.
    block_n, bins = PQIndex._BLOCK_N, kernels.BINNED_BINS
    keys = ((gt10 // block_n) * bins + gt10 % bins).cpu().numpy()
    collisions = sum(int(len(r) - len(set(r.tolist()))) for r in keys)
    results["bin_collision"] = dict(
        colliding_gt10_pairs=collisions,
        rate=collisions / gt10.numel(),
        note=f"gt@10 neighbours sharing a (tile, strided-bin) slot of the "
             f"binned kernel (block_n={block_n}, bins={bins}): each "
             f"collision caps binned-scan recall@10 by one candidate")
    log(f"[bin_collision] {collisions} / {gt10.numel()} "
        f"({collisions / gt10.numel():.4f})")

    if args.skip_exact:
        log("[exact_batch] skipped (--skip-exact; regime-independent)")
        results["exact_batch"] = dict(
            skipped=True, note="regime-independent; measured in the "
            "reference-regime run")
    else:
        B = 1024
        qb = head[:B].float()

        def exact(q, k):
            return exact_top_k_precast(q, table, norms, k,
                                       chunk_size=262_144)

        t, _ = timeit(lambda q: exact(q, 10), qb)
        _, ids = exact(queries_eval, 10)
        _, ids5 = exact(queries_eval, 5)
        results["exact_batch"] = dict(
            per_query_ms=t / B * 1e3, batch=B,
            recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
            note=f"bf16 table, exact top-k, one card, {N} rows")
        log(f"[exact_batch] "
            f"{results['exact_batch']['per_query_ms']:.4g} ms/q "
            f"recall@10={results['exact_batch']['recall']:.3f}")
        log_mem("exact")
        del qb

    B = 64
    t, _ = timeit(lambda q: pq.search(q, 10, impl=impl), qb_64)
    _, ids = pq.search(queries_eval, 10, impl=impl)
    _, ids5 = pq.search(queries_eval, 5, impl=impl)
    results["pq_scan"] = dict(
        per_query_ms=t / B * 1e3, batch=B,
        recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
        note=f"ADC scan ({impl}) over {N} "
             f"{str(pq.codes.dtype).removeprefix('torch.')} codes")
    log(f"[pq_scan] {results['pq_scan']['per_query_ms']:.4g} ms/q "
        f"recall@10={results['pq_scan']['recall']:.3f}")

    for pvf in [int(x) for x in args.pvf.split(",")]:
        t, _ = timeit(lambda q, pvf=pvf: pq.search_pv(
            q, 10, pvf, table, impl=impl), qb_64)
        _, ids = pq.search_pv(queries_eval, 10, pvf, table, impl=impl)
        _, ids5 = pq.search_pv(queries_eval, 5, pvf, table, impl=impl)
        results[f"pq_pv_{pvf}"] = dict(
            per_query_ms=t / B * 1e3, batch=B,
            recall=recall_at_k(ids, gt10), recall5=recall_at_k(ids5, gt5),
            note=f"ADC + exact re-rank pvf={pvf} against the bf16 table")
        log(f"[pq_pv_{pvf}] "
            f"{results[f'pq_pv_{pvf}']['per_query_ms']:.4g} ms/q "
            f"recall@10={results[f'pq_pv_{pvf}']['recall']:.3f}")
    log_mem("pq_pv")

    write_json(args.out, results, 2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
