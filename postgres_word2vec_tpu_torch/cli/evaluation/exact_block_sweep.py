"""Fused exact-scan tile-size sweep: K1 at each ``block_n``.

The port's ``evaluation/exact_block_sweep.py``. The brute-force path
(``kernels.fused_exact_top_k``: K1, the bf16 scan fused with a
strided-bin min and argmin, then the survivors' top-k) walks the table
``block_n`` rows a tile: each block of K1 owns whole tiles and emits 128
bin survivors a tile for each query, so ``block_n`` sets how many
survivors the top-k reads (N / block_n · 128 a query) and how finely the
tiles spread over the SMs. This sweeps ``block_n`` at 3,072,000 × 300,
batch 1024 (the headline configuration).

The table is word-like rows (``synth.generate_wordlike``, a generator
seeded 0, on the device) cast to bf16; the queries are its first B rows
as float32. Per block size: ``kernels.tile_table``, then the scan timed
with ``benchutil.timeit_piped``; each tiling (~1.87 GB at the default) is
freed before the next. Keys ``bn{block_n}`` with ``scan_s``,
``per_query_ms``, ``eff_gbps`` (the bf16 table's bytes over the time, as in
the JAX record) and ``overlap_vs_first`` (the top-10 ids' overlap with the
first size's). K1 is bound by its bf16 products, not by the table's bytes,
so each size's log line also gives its bound from ``evaluation/bounds.py``.
A size the wrapper's checks refuse (``ValueError``: block_n not a multiple
of 128, or above 32,768) is recorded as ``{"failed": true, "error": …}``,
as the JAX script records a size its chip's memory refuses; a launch or
runtime error is never caught.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.exact_block_sweep \\
        [--n 3072000] [--d 300] [--b 1024] [--blocks 2048,4096,8192,16384] \\
        [--out reports/exact_block_sweep_torch.json] [--device cpu]

Writes the record to ``--out`` and prints ``{"best", "per_query_ms"}``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    REPORTS, parse, write_json)
from postgres_word2vec_tpu_torch.evaluation import bounds, synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    log, log_mem, materialize, timeit_piped)
from postgres_word2vec_tpu_torch.ops import kernels

K = 10


def sweep(table: torch.Tensor, queries: torch.Tensor, blocks
          ) -> tuple[dict, dict]:
    """K1's top-10 over the bf16 ``(N, d)`` ``table`` for the float32
    ``queries`` at each ``block_n`` of ``blocks`` → (record, {block_n:
    the (B, 10) distances and ids of each size that ran})."""
    n, d = table.shape
    b = queries.shape[0]
    results = dict(n=n, d=d, b=b)
    found = {}
    table_bytes = n * d * 2
    ref_ids = None
    for bn in blocks:
        t0 = time.perf_counter()
        tiled, norms, valid = kernels.tile_table(table, block_n=bn)
        materialize(tiled)
        log(f"bn={bn}: tiled in {time.perf_counter() - t0:.1f}s "
            f"({tuple(tiled.shape)})")

        def scan(qq, tiled=tiled, norms=norms, valid=valid, bn=bn):
            return kernels.fused_exact_top_k(qq, tiled, norms, K,
                                             valid_n=valid, block_n=bn)

        try:
            dists, ids = scan(queries)
        except ValueError as e:
            # the wrapper's checks refuse this size: record the no-go
            log(f"bn={bn}: refused ({e}); skipping")
            results[f"bn{bn}"] = dict(failed=True, error=str(e)[:300])
            del tiled, norms, scan
            continue
        t = timeit_piped(scan, queries)
        ids_h = ids.cpu().numpy()
        if ref_ids is None:
            ref_ids = ids_h
        overlap = float(np.mean([
            len(set(x) & set(y)) / K for x, y in zip(ids_h, ref_ids)]))
        gbps = table_bytes / t / 1e9
        results[f"bn{bn}"] = dict(
            scan_s=t, per_query_ms=t / b * 1e3, eff_gbps=gbps,
            overlap_vs_first=overlap)
        found[bn] = dists, ids
        # K1's work: queries, table and norms read once, the bin survivors
        # written once; 2·B·N·d bf16 operations
        n_pad, dp = tiled.shape
        ms, by, term = bounds.bound(
            b * dp * 2 + n_pad * dp * 2 + n_pad * 4
            + b * (n_pad // bn) * 128 * 8, 2 * b * n * d, "bf16")
        log(f"bn={bn}: {t * 1e3:.3f} ms/scan, {t / b * 1e6:.2f} µs/query, "
            f"{gbps:.0f} GB/s effective, overlap={overlap:.3f}; K1's bound "
            f"{ms:.4f} ms ({by}): {100 * ms / 1e3 / t:.1f} % of it")
        del tiled, norms, dists, ids, scan
    return results, found


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--n", type=int, default=3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--blocks", default="2048,4096,8192,16384")
    ap.add_argument("--out",
                    default=str(REPORTS / "exact_block_sweep_torch.json"))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    vf = synth.generate_wordlike(torch.Generator(dev).manual_seed(0),
                                 args.n, args.d)
    table = vf.to(torch.bfloat16)
    queries = table[:args.b].float()
    del vf
    materialize(table)
    log_mem("table")
    results, _ = sweep(table, queries,
                       [int(x) for x in args.blocks.split(",")])
    write_json(args.out, results, 1)
    best = min((v["scan_s"], k) for k, v in results.items()
               if isinstance(v, dict) and "scan_s" in v)[1]
    print(json.dumps({"best": best,
                      "per_query_ms": results[best]["per_query_ms"]}))
    return results


if __name__ == "__main__":
    main()
