"""Method 0 (ADC only) against method 2 (ADC + post-verify) in the IVPQ
kNN-join, at equal alpha.

The port's ``evaluation/join_method_diag.py``, which pinned a round-2
anomaly of the JAX package (method 0 measured 6.5× slower than method 2
though both run the same budget probe and differ only in the top-k
tail). It measures, each in isolation:

  a) the intrinsic cost: the per-chunk latency of method 0 and method 2
     (512 queries, warmed, interleaved A/B so that allocator and clock
     drift cancel);
  b) ordering: the full joins of ``--nq`` queries in both orders;
  c) the exact baseline's wake: method 0 timed right after an
     ``exact_top_k_in`` burst.

The joins run ``--nq`` tail rows of the store against its first ``--nt``
rows (alpha 200, confidence 0.8, the statistics of those targets).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.join_method_diag \\
        [--n 3072000 --nq 5000 --nt 100000] [--device cpu]
    BENCH_SMALL=1 python -m ...join_method_diag     # 307,200 / 500 / 10,000

Prints one JSON dict; progress on stderr. On the card the budget round is
K7 or K6, as ``kernels.budget_adc_auto`` picks.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import parse
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import (log,
                                                              materialize)
from postgres_word2vec_tpu_torch.models.exact import exact_top_k_in
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                     build_statistics)

#: queries per chunk of a join, and of the (a) rounds; interleaved A/B
#: rounds of (a)
CHUNK, REPS = 512, 6


def _parser():
    small = bool(int(os.environ.get("BENCH_SMALL", "0")))
    ap = arg_parser(__doc__)
    ap.add_argument("--n", type=int, default=307_200 if small else 3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--nq", type=int, default=500 if small else 5000)
    ap.add_argument("--nt", type=int, default=10_000 if small else 100_000)
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    N, D, nq, nt, K = args.n, args.d, args.nq, args.nt, 5

    V = synth.generate_wordlike(torch.Generator(dev).manual_seed(0), N, D)
    log(f"data {N}x{D} ready on {dev}")
    t0 = time.perf_counter()
    ivpq = IVPQIndex.build(torch.Generator(dev).manual_seed(3), V, m=30,
                           k=32, k_coarse=1024, coarse_positions=1,
                           train_size=100_000, iters=25, init="kmeans++")
    log(f"IVPQ built in {time.perf_counter() - t0:.1f}s")
    tgt = torch.arange(nt, device=dev)
    qv = V[N - nq:]
    stats = build_statistics(ivpq.cell_of, tgt, ivpq.num_cells)
    out = {}

    def join(method, n=None):
        kw = dict(alpha=200, method=method, confidence=0.8,
                  statistics=stats, query_chunk=CHUNK)
        if method == 2:
            kw.update(pvf=20, vectors=V)
        q = qv if n is None else qv[:n]
        materialize(ivpq.search_join(q, K, tgt, **kw))

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # ------------------------------------------------ warm both methods
    join(0, n=CHUNK)
    join(2, n=CHUNK)
    log("warmed")

    # a) interleaved single-chunk A/B: the intrinsic per-round cost.
    lat = {0: [], 2: []}
    for _ in range(REPS):
        for m in (0, 2):
            lat[m].append(timed(lambda m=m: join(m, n=CHUNK)))
    out[f"chunk{CHUNK}_method0_ms"] = round(np.median(lat[0]) * 1e3, 2)
    out[f"chunk{CHUNK}_method2_ms"] = round(np.median(lat[2]) * 1e3, 2)
    log(f"per-chunk median: m0={out[f'chunk{CHUNK}_method0_ms']}ms "
        f"m2={out[f'chunk{CHUNK}_method2_ms']}ms")

    # b) full-size joins in both orders.
    for order in ((0, 2), (2, 0)):
        for m in order:
            dt = timed(lambda m=m: join(m))
            key = f"full_m{m}_order{order[0]}{order[1]}"
            out[key] = round(dt, 3)
            log(f"{key}: {dt:.3f}s ({nq / dt:.0f} qps)")

    # c) the exact baseline's wake: an exact_top_k_in burst, then method 0
    #    at once (the JAX bench's exact sequence).
    mask = torch.ones(nt, dtype=torch.bool, device=dev)

    def burst():
        for s in range(0, nq, CHUNK):
            exact_top_k_in(qv[s:s + CHUNK], V, tgt, mask, K)

    materialize(exact_top_k_in(qv[:CHUNK], V, tgt, mask, K))
    burst()
    materialize(None)
    out["full_m0_after_exact"] = round(timed(lambda: join(0)), 3)
    log(f"m0 after exact burst: {out['full_m0_after_exact']}s")

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
