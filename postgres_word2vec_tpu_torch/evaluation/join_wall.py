"""Wall time of the kNN-join, call by call.

The join and probe paths are host-bound (the card is busy a few percent of
a call), so their times spread widely from run to run and a handful of
calls cannot tell two versions of the code apart. This script builds the
IVPQ engine of ``chip_smoke.py`` (3,072,000 × 300 word-like vectors from
a seed, 30×32 codes over 1024 flat cells), joins 5,000 query words against
all rows (method 2, alpha 600: ten launches of the per-query budget ADC
kernel K6) or, with ``--targets 100000``, against the first 100,000 rows
prepared with their statistics (alpha 200, ``--method 0`` or 2: ten
launches of the grouped kernel K7) ``--reps`` times and prints the spread
of the synchronized host clock. It imports the package from the working
directory, so two checkouts are compared by running this file from the
root of each in turn::

    python <path to this file> --reps 25 [--targets 100000 --method 0]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

N, D = 3_072_000, 300
JOIN_Q, JOIN_K, ALPHA = 5000, 5, 600
BUILD = dict(train_size=100_000, iters=25, init="kmeans++",
             ivpq_k_coarse=1024, ivpq_coarse_positions=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--targets", type=int, default=N,
                    help="join against the first TARGETS rows (with their "
                         "statistics when fewer than all)")
    ap.add_argument("--method", type=int, default=2)
    args = ap.parse_args()
    alpha = ALPHA if args.targets >= N else 200

    import torch
    if not torch.cuda.is_available():
        print("join_wall needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())     # the checkout the script is run in
    from postgres_word2vec_tpu_torch import Freddy, VectorStore
    from postgres_word2vec_tpu_torch.evaluation import synth
    from postgres_word2vec_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    words = [f"w{i}" for i in range(N)]
    store = VectorStore.from_arrays(
        words, synth.generate_wordlike(gen, N, D), normalized=True)
    eng = Freddy.build(store, seed=args.seed, with_ivfadc=False,
                       with_ivpq=True, **BUILD)
    eng.prepare_targets(torch.arange(args.targets, device=dev), name="t")
    stats = None
    if args.targets < N:
        eng.create_statistics("t", words[:args.targets])
        stats = "t"
    eng.set_statistics_table(stats)
    eng.set_method_flag(args.method)
    eng.set_alpha(alpha)
    queries = words[N - JOIN_Q:]

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.knn_in_ivpq_batch(queries, JOIN_K, "t")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        call()
    kernels.reset_launch_counts()
    ms = sorted(call() for _ in range(args.reps))
    launches = {k: v / args.reps for k, v in kernels.launch_counts().items()
                if v}
    q = lambda f: ms[min(len(ms) - 1, int(f * len(ms)))]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"join over {args.targets} rows (method {args.method}, alpha "
          f"{alpha}), {JOIN_Q} queries, {args.reps} calls: "
          f"min {ms[0]:.1f} p25 {q(.25):.1f} p50 {q(.5):.1f} "
          f"p75 {q(.75):.1f} max {ms[-1]:.1f} ms per call "
          f"({q(.5) / JOIN_Q:.5f} ms/query at p50), launches per call "
          f"{launches}, on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
