#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's paths at the bench scale (N = 3,072,000 ×
d = 300, bench.py's data size and BUILD settings) through the entry points
a user calls, and holds every hand-written kernel to its plain version:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the kernels of ``postgres_word2vec_tpu_torch/csrc`` from source;
3. each kernel against its plain PyTorch version on the card, at
   boundary shapes and at the main paths' shapes;
4. the paths, each with the launch counts set to 0 just before it and
   read just after: ``Freddy.build`` (PQ 12×256 with OPQ, IVFADC 12×256
   over 1000 cells, IVPQ 30×32 over a flat 1024-cell quantizer) on
   generated word-like data, then
   - slice 1: exact, PQ and PQ + post-verify kNN and the fused bf16 exact
     scan;
   - slice 2: IVFADC ``knn_batch`` and IVFADC + post-verify, the IVPQ
     kNN-join at 100,000 prepared targets with statistics (alpha 200,
     methods 0, 2 and 1) and over the whole store (alpha 600, method 2),
     and single-query ``knn_in_ivpq`` (methods 0 and 1);
   - slice 3, the int8 configuration: ``set_pq_lut_dtype("int8")``, then
     PQ and PQ + post-verify kNN, the join at 100,000 targets (methods 0
     and 2) and over the whole store (which keeps the float per-query
     kernel, with the JAX package's warning), and the int8 exact index;
   with recall against the float32 exact scan over the same targets;
5. times: p50 per query from CUDA events, kernel and plain version side
   by side, and each kernel alone against its plain version, with its
   bound at those shapes (the largest of HBM bytes, the walk kernels'
   and the ADC budget kernels' shared-memory lookup bytes, and peak
   operations) and, where one PyTorch call computes the same function,
   that call as a yardstick (K1 a bf16 ``torch.matmul``; K2 and K3
   ``F.embedding_bag`` over the LUTs; K6, K7 and K8 ``F.embedding_bag``
   over a plan's flat index; K9 a float32 ``torch.baddbmm``; K10 a bf16
   ``torch.bmm`` over pre-gathered tiles); a sweep
   at the main shape of the queries per block (K4 at 16 and 8, K2 at 16
   and 8, K3 and K5 at 64 and 32), of K10's bf16 parts per query value at
   the join's shape (3, the kernel's; 2 and 1), of K6's slots per block
   and ring depth at the 3M join's, the IVFADC batch's and the 100k join's
   shapes, of K8's and K7's staged widths at the join's shape, and of K9's
   blocks per slot at the single query's plan; K6's time and bound at the
   3M and the 100k join's shapes, K7's beside it with its pair layout
   alone, K9 alone at the single query and at the join's batch; the
   join's group sizes;
6. only with ``--profile OUT.json``: a ``torch.profiler`` window of 3
   calls per path, written to OUT.json — host wall and device time per
   call, the device's busy share, the top device kernels, and each
   hand-written kernel's device time per launch without its torch glue;
7. slice 9, the rest of the engine on the same engine, each call with
   the launch counts set to 0 before it and read after it, and timed:
   in-set kNN over the first 100,000 rows (``knn_in_exact``,
   ``knn_in_pq``, ``knn_in_pq_batch`` on 5,000 queries with its recall@5,
   ``knn_in_matrix``; K2 held bit-equal to its plain version on the
   gathered (m, 100000) table), 64 seeded analogies through all ten
   methods (the exact ones equal to a float32 argmax computed here, the
   accelerated ones' agreement with exact 3CosAdd above a floor), both
   groupings over 10,000 tokens and 100 groups, the three clusterings over
   2,000 tokens with k = 20, ``tokenize`` / ``tokenize_raw`` against the
   direct mean, ``autotune`` and ``autotune_join`` with their reports,
   ``warmup``, a ``vecs_pregathered`` handle over the whole store (its
   peak memory growth below a gathered copy's, its method-2 join equal to
   the store-table handle's), the unprepared join's tile cache (the second
   call reports no data retrieval), and a FREDDY dump exported and
   imported back on the card for a 20,000-row engine;
8. serving on the card (slice 10): the port's ``AsyncQueryServer`` over
   the same engine (exact /knn on the fused bf16 index, K1), loaded by
   the load driver's raw-socket client processes
   (``evaluation/serving_bench.py``, 32 clients, a few seconds a window):
   /knn for the exact, PQ + PV20 and IVFADC + PV20 families, /knn_in over
   the 100,000-row target set (exact and PQ cores), /knn_join with
   16-query requests against the prepared set (method 2, alpha 200), each
   window a path with its QPS, p50/p99, errors, coalesced batch, stage
   times and the card's busy share over one sampled second; 256 served
   answers a family held to the engine's own batched call; every other
   endpoint once; a bad word coalesced with good ones failing alone;
   ``pipeline_depth`` 1, 2 and 4; the echo floor of the same fleet; one
   window of the threaded ``QueryServer`` (and, in phase 7, /insert
   through the server on the migrated 20,000-row engine);
9. the streaming builders (``models/builders.py``): PQ 12×256 and IVFADC
   (1000 cells) trained on 100,000 rows, the 3,072,000 rows streamed in
   262,144-row batches with a checkpoint and ``resume`` halfway, the codes
   bit-equal to one encode of the table, rows/s;
10. anisotropic refinement: an OPQ 12×256 ``PQIndex.build`` with
    ``aniso_eta=4`` beside the same build without it (build time,
    recall@10 of PQ and PQ + PV20);
11. the evaluation harness: ``time_precision_sweep`` (methods 0-2, pvf 1,
    5, 20), ``confidence_eval``, ``target_count_eval`` and an HTML report;
12. row sharding (slice 11) on the same store and indexes: a second
    engine sharded over meshes of 4 × 1 and 2 × 2 entries of the one card
    (``enable_sharding``); exact, PQ (float and int8 LUTs), PQ + PV20,
    IVFADC, IVFADC + PV20 and in-set exact and PQ at B = 256, k = 10, held
    to the unsharded engine; IVFADC's escalation at k = 3,072 from w = 1
    held, query by query, to the tiled probe at its last width; the join
    at the 100,000 prepared targets (alpha 200, methods 0, 1, 2) through
    the engine (the dense round, K2) against the unsharded dense join, the
    budget round (K6/K7, K9/K10 at ``block_t`` 128) against the dense
    round, and the whole budget join at 1,024 queries; K2, K3, K6, K7, K9
    and K10 at the shard shapes against their plain versions; each family
    timed beside its unsharded twin (R shards of one card: the
    shard-and-merge overhead, not multi-GPU scaling);
13. last, so that the numbers above are unchanged, slice 3's online
    insert: ``insert_batch`` of 10,240 new two-word terms in 4 batches of
    2,560 (the fourth crosses the IVFADC tail's 8,192 rows, so the tail
    is spliced into the lists on the card), a standalone int8 exact index
    extended with each batch and held to a fresh build, every inserted
    term its own exact top-1, PQ-PV and IVFADC-PV self-recall before and
    after the splice, and the int8 kernels and K6 launched on the grown
    tables;
14. the command-line drivers (``postgres_word2vec_tpu_torch.cli``), after
    the phase-4 engine and the sharded one are released, every file they
    write in a temporary directory: the offline chain as ``python -m``
    subprocesses with no ``--device`` (so on the card) over the first
    262,144 rows of the phase-4 store written as a word2vec ``.bin``
    (``vec2database``, ``pq_index``, ``ivfadc`` and ``ivpq`` on the
    shipped configs, IVPQ with a 20,000-word statistics domain,
    ``load_index`` of each with a floor on its self-match,
    ``transform_vecs`` read back equal, ``import_freddy`` export and
    import bit-equal), each exiting 0 with no process left; the
    evaluation drivers in-process on their shipped 3M configs
    (``time_precision_eval`` on ``time_precision_full.json``, the
    README's figure, with its precision floors and the kernels of each
    join method and of the PQ baseline; ``step_wise``,
    ``confidence_eval`` with its guarantee, ``target_counts`` with a
    ceiling, ``flexible_pq_eval``); ``time_measurement`` in its six
    methods, ``vec_distr`` and the three examples (the mesh one on 4 × 1
    entries of the card); each driver's wall time, launches and key
    numbers; nothing under ``reports/`` changes;
15. the research drivers (``cli/evaluation``) in-process, each at its
    JAX record's scale and flags: ``roofline`` (the card's ceilings, the
    exact bf16 and int8 and the PQ ADC scans at 3M), ``recall_ceiling``
    (v3, 3,072,000 rows, the reference quality), ``synth_calibrate``
    (307,200 rows, configs v2 and f15), ``join_nq_sweep`` and
    ``join_method_diag`` at 3M, ``scale_capacity`` at 10,240,000 rows in
    both PQ regimes and ``scale_join_10M`` (5,000 queries against all
    10,240,000 rows); each driver's wall time, launches, peak memory and
    key numbers beside the JAX record's, held to floors; the memory
    allocated after each is under 1 GiB; K4 at 10.24M rows and 60×16 and
    the 10.24M join's budget kernel held to their plain versions on their
    main-path launch; nothing under ``reports/`` changes;
16. the last entry points: ``graft_entry.entry()``'s forward step (one
    launch of K2, held to the same forward over the index on the CPU),
    ``graft_entry.dryrun_multichip`` on 4 and 8 entries of the one card
    (the shard-and-merge overhead, not multi-GPU scaling), and the three
    kernel sweeps at their JAX records' defaults: ``budget_kernel_sweep``
    (K6 against K7 at rows 8–64 and K8 at rows 16 and 32, each held to K6),
    ``adc_kernel_probe --sweep`` (K2 against K4 at B 64 and 256 in both
    regimes, then K4's block_n × bins × queries per block, its first point
    held to the plain version) and ``exact_block_sweep`` (K1 at block_n
    2048–16,384, the top-10 overlap of each with the first); each step's
    wall time, launches and peak memory; nothing under ``reports/``
    changes;
17. last, the benchmark driver: ``cli.bench`` (the port of ``bench.py``)
    at full scale, 3,072,000 × 300, in a process of its own (it reads a
    ``torch.profiler`` trace, BENCH_CHILD), its record in a temporary
    directory: every row that ``bench.py`` emits at full scale (the
    committed ``BENCH_LOCAL_latest.json``'s) present, each logged with
    its time, recall@5 and @10 and its launches, the one line under
    2,048 B, the insert probe true, recall@5 above ``BENCH_FLOORS``, each
    of K1–K8 launched and held to its plain version on its first launch,
    the launches of each section, the table that the port's
    ``gen_readme_table`` renders from the record; nothing under
    ``reports/`` nor ``BENCH_LOCAL_latest.json`` changes;
18. run between 12 and 13, on the phase-4 engine before its insert: the
    served /knn_join round replayed from its two captured CUDA graphs
    (selection; scan per plan size P) against the same round run eager,
    at both join cells' statement shapes (1,024 words against "t100k"
    with statistics, PQ + PV, α 200 in long codes and α 10,000 at
    threshold 0 in short codes): rows, answers, counts and launches equal,
    ``join_graph_rounds`` 1 and ``join_host_reads`` 5 a warm statement;
    the facade's ms a statement eager and replayed, P, the graphs held,
    the memory their pool pins and the peak while they replay.

Usage: ``python3 chip_smoke.py [--profile OUT.json] [--bench-out
BENCH.json]`` from the repository root, on a machine with one CUDA GPU;
``--bench-out`` also writes phase 17's record there. It fails (non-zero
exit, no result line) without CUDA, without the package beside it, or
when any check fails. The line before the last is a JSON object of
per-kernel numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
import warnings

N, D = 3_072_000, 300
K = 10
EVAL_Q = 256
FUSED_B = 1024
BUILD = dict(train_size=100_000, iters=25, init="kmeans++")
# bench.py:378 (IVFADC) and bench.py:498-499 (IVPQ, flat 1024 cells).
PROBE_BUILD = dict(k_coarse=1000, ivpq_k_coarse=1024,
                   ivpq_coarse_positions=1)
JOIN_T, JOIN_Q, JOIN_K = 100_000, 5000, 5     # bench.py:497-503
SEED = 0
# Sanity floors, well below the JAX package's r05 columns on its own data
# (OPQ@5 0.574, PQ+PV20@5 0.916, fused exact ~0.99, IVFADC@5 0.538,
# IVFADC+PV20@5 0.936, join a200@5 0.878, join a600 over 3M @5 0.823).
FLOORS = {"pq@5": 0.45, "pq_pv@5": 0.85, "fused@10": 0.95,
          "ivfadc@5": 0.40, "ivfadc_pv20@5": 0.80, "join_m2_a200@5": 0.75,
          "join_m1_a200@5": 0.75, "join_3M_m2_a600@5": 0.70,
          # slice 3 (the JAX r05 exact_int8 column is 0.985)
          "pq_int8_pv20@5": 0.85, "exact_int8@10": 0.95}
# int8 recall no more than this below the same run's float-LUT recall
INT8_DROP = {"pq_int8@5": "pq@5", "join_int8_m2_a200@5": "join_m2_a200@5"}
INT8_MAX_DROP = 0.02
# K2/K4/K6/K7 sum subspaces in the plain version's order (K2, K4 and K7 are
# held to bit equality, K4's ids too); K9/K10 sum 304 float32 products in
# another order;
# K3/K5/K8 sum exactly in integers and round the one rescale as the plain
# version does; K8 also rounds its row-term add on its own (__fmul_rn, then
# __fadd_rn); K1 sums bf16 products on the tensor cores in another order.
TOL = {"adc_scan": 0.0, "adc_scan_binned": 0.0, "fused_exact_scan": 1e-3,
       "budget_adc": 1e-5, "budget_adc_grouped": 0.0, "budget_exact": 1e-4,
       "budget_exact_grouped": 1e-4, "adc_scan_int8": 0.0,
       "adc_scan_binned_int8": 0.0, "budget_adc_grouped_int8": 0.0}
BUDGET_BOOKS = ((12, 256, "uint8"), (30, 32, "uint8"), (15, 1024, "int16"))
# K1/K2/K4's boundary codebooks (slice 1's)
SCAN_BOOKS = ((12, 256, "uint8"), (60, 16, "uint8"), (12, 1024, "int16"))
# and the IVPQ join's, whose dense round K2 also serves
JOIN_BOOKS = ((30, 32, "uint8"), (15, 1024, "int16"))
# K3/K5's boundary codebooks: slice 1's, the budget ones and 4-bit 12×16
I8_BOOKS = ((60, 16, "uint8"), (12, 1024, "int16"), (12, 16, "uint8"),
            *BUDGET_BOOKS)
# the slice-9 phase: analogy triples, grouping and clustering token sets,
# texts for tokenize, the migrated engine's rows. Floors below the measured
# values (the lowest of three runs in brackets; the builds differ run to
# run), catching a broken path, not drift.
ANALOGY_N, GROUP_T, GROUP_G, CLUSTER_T, CLUSTER_K = 64, 10_000, 100, 2_000, 20
TOKENIZE_N, MIGRATE_N = 256, 20_000
ENGINE_FLOORS = {"knn_in_pq_batch@5": 0.45,                     # (0.5602)
                 "analogy_3cosadd_pq": 0.35,                    # (0.4688)
                 "analogy_3cosadd_ivfadc": 0.2,                 # (0.3750)
                 "analogy_3cosadd_in_pq": 0.05,                 # (0.1719)
                 "analogy_3cosadd_in_ivpq": 0.05,               # (0.1719)
                 "grouping_func_pq": 0.5}                       # (0.6611)
# the serving phase: client processes, window seconds (the short windows:
# /knn_in, the depth sweep, the echo floor, the threaded front end),
# served answers held to the engine's per family, queries per /knn_join
SERVE_CLIENTS, SERVE_S, SERVE_S_SHORT = 32, 4.0, 3.0
SERVE_CHECK, JOIN_BATCH = 256, 16
# the builders phase streams the table in batches of this many rows
BUILDER_BATCH = 262_144
# anisotropic refinement: its eta, and sanity floors on its recall@10 set
# below the measured values (the plain OPQ build's in brackets, PR 9 run 2)
ANISO_ETA = 4.0
ANISO_FLOORS = {"pq@10": 0.3, "pq_pv20@10": 0.85}       # (0.6043, 0.9969)
# the sharding phase: its meshes (rows, q) of entries of the one card, and
# a k near the mean IVFADC cell, so that w = 1 leaves some queries short
SHARD_MESHES = ((4, 1), (2, 2))
SHARD_ESCALATE_K = 3072
# the insert phase: new two-word terms, in batches
INSERT_TERMS, INSERT_BATCH = 10_240, 2_560
INSERT_FLOORS = {"pq_pv20_self@5": 0.9, "ivfadc_pv20_self@5": 0.8}
# the drivers phase: the offline chain's rows (the head of the phase-4
# store; a compressed 3M store would take minutes to write), the IVPQ
# statistics domain, load_index's floor on self-match@1 over its 4 probes
# (ADC distances are not 0 on a row's own code) and a ceiling on the
# target-count model's mean relative error (the JAX 3M record: 2.6 %)
OFFLINE_N, STATS_WORDS = 262_144, 20_000
SELF_MATCH_FLOOR, TARGET_COUNT_CEILING = 0.75, 0.10
# the research drivers phase: each driver's arguments (its JAX record's
# scale and flags; synth_calibrate runs two of its 35 configs), and floors
# that catch a broken path, not drift, set below the JAX records in
# reports/ (their values in the comments) by margins like FLOORS'. The
# drivers' rows are drawn on the card, so they differ from the records'.
SCALE_N = 10_240_000
RESEARCH_ARGS = {
    "roofline": [],
    "recall_ceiling": ["--gen", "v3", "--n", "3072000",
                       "--quality", "reference"],
    "synth_calibrate": ["--n", "307200", "--configs", "v2,f15"],
    "join_nq_sweep": [],
    "join_method_diag": [],
    "scale_capacity_reference": ["--n", str(SCALE_N), "--pq", "reference"],
    "scale_capacity_quality": ["--n", str(SCALE_N), "--pq", "quality",
                               "--skip-exact"],
    "scale_join_10M": ["--n", str(SCALE_N), "--nq", "5000"],
}
RESEARCH_FLOORS = {
    # recall_ceiling_v3_3M.json: 0.428, 0.907, 0.530, 0.918
    "recall_ceiling": {"pq@5": 0.33, "pq_pv@5": 0.84, "ivfadc@5": 0.40,
                       "ivfadc_pv@5": 0.84},
    # synth_calib_307k.json: v2 0.585, 0.973; f15 is V3, whose 3M record
    # (recall_ceiling_v3_3M.json) has 0.428, 0.907
    "synth_calibrate": {"v2": {"pq@5": 0.45, "pq_pv@5": 0.88},
                        "f15": {"pq@5": 0.33, "pq_pv@5": 0.84}},
    # join_nq_sweep_3M.json: exact f32 1.0, bf16 0.991, a2400 0.909
    "join_nq_sweep": {"exact_f32": 1.0, "exact_bf16": 0.95,
                      "ivpq_pv_a2400": 0.80},
    # scale_10M_reference.json, recall@10: exact 0.989, PQ 0.347, PV 0.723
    "scale_capacity_reference": {"exact_batch": 0.95, "pq_scan": 0.25,
                                 "pq_pv_20": 0.62},
    # scale_10M_quality.json, recall@10: PQ 0.745, PV 0.992
    "scale_capacity_quality": {"pq_scan": 0.60, "pq_pv_20": 0.95},
    # scale_join_10M.json, recall@5: exact bf16 0.995, a600 0.612, a4800
    # 0.909
    "scale_join_10M": {"exact_bf16": 0.95, "ivpq_join_pv_a600": 0.50,
                       "ivpq_join_pv_a4800": 0.80},
    # the card's ceilings (roofline_3M.json holds a TPU's): far below the
    # H100's data-sheet peaks of 3,350 GB/s, 989 and 1,979 TFLOP/s
    "roofline": {"hbm_read_gbps": 1500.0, "mxu_bf16_tflops": 300.0,
                 "mxu_int8_tops": 300.0},
}
# recall may fall by at most this much from one alpha to the next larger
ALPHA_SLACK = 0.005
# the kernel sweeps phase: each sweep's arguments (its JAX record's
# defaults; the ADC probe with its block-shape sweep), and the least
# top-10 overlap of every K1 tile size with the first
# (reports/exact_block_sweep.json: 1.0, 1.0, 0.9999)
SWEEP_ARGS = {"budget_kernel_sweep": [], "adc_kernel_probe": ["--sweep"],
              "exact_block_sweep": []}
EXACT_OVERLAP_FLOOR = 0.999
# a sweep run in a process of its own: ``python -c SWEEP_CHILD <sweep>
# <args>`` runs its ``main`` and prints, as the last line of stderr, its
# record, its launches and its peak memory
SWEEP_CHILD = """
import importlib, json, sys
import torch
from postgres_word2vec_tpu_torch.ops import kernels
res = importlib.import_module("postgres_word2vec_tpu_torch.cli.evaluation."
                              + sys.argv[1]).main(sys.argv[2:])
torch.cuda.synchronize()
print(json.dumps({"record": res, "peak_gib":
                  torch.cuda.max_memory_allocated() / 2**30, "counts":
                  {k: v for k, v in kernels.launch_counts().items() if v}}),
      file=sys.stderr)
"""
# the bench phase (17): recall@5 floors on bench.py's rows, set below the
# JAX r05 columns (BENCH_r05.json: PQ 0.446, PQ + PV20 0.916, OPQ 0.574,
# IVFADC 0.538, IVFADC + PV 0.936, best quality 0.998, the 3M join at
# alpha 2400 0.912) by margins like FLOORS'; the port's rows are drawn on
# the card, so they differ from the record's
BENCH_FLOORS = {"pq_scan": 0.38, "pq_pv_20": 0.85, "pq_opq_scan": 0.50,
                "ivfadc_batch_w3": 0.45, "ivfadc_pv": 0.85,
                "pq4bit_opq_pv_20": 0.95, "ivpq_join_pv_a2400_3M": 0.85}
# the kernels of bench.py's main path, each held to its plain version
BENCH_KERNELS = ("fused_exact_scan", "adc_scan", "adc_scan_int8",
                 "adc_scan_binned", "adc_scan_binned_int8", "budget_adc",
                 "budget_adc_grouped", "budget_adc_grouped_int8")
# the bench in a process of its own: ``python -c BENCH_CHILD <bench args>``
# runs ``cli.bench.main`` with each of BENCH_KERNELS held to its plain
# version on its first launch (``bench_holds``) and the launches of each
# section counted, and prints, as the last line of stderr, the holds, the
# launches of the run and of each section and its peak memory
BENCH_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from postgres_word2vec_tpu_torch.cli import bench
from postgres_word2vec_tpu_torch.ops import kernels
sections = {}
def counted(name, fn):
    def run(*args, **kw):
        before = kernels.launch_counts()
        try:
            return fn(*args, **kw)
        finally:
            sections[name] = {k: v - before[k] for k, v in
                              kernels.launch_counts().items() if v > before[k]}
    return run
for name in ("time_exact", "ground_truth", "exact_section", "pq256_section",
             "opq_section", "pq4bit_section", "pq4bit_opq_section",
             "pq1024_section", "ivfadc_section", "ivfadc4bit_section",
             "join_section", "large_target_section", "insert_section"):
    setattr(bench, name, counted(name, getattr(bench, name)))
held = {}
kernels.reset_launch_counts()
with cs.bench_holds(torch, kernels, held):
    bench.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"held": held, "sections": sections, "peak_gib":
                  torch.cuda.max_memory_allocated() / 2**30, "counts":
                  {k: v for k, v in kernels.launch_counts().items() if v}}),
      file=sys.stderr)
"""
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def stop_children() -> None:
    """Fail if a process this script started is still running, after
    killing and reaping it: the script leaves no process behind."""
    import signal

    from postgres_word2vec_tpu_torch.evaluation import serving_bench as sb

    left = sb.child_processes()
    for entry in left:
        pid = int(entry.split()[0])
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
    check(not left, f"processes still running at the end: {left}")
    log("[end] no child process left")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def ptxas_report(compiler_output: str, kernels: tuple[str, ...],
                 int16: tuple[str, ...] = ()) -> list[tuple[str, int, int]]:
    """Registers and spill bytes (stores + loads) that ``ptxas -v``
    reported for each instantiation of ``kernels`` with uint8 codes or no
    code type (K9, K10, the pair layout), and of ``int16`` with int16
    codes too, e.g. ``("adc_scan_kernel<16>", 39, 0)``. Template
    arguments: the queries per block (K7: its fixed LUT row stride and its
    rows a thread; K9: its 16-byte chunks a lane; K10: its bf16 parts),
    then ``packed``/``unpacked`` for K3's, K5's and K8's sums, and
    ``int16`` for int16 codes."""
    out, name, spill = [], None, -1
    entry = re.compile(r"Compiling entry function '_Z(\d+)(\w+)'")
    for line in compiler_output.splitlines():
        m = entry.search(line)
        if m:
            name, spill = None, -1
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            targs = re.match(r"I(\w+?)Ev", rest)
            args = targs.group(1) if targs else ""
            wide = base in int16 and args.endswith("s")
            if base in kernels and (not args or args.endswith("h") or wide
                                    or re.fullmatch(r"(Li\d+E)+", args)):
                args = re.sub(r"Li(\d+)E", r"\1,", args[:-1] if args[-1:]
                              in ("h", "s") else args)
                args += "int16" if wide else ""
                args = args.replace("Lb1E", "packed,").replace("Lb0E",
                                                               "unpacked,")
                args = args.rstrip(",")
                name = f"{base}<{args}>" if args else base
            continue
        if name is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp:
            spill = int(sp.group(1)) + int(sp.group(2))
        rg = re.search(r"Used (\d+) registers", line)
        if rg:
            out.append((name, int(rg.group(1)), spill))
            name = None
    return out


def _traced(torch, fn, n: int = 1):
    """A ``torch.profiler`` trace of ``n`` calls of ``fn``, after one call
    to warm up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof


def device_kernels(torch, fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, by name."""
    names = [e.name for e in _traced(torch, fn).events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(names, "the profiler recorded no device kernel")
    return [m.group(1) if (m := re.search(r"(\w+_kernel)\b", n)) else n
            for n in names]


def device_ms(torch, run, names: tuple[str, ...], n: int = 20) -> float:
    """Device time per call of ``run`` (launches through a C entry point,
    0 on success) of the kernels ``names``, over ``n`` traced calls: the
    kernels' own time on the card, without the gaps that the host leaves
    between launches of a few microseconds."""
    def launch():
        check(run() == 0, "a sweep launch failed")

    pat = re.compile(r"(?<![\w])(" + "|".join(names) + r")(?![\w])")
    # a trace has come back without the kernel's records though every
    # launch returned 0 (once, in K7's sweep): trace again
    for _ in range(3):
        ts = [e.self_device_time_total
              for e in _traced(torch, launch, n).key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and pat.search(e.key)]
        if ts:
            break
    check(ts, f"the profiler recorded none of {names}")
    return sum(ts) / 1e3 / n


def recall_at(ids, gt, k: int) -> float:
    a, g = ids[:, :k].cpu().numpy(), gt[:, :k].cpu().numpy()
    return sum(len(set(x.tolist()) & set(y.tolist()))
               for x, y in zip(a, g)) / g.size


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> list[float]:
    """Per-call device times in ms from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def p50(xs):
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


def budget_err(torch, got, want, name: str, what: str) -> float:
    """A budget kernel's output against its plain version: the same +inf
    entries, no NaN, finite entries within the kernel's tolerance."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin) and not torch.isnan(got).any(),
          f"{name} {what}: +inf entries differ from the plain version")
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    check(err <= TOL[name], f"{name} {what}: err {err} > {TOL[name]}")
    return err


@contextlib.contextmanager
def plain_kernels(kernels):
    """Run the kernels' plain versions on the card inside the block (for
    the plain side of the path times; nothing here counts a launch). The
    grouped kernels' plain versions are the per-query ones."""
    def ungrouped(plain):
        return lambda *args, rows=None, **kw: plain(*args, **kw)

    def int8_luts(plain):
        """``plain`` over float LUTs, or over their int8 quantization and
        its scale for ``lut_dtype="int8"``."""
        def run(luts, *args, rows=None, lut_dtype="bf16", **kw):
            if lut_dtype == "int8":
                q, sc = kernels.quantize_luts_int8(luts)
                return plain(q, *args, scale=sc, **kw)
            return plain(luts, *args, **kw)
        return run

    def scaled(plain):
        return lambda luts, scale, *args, rows=None, **kw: plain(
            luts, *args, scale=scale, **kw)

    swap = {"adc_scan": int8_luts(kernels.adc_scan_plain),
            "adc_scan_int8": scaled(kernels.adc_scan_plain),
            "adc_scan_binned_int8": scaled(kernels.adc_scan_binned_plain),
            "budget_adc": kernels.budget_adc_plain,
            "budget_adc_grouped": int8_luts(kernels.budget_adc_plain),
            "budget_adc_grouped_int8": scaled(kernels.budget_adc_plain),
            "budget_exact": kernels.budget_exact_plain,
            "budget_exact_grouped": ungrouped(kernels.budget_exact_plain)}
    saved = {name: getattr(kernels, name) for name in swap}
    for name, fn in swap.items():
        setattr(kernels, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def boundary_checks(torch, kernels) -> None:
    """Phase 3a: K1/K2/K4 against their plain versions at the block
    boundaries N ∈ {2047, 2048, 2049, 8191, 8193}, B ∈ {1, 257}, and the
    three codebook shapes of SCAN_BOOKS (12×256 uint8, 60×16 uint8,
    12×1024 int16); K2, which the join's dense round also calls, at
    JOIN_BOOKS (30×32 uint8, 15×1024 int16) too."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n_cases = 0
    for n in (2047, 2048, 2049, 8191, 8193):
        for B in (1, 257):
            for m, k, dt in SCAN_BOOKS + JOIN_BOOKS:
                luts = torch.rand(B, m, k, generator=g, device="cuda") * 4
                codes_t = torch.randint(0, k, (m, n), generator=g, device="cuda"
                                        ).to(getattr(torch, dt)).contiguous()
                dense = kernels.adc_scan_plain(luts, codes_t)
                check(torch.equal(kernels.adc_scan(luts, codes_t), dense),
                      f"adc_scan n={n} B={B} {m}x{k} differs")
                n_cases += 1
                if (m, k, dt) in JOIN_BOOKS:
                    continue
                mins, ids = kernels.adc_scan_binned(luts, codes_t)
                ref, ref_ids = kernels.adc_scan_binned_plain(luts, codes_t)
                check(torch.equal(mins, ref) and torch.equal(ids, ref_ids),
                      f"adc_scan_binned n={n} B={B} {m}x{k} differs")
                kernels.verify_binned(
                    mins, ids, ref, lambda i: torch.gather(dense, 1, i),
                    block_n=2048, bins=128, valid_n=n,
                    atol=TOL["adc_scan_binned"])
                n_cases += 1
            v = torch.nn.functional.normalize(
                torch.randn(n, D, generator=g, device="cuda"), dim=1)
            table, norms, valid = kernels.tile_table(v)
            q = kernels.pad_queries(v[:B], table.shape[1])
            mins, ids = kernels.fused_exact_scan(q, table, norms)
            ref, _ = kernels.fused_exact_scan_plain(q, table, norms)
            dense = norms[None] - 2.0 * (q.float() @ table.float().t())
            kernels.verify_binned(mins, ids, ref,
                                  lambda i: torch.gather(dense, 1, i),
                                  block_n=8192, bins=128, valid_n=valid,
                                  atol=TOL["fused_exact_scan"])
            n_cases += 1
    torch.cuda.synchronize()
    log(f"[3] boundary shapes: {n_cases} K1/K2/K4 kernel-vs-plain cases "
        f"agree")


def budget_boundary_checks(torch, kernels) -> None:
    """Phase 3a: K6/K7/K9/K10 against their plain versions at block_t ∈
    {128, 256, 1024}, B ∈ {1, 257}, five slots per query whose last one is
    the inf tile, pad rows inside a tile, and the three budget codebooks
    (12×256 uint8, 30×32 uint8, fused-pair 15×1024 int16)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    nt, P, n_cases = 6, 5, 0
    for block_t in (128, 256, 1024):
        na = (nt + 1) * block_t
        pad = slice(block_t + block_t // 2, 2 * block_t)
        rowterm = torch.randn(na, generator=g, device="cuda")
        rowterm[pad] = float("inf")
        rowterm[nt * block_t:] = float("inf")
        v = torch.nn.functional.normalize(
            torch.randn(na, D, generator=g, device="cuda"), dim=1)
        v[pad] = 0.0
        v[nt * block_t:] = 0.0
        vecs = torch.zeros(na, 304, dtype=torch.bfloat16, device="cuda")
        vecs[:, :D] = v.to(torch.bfloat16)
        rownorm = torch.sum(v * v, dim=1)
        rownorm[pad] = float("inf")
        rownorm[nt * block_t:] = float("inf")
        for B in (1, 257):
            tiles = torch.randint(0, nt + 1, (B, P), generator=g,
                                  device="cuda", dtype=torch.int32)
            tiles[:, -1] = nt
            what = f"block_t={block_t} B={B}"
            for m, k, dt in BUDGET_BOOKS:
                luts = torch.rand(B, m, k, generator=g, device="cuda") * 4
                codes_t = torch.randint(0, k, (m, na), generator=g,
                                        device="cuda").to(getattr(torch, dt))
                ref = kernels.budget_adc_plain(luts, codes_t, rowterm, tiles,
                                               block_t=block_t)
                budget_err(torch, kernels.budget_adc(
                    luts, codes_t, rowterm, tiles, block_t=block_t), ref,
                    "budget_adc", f"{what} {m}x{k}")
                budget_err(torch, kernels.budget_adc_grouped(
                    luts, codes_t, rowterm, tiles, block_t=block_t, rows=32),
                    ref, "budget_adc_grouped", f"{what} {m}x{k}")
                n_cases += 2
            q = v[torch.randint(0, nt * block_t, (B,), generator=g,
                                device="cuda")]
            ref = kernels.budget_exact_plain(q, vecs, rownorm, tiles,
                                             block_t=block_t)
            budget_err(torch, kernels.budget_exact(
                q, vecs, rownorm, tiles, block_t=block_t), ref,
                "budget_exact", what)
            budget_err(torch, kernels.budget_exact_grouped(
                q, vecs, rownorm, tiles, block_t=block_t, rows=32), ref,
                "budget_exact_grouped", what)
            n_cases += 2
    log(f"[3] boundary shapes: {n_cases} K6/K7/K9/K10 kernel-vs-plain "
        f"cases agree")


def int8_boundary_checks(torch, kernels) -> None:
    """Phase 3a: K3/K5/K8 against their plain versions. K3 and K5 at
    N ∈ {2047, 2048, 2049, 8191, 8193}, B ∈ {1, 33, 65, 257} and the
    codebooks of I8_BOOKS (K3 and K5 stage 64 queries a block at 12×256);
    K8 at block_t ∈ {128, 256, 1024}, B ∈ {1, 257}, the budget codebooks
    and 12×16, with the inf tile and pad rows as in the K6/K7 cases."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_cases = 0
    for n in (2047, 2048, 2049, 8191, 8193):
        for B in (1, 33, 65, 257):
            for m, k, dt in I8_BOOKS:
                luts = torch.rand(B, m, k, generator=g, device="cuda") * 4
                codes_t = torch.randint(0, k, (m, n), generator=g,
                                        device="cuda").to(getattr(torch, dt))
                q, sc = kernels.quantize_luts_int8(luts)
                what = f"n={n} B={B} {m}x{k}"
                dense = kernels.adc_scan_plain(q, codes_t, scale=sc)
                check(torch.equal(kernels.adc_scan_int8(q, sc, codes_t),
                                  dense), f"adc_scan_int8 {what} differs")
                mins, ids = kernels.adc_scan_binned_int8(q, sc, codes_t)
                ref, ref_ids = kernels.adc_scan_binned_plain(q, codes_t,
                                                             scale=sc)
                check(torch.equal(mins, ref) and torch.equal(ids, ref_ids),
                      f"adc_scan_binned_int8 {what} differs")
                kernels.verify_binned(
                    mins, ids, ref, lambda i: torch.gather(dense, 1, i),
                    block_n=2048, bins=128, valid_n=n, atol=0.0)
                n_cases += 2
    nt, P = 6, 5
    for block_t in (128, 256, 1024):
        na = (nt + 1) * block_t
        rowterm = torch.randn(na, generator=g, device="cuda")
        rowterm[block_t + block_t // 2:2 * block_t] = float("inf")
        rowterm[nt * block_t:] = float("inf")
        for B in (1, 257):
            tiles = torch.randint(0, nt + 1, (B, P), generator=g,
                                  device="cuda", dtype=torch.int32)
            tiles[:, -1] = nt
            for m, k, dt in BUDGET_BOOKS + ((12, 16, "uint8"),):
                luts = torch.rand(B, m, k, generator=g, device="cuda") * 4
                codes_t = torch.randint(0, k, (m, na), generator=g,
                                        device="cuda").to(getattr(torch, dt))
                q, sc = kernels.quantize_luts_int8(luts)
                budget_err(torch, kernels.budget_adc_grouped_int8(
                    q, sc, codes_t, rowterm, tiles, block_t=block_t,
                    rows=32), kernels.budget_adc_plain(
                    q, codes_t, rowterm, tiles, block_t=block_t, scale=sc),
                    "budget_adc_grouped_int8",
                    f"block_t={block_t} B={B} {m}x{k}")
                n_cases += 1
    torch.cuda.synchronize()
    log(f"[3] boundary shapes: {n_cases} K3/K5/K8 kernel-vs-plain cases "
        f"agree")


def same_top_k(torch, d1, i1, d2, i2, atol: float, what: str) -> None:
    """Two top-k results agree up to ties: distances within ``atol`` and
    every id strictly inside one side's top-k is in the other's."""
    check(bool(torch.allclose(d1, d2, atol=atol, rtol=0)),
          f"{what}: distances differ by more than {atol}")
    kth = torch.where(torch.isfinite(d2), d2, -float("inf")).amax(1,
                                                                  keepdim=True)
    for ds, ids, other in ((d1, i1, i2), (d2, i2, i1)):
        inside = ds < kth - atol
        hit = (ids[:, :, None] == other[:, None, :]).any(-1)
        check(bool((hit | ~inside).all()), f"{what}: a top-k id differs")


def profile_paths(torch, kernels, paths: dict, card: str, out: str,
                  calls: int = 3) -> None:
    """Phase 6: each path once to warm up, then ``calls`` calls under
    ``torch.profiler``. Device time is the sum of the CUDA kernels' self
    time; the busy share is device time over the host wall of the
    profiled calls (the profiler inflates host time, so the share is a
    lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    report = {"gpu": card, "calls": calls}
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        gpu = [e for e in prof.key_averages() if e.device_type == cuda
               and e.self_device_time_total > 0]
        check(gpu, f"profile {name}: no device time was recorded")
        device_ms = sum(e.self_device_time_total for e in gpu) / 1e3 / calls
        top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:8]
        ours = {}
        for k in kernels.KERNELS:
            pat = re.compile(rf"(?<![\w]){k}_kernel(?![\w])")
            hits = [e for e in gpu if pat.search(e.key)]
            if hits:
                n = sum(e.count for e in hits)
                ours[k] = {"launches_per_call": n / calls,
                           "ms_per_launch": sum(e.self_device_time_total
                                                for e in hits) / 1e3 / n}
        report[name] = {
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top": [[e.key[:60], e.self_device_time_total / 1e3 / calls,
                     e.count // calls] for e in top],
            "kernels": ours}
        log(f"[6] profile {name}: wall {wall_ms:.3f} ms, device "
            f"{device_ms:.3f} ms per call, busy "
            f"{device_ms / wall_ms:.3f}, kernels {ours} on {card}")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"[6] profile written to {out}")


def rows_to_ids(torch, store, rows, names, k: int):
    """The ``(query, word, sim)`` rows of the queries ``names`` → a
    (len(names), k) id matrix, −1 where a query has fewer than k rows."""
    per = {n: [] for n in names}
    for q, w, _ in rows:
        if q in per:
            per[q].append(store.get_id(w))
    return torch.tensor([(per[n] + [-1] * k)[:k] for n in names])


def insert_phase(torch, ExactIndex, eng, exact8, run_path,
                 path_launches: dict, card: str) -> dict:
    """Phase 12: ``insert_batch`` of INSERT_TERMS new terms "w{i} w{i+N/2}"
    (distinct, each the mean of two existing words) in batches of
    INSERT_BATCH, with the engine's LUT knob at int8. After each batch:
    the standalone int8 exact index ``exact8`` is extended with the batch's
    rows and held to a fresh int8 build on the grown table; every term of
    the batch is its own exact top-1; PQ-PV20 and IVFADC-PV20 find 256 of
    them among their own top 5 (the last batch crosses the IVFADC tail's
    capacity, so the splice runs on the card). Then the int8 kernels and
    K6 run once more on the grown tables."""
    eng.set_pq_lut_dtype("int8")
    eng.set_pvf(20)
    eng.set_w(3)
    terms = [f"w{i} w{i + N // 2}" for i in range(INSERT_TERMS)]
    out = {"batches": []}
    splices = 0
    for b0 in range(0, INSERT_TERMS, INSERT_BATCH):
        batch = terms[b0:b0 + INSERT_BATCH]
        tail_before = eng.ivfadc.tail_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_ins = eng.insert_batch(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(n_ins == len(batch), f"insert_batch took {n_ins} of "
              f"{len(batch)} new terms")
        spliced = eng.ivfadc.tail_count < tail_before + len(batch)
        splices += spliced
        ids = torch.tensor(eng.store.get_ids(batch), device="cuda")
        check(bool((ids == torch.arange(N + b0, N + b0 + len(batch),
                                        device="cuda")).all()),
              "inserted terms did not get the next row ids")
        rows = eng.store.vectors_norm[ids]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        exact8 = exact8.extended(eng.store.vectors_norm, rows)
        torch.cuda.synchronize()
        t_ext = time.perf_counter() - t1
        fresh = ExactIndex(eng.store.vectors_norm, "int8")
        qs = torch.cat([rows[:128], eng.store.vectors_norm[:128]])
        same_top_k(torch, *exact8.search(qs, K), *fresh.search(qs, K), 1e-5,
                   f"extended int8 exact after {b0 + len(batch)} inserts")
        del fresh
        top1 = torch.cat([eng.exact.search(rows[s:s + 512], 1)[1][:, 0]
                          for s in range(0, len(batch), 512)])
        check(bool((top1 == ids).all()),
              f"{int((top1 != ids).sum())} inserted terms are not their own "
              f"exact top-1")
        selfrec = {}
        for fam, key in (("k_nearest_neighbour_pq_pv", "pq_pv20_self@5"),
                         ("k_nearest_neighbour_ivfadc_pv",
                          "ivfadc_pv20_self@5")):
            eng.set_knn_function(fam)
            _, got = eng.knn_matrix(rows[:256], 5)
            selfrec[key] = float((got == ids[:256, None]).any(1).float()
                                 .mean())
            check(selfrec[key] >= INSERT_FLOORS[key],
                  f"{key} {selfrec[key]:.4f} < {INSERT_FLOORS[key]} after "
                  f"{b0 + len(batch)} inserts")
        row = {"terms": b0 + len(batch), "terms_per_s": n_ins / dt,
               "insert_s": dt, "extended_s": t_ext, "spliced": bool(spliced),
               "ivfadc_tail": eng.ivfadc.tail_count, **selfrec}
        out["batches"].append(row)
        log(f"[13] insert batch {b0 // INSERT_BATCH + 1}: {n_ins} terms in "
            f"{dt:.3f} s ({n_ins / dt:.0f} terms/s), int8 exact extended() "
            f"{t_ext * 1e3:.2f} ms, IVFADC tail {eng.ivfadc.tail_count}"
            f"{' (spliced)' if spliced else ''}, " + ", ".join(
                f"{k} {v:.4f}" for k, v in selfrec.items()) + f" on {card}")
    check(splices >= 1, "no insert batch spliced the IVFADC tail")
    new_ids = torch.arange(N, N + INSERT_TERMS, device="cuda")
    qnew = eng.store.vectors_norm[new_ids[:EVAL_Q]]

    def grown():
        eng.set_knn_function("k_nearest_neighbour_pq")
        eng.knn_matrix(qnew, K)
        eng.set_knn_function("k_nearest_neighbour_pq_pv")
        eng.knn_matrix(qnew, K)
        eng.set_knn_function("k_nearest_neighbour_ivfadc_pv")
        eng.knn_matrix(qnew, K)
        eng.set_statistics_table(None)
        eng.set_alpha(200)
        eng.set_method_flag(0)
        targets = torch.cat([torch.arange(JOIN_T, device="cuda"), new_ids])
        qs = terms[:JOIN_Q]
        rows = eng.knn_in_ivpq_batch(qs, JOIN_K, targets)
        check(len(rows) >= len(qs) * JOIN_K * 9 // 10, "join after insert")

    run_path("after_insert", grown)
    for name in ("adc_scan_int8", "adc_scan_binned_int8", "budget_adc",
                 "budget_adc_grouped_int8"):
        check(path_launches["after_insert"].get(name, 0) > 0,
              f"{name} did not launch on the grown tables")
    eng.set_pq_lut_dtype("bf16")
    return out


def engine_phase(torch, eng, store, words, qjoin, jwords, run_path,
                 path_launches: dict, card: str) -> dict:
    """Phase 7, slice 9: the rest of the engine on the full-width engine,
    each call a path of its own (launch counts set to 0 before it and read
    after it) and timed on the host clock with a synchronize: in-set kNN
    over the first JOIN_T rows (K2 bit-equal to its plain version on the
    gathered (m, JOIN_T) table), the ten analogy methods over ANALOGY_N
    seeded triples, both groupings, the three clusterings, tokenize,
    autotune and autotune_join, warmup, a pregathered handle over the
    whole store, the unprepared join's tile cache, and a FREDDY dump round
    trip of a MIGRATE_N-row engine. The engine's parameters and dispatch
    are restored afterwards."""
    import dataclasses
    import tempfile

    import numpy as np

    from postgres_word2vec_tpu_torch import Freddy, VectorStore
    from postgres_word2vec_tpu_torch.ops import kernels, lut
    from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32
    from postgres_word2vec_tpu_torch.utils import migrate

    saved_params = dataclasses.replace(eng.params)
    saved_dispatch = dict(eng.dispatch)
    dev = store.device
    vn = store.vectors_norm
    tids = torch.arange(JOIN_T, device=dev)
    out = {"ms": {}, "launches": {}}

    def call(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_path(f"s9_{name}", fn)
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        out["launches"][name] = path_launches[f"s9_{name}"]
        return res

    def launched(name, kernel, at_least=1):
        n = out["launches"][name].get(kernel, 0)
        check(n >= at_least, f"{name} launched {kernel} {n} times, not "
              f"at least {at_least}")

    def settings():
        eng.params = dataclasses.replace(saved_params)
        eng.dispatch = dict(saved_dispatch)
        eng.set_pq_lut_dtype("bf16")
        eng.set_statistics_table("t100k")
        eng.set_alpha(200)
        eng.set_method_flag(0)
        eng.set_pvf(20)
        eng.set_w(3)

    settings()

    # ---- in-set kNN over the first JOIN_T rows
    pq = eng.pq
    luts = lut.build_luts(pq._rotate(qjoin[:EVAL_Q]), pq.codebook.centroids)
    table = pq.transposed_codes().index_select(1, tids)
    got, want = kernels.adc_scan(luts, table), kernels.adc_scan_plain(
        luts, table)
    check(torch.equal(got, want), "K2 differs from its plain version on the "
          f"gathered (m, {JOIN_T}) target table")
    del luts, table, got, want
    res = call("knn_in_exact", lambda: eng.knn_in_exact("w7", K, tids))
    check(res[0][0] == "w7", f"knn_in_exact misses its own word: {res[:2]}")
    res = call("knn_in_pq", lambda: eng.knn_in_pq("w7", K, tids))
    check("w7" in [w for w, _ in res], f"knn_in_pq misses w7: {res}")
    launched("knn_in_pq", "adc_scan")
    rows = call("knn_in_pq_batch",
                lambda: eng.knn_in_pq_batch(jwords, JOIN_K, tids))
    launched("knn_in_pq_batch", "adc_scan", -(-JOIN_Q // 512))
    ids5 = rows_to_ids(torch, store, rows, jwords[:EVAL_Q], JOIN_K)
    gt5 = eng.exact.search_in(qjoin[:EVAL_Q], JOIN_K, tids)[1].cpu()
    rec = {"knn_in_pq_batch@5": recall_at(ids5, gt5, JOIN_K)}
    tmask = torch.ones(JOIN_T, dtype=torch.bool, device=dev)
    for impl in ("knn_in_exact", "knn_in_pq"):
        eng.set_knn_in_function(impl)
        d, i = call(f"knn_in_matrix_{impl}", lambda: eng.knn_in_matrix(
            qjoin[:EVAL_Q], K, tids, tmask))
        check(bool(torch.isfinite(d).all()) and i.shape == (EVAL_Q, K),
              f"knn_in_matrix ({impl}) results")
    launched("knn_in_matrix_knn_in_pq", "adc_scan")

    # ---- analogy: seeded triples, every method
    rng = np.random.default_rng(SEED)
    triples = [tuple(f"w{i}" for i in rng.choice(N, 3, replace=False))
               for _ in range(ANALOGY_N)]

    def direct(kind, t):
        """The float32 argmax of an exact method computed here."""
        with no_tf32():
            v = [vn[store.get_id(w)] for w in t]
            if kind == "3cosadd":
                sc = vn @ (v[2] - v[0] + v[1])
            elif kind == "3cosmul":
                c1, c2, c3 = (vn @ x for x in v)
                sc = ((c3 + 1) / 2) * ((c2 + 1) / 2) / ((c1 + 1) / 2 + 0.001)
            elif kind == "pair_direction":
                raw = store.vectors
                r = [raw[store.get_id(w)] for w in t]
                def unit(x):
                    return x / torch.clamp_min(torch.sqrt(torch.sum(
                        x * x, dim=-1, keepdim=True)), 1e-12)
                dq = unit(r[0] - r[1])
                sc = torch.cat([unit(r[2][None] - raw[s0:s0 + 262144]) @ dq
                                for s0 in range(0, N, 262144)])
            else:                                   # in-set 3CosAdd
                sc = torch.full((N,), -float("inf"), device=dev)
                sc[tids] = vn[tids] @ (v[2] - v[0] + v[1])
            sc[torch.tensor([store.get_id(w) for w in t], device=dev)] = \
                -float("inf")
            return store.words[int(torch.argmax(sc))]

    answers = {}
    for name in ("analogy_3cosadd", "analogy_3cosmul",
                 "analogy_pair_direction", "analogy_3cosadd_pq",
                 "analogy_3cosadd_ivfadc", "analogy_3cosadd_in",
                 "analogy_3cosadd_in_pq", "analogy_3cosadd_in_ivpq"):
        extra = (tids,) if "_in" in name else ()
        fn = getattr(eng, name)
        answers[name] = call(name, lambda fn=fn, extra=extra: [
            fn(*t, *extra) for t in triples])
    for kind in ("3cosadd", "3cosmul", "pair_direction"):
        want = [direct(kind, t) for t in triples]
        check(answers[f"analogy_{kind}"] == want,
              f"analogy_{kind} differs from the float32 argmax")
    want_in = [direct("in", t) for t in triples]
    check(answers["analogy_3cosadd_in"] == want_in,
          "analogy_3cosadd_in differs from the float32 argmax")
    for name, ref in (("analogy_3cosadd_pq", "analogy_3cosadd"),
                      ("analogy_3cosadd_ivfadc", "analogy_3cosadd"),
                      ("analogy_3cosadd_in_pq", "analogy_3cosadd_in"),
                      ("analogy_3cosadd_in_ivpq", "analogy_3cosadd_in")):
        rec[name] = float(np.mean([a == b for a, b in
                                   zip(answers[name], answers[ref])]))
    eng.set_analogy_function("analogy_3cosmul")
    eng.set_analogy_in_function("analogy_3cosadd_in_pq")
    a1 = call("analogy_facade", lambda: eng.analogy(*triples[0]))
    a2 = call("analogy_in_facade",
              lambda: eng.analogy_in(*triples[0], tids))
    check(a1 == answers["analogy_3cosmul"][0]
          and a2 == answers["analogy_3cosadd_in_pq"][0],
          "the analogy façades do not follow their dispatch")
    launched("analogy_3cosadd_pq", "adc_scan", ANALOGY_N)
    launched("analogy_3cosadd_in_pq", "adc_scan", ANALOGY_N)

    # ---- grouping
    toks = [f"w{i}" for i in rng.choice(N, GROUP_T, replace=False)]
    gwords = [f"w{i}" for i in rng.choice(N, GROUP_G, replace=False)]
    g_exact = call("grouping_func", lambda: eng.grouping_func(toks, gwords))
    g_pq = call("grouping_func_pq",
                lambda: eng.grouping_func_pq(toks, gwords))
    launched("grouping_func_pq", "adc_scan")
    check(len(g_exact) == len(g_pq) == GROUP_T
          and all(g in gwords for _, g in g_pq), "grouping results")
    rec["grouping_func_pq"] = float(np.mean([a == b for a, b in
                                             zip(g_exact, g_pq)]))

    # ---- clustering
    ctoks = [f"w{i}" for i in rng.choice(N, CLUSTER_T, replace=False)]
    cvec = store.vectors_for(ctoks)

    def mean_cos(assign):
        a = torch.as_tensor(assign, device=dev) - 1
        cen = torch.zeros(CLUSTER_K, D, device=dev).index_add_(0, a, cvec)
        cen = cen / cen.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return float((cvec * cen[a]).sum(1).mean())

    coh = {}
    for name in ("cluster_exact", "cluster_pq", "cluster_ivpq"):
        res = call(name, lambda name=name: getattr(eng, name)(ctoks,
                                                              CLUSTER_K))
        ids = [c for _, c in res]
        check(len(res) == CLUSTER_T and set(ids) <= set(range(1, CLUSTER_K
                                                              + 1)),
              f"{name}: a token without a cluster id in 1..{CLUSTER_K}")
        coh[name] = mean_cos(ids)
    coh["random"] = mean_cos(rng.integers(1, CLUSTER_K + 1, CLUSTER_T))
    check(coh["cluster_exact"] > coh["random"],
          f"exact clustering's mean cosine {coh['cluster_exact']:.4f} does "
          f"not beat a random assignment's {coh['random']:.4f}")
    launched("cluster_pq", "adc_scan", 10)
    out["cluster_mean_cos"] = coh

    # ---- tokenize
    pairs = rng.choice(N, (TOKENIZE_N, 2))
    texts = [f"w{a} w{b}" for a, b in pairs]
    tok = call("tokenize", lambda: [eng.tokenize(t) for t in texts])
    raw = call("tokenize_raw", lambda: [eng.tokenize_raw(t) for t in texts])
    pi = torch.as_tensor(pairs, device=dev)
    want = vn[pi].mean(1)
    want = (want / want.norm(dim=1, keepdim=True)).cpu().numpy()
    want_raw = store.vectors[pi].mean(1).cpu().numpy()
    out["tokenize_err"] = float(np.abs(np.stack(tok) - want).max())
    out["tokenize_raw_err"] = float(np.abs(np.stack(raw) - want_raw).max())
    check(out["tokenize_err"] <= 1e-6 and out["tokenize_raw_err"] <= 1e-6,
          f"tokenize differs from the direct mean: {out['tokenize_err']}, "
          f"{out['tokenize_raw_err']}")

    # ---- autotune, warmup
    def winner_ok(report):
        ch = [r for r in report if r.get("chosen")]
        ok = [r for r in report if r["meets_target"]]
        return len(ch) == 1 and (ch[0] is ok[0] if ok else ch[0]["recall"]
                                 == max(r["recall"] for r in report))

    rep = call("autotune", lambda: eng.autotune(sample=256))
    check(winner_ok(rep) and eng.dispatch["knn"] == next(
        r["name"] for r in rep if r.get("chosen")), "autotune's winner")
    rep_j = call("autotune_join",
                 lambda: eng.autotune_join(targets=tids, sample=256))
    check(winner_ok(rep_j), "autotune_join's winner")
    out["autotune"], out["autotune_join"] = rep, rep_j
    for name, r in (("autotune", rep), ("autotune_join", rep_j)):
        log(f"[7] {name} report (fastest first; seconds per 256 queries): "
            + "; ".join(f"{x['name']} {x['params']} recall "
                        f"{x['recall']:.4f} {x['seconds'] * 1e3:.2f} ms"
                        f"{' CHOSEN' if x.get('chosen') else ''}"
                        for x in r) + f" on {card}")
    settings()
    call("warmup", eng.warmup)

    # ---- pregathered handle over the whole store, in order
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ph = call("prepare_join_pregathered", lambda: eng.ivpq.prepare_join(
        torch.arange(N, device=dev), vectors=vn, vecs_pregathered=True))
    out["pregathered_peak_growth_bytes"] = \
        torch.cuda.max_memory_allocated() - before
    gathered = N * D * 4
    check(ph.vectors is vn and out["pregathered_peak_growth_bytes"]
          < gathered, f"the pregathered build grew memory by "
          f"{out['pregathered_peak_growth_bytes']} bytes, not less than a "
          f"gathered copy's {gathered}")
    kw = dict(alpha=600, method=2, pvf=20, statistics=None)
    d_p, i_p = call("join_pregathered_m2", lambda: eng.ivpq.search_join(
        qjoin[:EVAL_Q], JOIN_K, prepared=ph, **kw))
    d_a, i_a = eng.ivpq.search_join(qjoin[:EVAL_Q], JOIN_K,
                                    prepared=eng.prepared_targets["all"],
                                    **kw)
    check(torch.equal(i_p, i_a) and torch.allclose(d_p, d_a, atol=1e-6,
                                                   rtol=0),
          "the pregathered join differs from the store-table handle's")
    del ph

    # ---- the unprepared join's tile cache
    eng.ivpq._join_cache.clear()
    eng.tracker.clear_track()
    for n in (1, 2):
        call(f"join_unprepared_m0_call{n}",
             lambda: eng.knn_in_ivpq_batch(jwords, JOIN_K, tids))
        if n == 1:
            entry = next(iter(eng.ivpq._join_cache.values()))[0]
    dr = eng.tracker.get_results()["data_retrieval_time"]
    out["unprepared_data_retrieval_s"] = dr
    check(dr[0] > 0 and dr[1] == 0.0 and len(eng.ivpq._join_cache) == 1
          and next(iter(eng.ivpq._join_cache.values()))[0] is entry,
          f"the second unprepared join built its tiles again ({dr})")

    # ---- FREDDY dump round trip of a MIGRATE_N-row engine
    small = Freddy.build(
        VectorStore.from_arrays(words[:MIGRATE_N], store.vectors[:MIGRATE_N]),
        seed=SEED, preset="reference", k_coarse=128, ivpq_k_coarse=16,
        train_size=None, iters=8)
    with tempfile.TemporaryDirectory() as dump:
        call("export_engine", lambda: migrate.export_engine(small, dump))
        back = call("import_engine", lambda: migrate.import_engine(dump))
    check(back.store.device.type == "cuda" and back.pq.codes.is_cuda
          and back.ivpq.codes.is_cuda, "the imported engine is not on the "
          "card")
    for fam in ("k_nearest_neighbour", "k_nearest_neighbour_pq",
                "k_nearest_neighbour_ivfadc"):
        for e in (small, back):
            e.set_knn_function(fam)
        check(back.knn_batch_exact(words[:8], K) == small.knn_batch_exact(
            words[:8], K) and back.knn("w3", K) == small.knn("w3", K),
            f"the imported engine's {fam} differs from the exported one's")
    mt = list(range(0, MIGRATE_N, 3))
    check(back.knn_in_ivpq_batch(words[:16], JOIN_K, mt)
          == small.knn_in_ivpq_batch(words[:16], JOIN_K, mt),
          "the imported engine's join differs from the exported one's")
    serve_insert(back, run_path, card)
    del small, back

    eng.params = dataclasses.replace(saved_params)
    eng.dispatch = dict(saved_dispatch)
    out["recall"] = rec
    for name, t in out["ms"].items():
        log(f"[7] call {name}: {t:.2f} ms, launched "
            f"{out['launches'][name]} on {card}")
    log("[7] in-set recall and agreement with exact: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec.items()) + "; clustering mean cosine "
        + ", ".join(f"{k} {v:.4f}" for k, v in coh.items())
        + f"; pregathered build's peak growth "
        f"{out['pregathered_peak_growth_bytes'] / 1e9:.3f} GB (a gathered "
        f"copy {gathered / 1e9:.3f} GB)")
    for name, floor in ENGINE_FLOORS.items():
        check(rec[name] >= floor, f"{name} {rec[name]:.4f} < floor {floor}")
    return out


def same_ranked(got, want, tol: float) -> int:
    """How many rows of a served answer break agreement with the engine's
    own (both lists of ``[word, sim]`` or ``[query, word, sim]``): the
    similarities must agree within ``tol`` at every rank, and the rows be
    the same but where two tie within ``tol`` (a tied row may swap, or
    differ at its query's last rank)."""
    if len(got) != len(want):
        return max(len(got), len(want))
    bad = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if abs(g[-1] - w[-1]) > tol:
            bad += 1
            continue
        if list(g[:-1]) == list(w[:-1]):
            continue
        group = [j for j in range(len(want)) if want[j][:-2] == w[:-2]]
        tied = [list(want[j][:-1]) for j in group
                if abs(want[j][-1] - w[-1]) <= tol]
        if list(g[:-1]) not in tied and abs(w[-1] - want[group[-1]][-1]) \
                > tol:
            bad += 1
    return bad


def served(port: int, path: str, bodies: list, threads: int = 32) -> list:
    """Send ``bodies`` (JSON-able, or bytes already encoded) to ``path``
    from ``threads`` concurrent clients, so that they coalesce →
    [(status, decoded body)] in order."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def one(body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(one, bodies))


def serving_phase(torch, eng, fused, run_path, path_launches: dict,
                  card: str) -> dict:
    """Phase 8: serving on the card. The port's ``AsyncQueryServer``
    (standard-library HTTP, pipeline depth 2) on 127.0.0.1 over the
    full-width engine, its exact family on the fused bf16 index (K1), its
    loop on a thread of this process, warmed up first. The load driver's
    raw-socket client processes (SERVE_CLIENTS, spawned once; ``k`` = K)
    run a window each against /knn for the exact, PQ + PV20 and IVFADC + PV20
    families, /knn_in over the JOIN_T-row target set with the exact and
    the PQ core, and /knn_join with JOIN_BATCH-query requests against the
    prepared set (method 2, alpha 200); each window is a path (launch
    counts set to 0 before it, read after it), reports QPS, p50/p99,
    errors, the mean and max coalesced batch, the stage times and the card's
    busy share over one second (NVML samples), and fails on any error. Then
    SERVE_CHECK served answers a family are held to the engine's own
    batched call, every other endpoint is called once, a bad word
    coalesced with good ones fails alone, ``pipeline_depth`` 1 and 4 get
    an exact window each, the same fleet measures the echo floor, and the
    threaded ``QueryServer`` one exact window."""
    import dataclasses
    import os

    import numpy as np

    from postgres_word2vec_tpu_torch.evaluation import serving_bench as sb
    from postgres_word2vec_tpu_torch.server import QueryServer
    from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer

    saved_params = dataclasses.replace(eng.params)
    saved_dispatch = dict(eng.dispatch)
    saved_exact = eng.exact
    eng.exact = fused                 # exact /knn on K1
    eng.set_pq_lut_dtype("bf16")
    eng.set_pvf(20)
    eng.set_w(3)
    out = {"windows": {}, "checks": {}, "cpus": os.cpu_count(),
           "clients": SERVE_CLIENTS, "gpu": card}
    rng = np.random.default_rng(SEED)
    check_words = [f"w{i}" for i in rng.choice(N, SERVE_CHECK,
                                               replace=False)]
    tids = list(range(JOIN_T))
    tid_t = torch.arange(JOIN_T, device="cuda")
    tmask = torch.ones(JOIN_T, dtype=torch.bool, device="cuda")
    targets_extra = ', "targets": ' + json.dumps(tids)

    def window(srv, name, seconds=SERVE_S, batcher="knn", **kw):
        """One measured window against ``srv``, a path of its own."""
        stats = {"knn": srv._knn_batcher, "knn_in": srv._knn_in_batcher,
                 None: None}[batcher]
        before_stage = dict(srv.runner.stage_s)
        if stats is not None:
            before = (stats.batched_calls, stats.items_done)
            stats.max_coalesced = 0
        w = run_path(f"serve_{name}", lambda: fleet.window(
            srv.port, N, K, seconds, busy=True, **kw))
        w["launches"] = path_launches[f"serve_{name}"]
        w["stage_s"] = {k: v - before_stage[k]
                        for k, v in srv.runner.stage_s.items()}
        if stats is not None:
            calls = stats.batched_calls - before[0]
            w["batched_calls"] = calls
            w["mean_batch"] = (stats.items_done - before[1]) / max(calls, 1)
            w["max_batch"] = stats.max_coalesced
        out["windows"][name] = w
        lat = w["latency_ms"]
        log(f"[8] window {name}: {w['qps']:.1f} QPS, p50 {lat['p50']:.2f} "
            f"ms, p99 {lat['p99']:.2f} ms, errors {w['errors']}, batch "
            f"mean {w.get('mean_batch', 0):.2f} max {w.get('max_batch', 0)}"
            f", busy {w.get('busy_share', 0):.3f}, stage_s "
            + ", ".join(f"{k} {v:.3f}" for k, v in w["stage_s"].items())
            + f", launched {w['launches']} ({SERVE_CLIENTS} clients, "
            f"{os.cpu_count()} cpus) on {card}")
        check(w["errors"] == 0 and w["completed"] > 0,
              f"serving window {name}: {w['errors']} errors, "
              f"{w['completed']} completed, {w.get('error_kinds')}")
        return w

    def agree(name, got, want, tol):
        bad = sum(code != 200 or same_ranked(r["result"], wrows, tol)
                  for (code, r), wrows in zip(got, want))
        out["checks"][name] = {"answers": len(got), "disagree": bad,
                               "tol": tol}
        check(bad == 0, f"{name}: {bad} of {len(got)} served answers "
              f"differ from the engine's own (tol {tol})")

    def engine_rows(d, i):
        return [[list(r) for r in rows] for rows in eng._format_knn(d, i)]

    t0 = time.perf_counter()
    with sb.ClientFleet(SERVE_CLIENTS) as fleet:
        out["fleet_start_s"] = time.perf_counter() - t0
        srv = AsyncQueryServer(eng, port=0, pipeline_depth=2).start()
        try:
            srv.warmup(k=K)
            # ---- /knn windows, one per family, and their served answers
            qcheck = eng.store.vectors_for(check_words)
            # (the probe's shape picks K6 or K7 for IVFADC)
            for fam, kernel, tol in (
                    ("exact", ("fused_exact_scan",), 1e-5),
                    ("pq_pv", ("adc_scan_binned",), 1e-5),
                    ("ivfadc_pv", ("budget_adc", "budget_adc_grouped"),
                     1e-4)):
                sb.post(srv.port, "/config",
                        {"set_knn_function": sb.FAMILY_IMPL[fam]})
                w = window(srv, f"knn_{fam}", check="rows")
                check(any(w["launches"].get(n, 0) for n in kernel),
                      f"/knn {fam} launched none of {kernel}")
                got = served(srv.port, "/knn", [{"query": q, "k": K}
                                                for q in check_words])
                agree(f"knn_{fam}", got, engine_rows(*eng.knn_matrix(qcheck,
                                                                      K)), tol)
            # ---- /knn_in over the target set, exact and PQ cores
            for impl, kernel in (("knn_in_exact", None), ("knn_in_pq",
                                                          "adc_scan")):
                sb.post(srv.port, "/config", {"set_knn_in_function": impl})
                w = window(srv, impl, seconds=SERVE_S_SHORT, batcher="knn_in",
                           path="/knn_in", extra=targets_extra, check="rows")
                if kernel:
                    check(w["launches"].get(kernel, 0) > 0,
                          f"/knn_in {impl} did not launch {kernel}")
                got = served(srv.port, "/knn_in", [
                    ('{"query": "%s", "k": %d%s}' % (q, K, targets_extra))
                    .encode() for q in check_words])
                agree(impl, got, engine_rows(*eng.knn_in_matrix(
                    qcheck, K, tid_t, tmask)), 1e-5)
            # ---- /knn_join: JOIN_BATCH-query requests, method 2, alpha
            # 200, against a target set registered through the server
            ph = sb.post(srv.port, "/prepare_targets",
                         {"name": "served", "targets": tids})["result"]
            check(ph["prepared"] == "served" and ph["size"] == JOIN_T,
                  f"/prepare_targets: {ph}")
            sb.post(srv.port, "/config", {
                "set_knn_join_function": "knn_in_ivpq_batch",
                "set_method_flag": 2, "set_alpha": 200,
                "set_statistics_table": "t100k"})
            w = window(srv, "knn_join_m2_a200", batcher=None, path="/knn_join",
                       batch=JOIN_BATCH, extra=', "targets": "served"',
                       check="self")
            # the probe's shape picks K6 or K7 (budget_adc_auto)
            check(w["launches"].get("budget_adc", 0)
                  + w["launches"].get("budget_adc_grouped", 0) > 0,
                  "/knn_join launched neither budget_adc nor "
                  "budget_adc_grouped")
            groups = [check_words[s:s + JOIN_BATCH]
                      for s in range(0, SERVE_CHECK, JOIN_BATCH)]
            got = served(srv.port, "/knn_join",
                         [{"queries": g, "k": K, "targets": "served"}
                          for g in groups])
            agree("knn_join_m2_a200", got,
                  [[list(r) for r in eng.knn_join(g, K, "served")]
                   for g in groups], 1e-5)
            # ---- every other endpoint once; a bad word fails alone
            eng.dispatch = dict(saved_dispatch)
            t = check_words[:3]
            calls = {
                "/knn_batch": {"queries": check_words[:8], "k": K},
                "/analogy": {"w1": t[0], "w2": t[1], "w3": t[2]},
                "/analogy_in": {"w1": t[0], "w2": t[1], "w3": t[2],
                                "targets": tids[:1000]},
                "/groups": {"tokens": check_words,
                            "group_tokens": [f"w{i}" for i in range(10)]},
                "/cluster": {"tokens": check_words, "k": 8},
                "/tokenize": {"text": " ".join(t)},
                "/statistics": {"name": "served", "domain": check_words},
                "/config": {"set_pvf": 20},
            }
            for path, body in calls.items():
                code, r = served(srv.port, path, [body], threads=1)[0]
                check(code == 200 and r["result"] is not None,
                      f"{path}: {code} {str(r)[:200]}")
            code, raw = served(srv.port, "/tokenize",
                               [{"text": " ".join(t), "raw": True}], 1)[0]
            want_raw = eng.store.vectors[torch.tensor(
                eng.store.get_ids(t), device="cuda")].mean(0).cpu().numpy()
            check(code == 200 and np.abs(np.asarray(raw["result"])
                                         - want_raw).max() <= 1e-5,
                  "/tokenize raw differs from the direct mean")
            eng.set_statistics_table("t100k")
            health = sb.get(srv.port, "/health")
            check(health["status"] == "ok" and health["vocab"] == N
                  and "cuda" in health["device"], f"/health: {health}")
            code, r = served(srv.port, "/nope", [{}], 1)[0]
            check(code == 404, f"an unknown path answered {code}")
            mixed = [{"query": "no_such_word" if j == 3 else w, "k": K}
                     for j, w in enumerate(check_words[:16])]
            got = served(srv.port, "/knn", mixed, threads=16)
            check([c for c, _ in got] == [400 if j == 3 else 200
                                          for j in range(16)],
                  "a bad word coalesced with good ones: "
                  f"{[c for c, _ in got]}")
            out["health"] = health
        finally:
            srv.stop()
        # ---- pipeline depth 1 and 4 (depth 2 is the exact window above)
        eng.set_knn_function("k_nearest_neighbour")
        out["depth_sweep"] = {2: out["windows"]["knn_exact"]["qps"]}
        for depth in (1, 4):
            srv = AsyncQueryServer(eng, port=0, pipeline_depth=depth).start()
            try:
                srv.warmup(k=K)
                out["depth_sweep"][depth] = window(
                    srv, f"knn_exact_depth{depth}", seconds=SERVE_S_SHORT,
                    check="rows")["qps"]
            finally:
                srv.stop()
        log("[8] pipeline depth sweep (exact /knn QPS): " + ", ".join(
            f"depth {d} {q:.1f}"
            for d, q in sorted(out["depth_sweep"].items()))
            + f" on {card}")
        # ---- the echo floor: the same fleet, no engine
        w = sb.run_echo_floor(fleet, SERVE_S_SHORT, K)
        out["echo_floor"] = w
        check(w["errors"] == 0, f"echo floor: {w['errors']} errors")
        log(f"[8] echo floor (no engine, same {SERVE_CLIENTS} clients): "
            f"{w['qps']:.1f} QPS, p50 {w['latency_ms']['p50']:.2f} ms, p99 "
            f"{w['latency_ms']['p99']:.2f} ms ({os.cpu_count()} cpus)")
        # ---- the threaded front end, one exact window
        srv = QueryServer(eng, port=0).start()
        try:
            srv.warmup(k=K)
            window(srv, "knn_exact_threaded", seconds=SERVE_S_SHORT,
                   check="rows")
        finally:
            srv.stop()
    left = sb.child_processes()
    check(not left, f"processes left after the client fleet: {left}")
    log("[8] the client fleet and the resource tracker stopped: no child "
        "process left")
    eng.exact = saved_exact
    eng.params = dataclasses.replace(saved_params)
    eng.dispatch = dict(saved_dispatch)
    return out


def serve_insert(back, run_path, card: str) -> None:
    """/insert through the port's async server on the migrated small
    engine of phase 7: the new term is then its own /knn top-1."""
    from postgres_word2vec_tpu_torch.evaluation import serving_bench as sb
    from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer

    srv = AsyncQueryServer(back, port=0).start()
    try:
        def go():
            n = sb.post(srv.port, "/insert", {"terms": ["w1 w2", "w5"]})
            top = sb.post(srv.port, "/knn", {"query": "w1 w2", "k": 1})
            return n, top

        n, top = run_path("s9_serve_insert", go)
        check(n["result"] == {"inserted": 1}
              and top["result"][0][0] == "w1 w2",
              f"/insert then /knn: {n}, {top}")
        log(f"[7] /insert through the async server: {n['result']}, the new "
            f"term's /knn top-1 {top['result'][0]} on {card}")
    finally:
        srv.stop()


def builders_phase(torch, store, card: str) -> dict:
    """Phase 9: the streaming builders over the whole table. A PQ (12×256)
    and an IVFADC (1000 cells, 12×256 residuals) builder train on
    BUILD["train_size"] sampled rows, then stream all N rows in
    BUILDER_BATCH-row batches; halfway each writes a checkpoint and the
    stream goes on in the builder resumed from it. The finished codes (and
    IVFADC's cells) must be bit-equal to one encode of the whole table with
    the same codebook; rows/s times the encode calls only."""
    import tempfile

    from postgres_word2vec_tpu_torch.models import builders
    from postgres_word2vec_tpu_torch.ops import kmeans

    vn = store.vectors_norm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    train = vn[torch.randperm(N, generator=gen, device="cuda")[
        :BUILD["train_size"]]]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("pq", "ivfadc"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "pq":
                creator = builders.PQIndexCreator.from_training(
                    gen, train, m=12, k=256, iters=10)
            else:
                creator = builders.IVFADCIndexCreator.from_training(
                    gen, train, m=12, k=256, k_coarse=1000, iters=10)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            feeder = builders.VectorFeeder(vn, batch_size=BUILDER_BATCH)
            n_batches = -(-N // BUILDER_BATCH)
            encode_s = 0.0
            for b, (batch, _) in enumerate(feeder):
                if b == n_batches // 2:
                    t1 = time.perf_counter()
                    creator.checkpoint(f"{tmp}/{name}.npz")
                    creator = type(creator).resume(f"{tmp}/{name}.npz",
                                                   device=vn.device)
                    ckpt_s = time.perf_counter() - t1
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                creator.index_batch(batch)
                torch.cuda.synchronize()
                encode_s += time.perf_counter() - t1
            check(creator.rows_done == N,
                  f"{name} builder streamed {creator.rows_done} rows")
            codes = torch.cat(creator._codes)
            if name == "pq":
                whole = kmeans.encode_subspaces(vn, creator.codebook.centroids)
                same = torch.equal(codes, whole)
            else:
                cells = kmeans.assign(vn, creator.coarse_centroids)
                whole = kmeans.encode_residual_subspaces(
                    vn, creator.coarse_centroids, cells,
                    creator.codebook.centroids)
                same = (torch.equal(codes, whole) and torch.equal(
                    torch.cat(creator._assign).long(), cells))
            check(same, f"the streamed {name} codes differ from one encode "
                  f"of the whole table")
            idx = creator.finalize()
            check(idx.size == N, f"the finalized {name} index")
            out[name] = {"rows_per_s": N / encode_s, "encode_s": encode_s,
                         "train_s": train_s, "checkpoint_resume_s": ckpt_s}
            log(f"[9] {name} builder: trained in {train_s:.2f} s, {N} rows "
                f"streamed in {n_batches} batches of {BUILDER_BATCH} at "
                f"{N / encode_s:,.0f} rows/s, checkpoint + resume at batch "
                f"{n_batches // 2} in {ckpt_s:.2f} s, codes bit-equal to "
                f"one encode of the table on {card}")
    return out


def aniso_phase(torch, store, q256, gt256, card: str) -> dict:
    """Phase 10: anisotropic refinement at the smoke engine's PQ shape
    (OPQ 12×256, BUILD's training): ``PQIndex.build`` with
    ``aniso_eta=ANISO_ETA`` beside the same build without it, each one's
    build time and recall@10 against the float32 exact scan (PQ and PQ +
    PV20) on EVAL_Q queries."""
    from postgres_word2vec_tpu_torch.models.pq import PQIndex

    out = {}
    for name, eta in (("plain", None), ("aniso", ANISO_ETA)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pq = PQIndex.build(gen, store.vectors_norm, m=12, k=256,
                           opq_iters=10, aniso_eta=eta, **BUILD)
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t0,
               "pq@10": recall_at(pq.search(q256, K)[1], gt256, K),
               "pq_pv20@10": recall_at(pq.search_pv(
                   q256, K, 20, store.vectors_norm)[1], gt256, K)}
        out[name] = row
        log(f"[10] PQ 12x256 OPQ {name}{'' if eta is None else f' eta {eta}'}"
            f": built in {row['build_s']:.2f} s, recall@10 PQ "
            f"{row['pq@10']:.4f}, PQ + PV20 {row['pq_pv20@10']:.4f} on "
            f"{card}")
        del pq
    for key, floor in ANISO_FLOORS.items():
        check(out["aniso"][key] >= floor,
              f"aniso {key} {out['aniso'][key]:.4f} < floor {floor}")
    return out


def harness_phase(torch, eng, words, card: str) -> dict:
    """Phase 11: the evaluation harness on the full-width engine:
    ``time_precision_sweep`` over methods 0, 1, 2 at alphas 50 and 200 and
    pvf 1, 5 and 20 (method 2) on EVAL_Q queries against the prepared
    JOIN_T-row set, ``confidence_eval`` and ``target_count_eval`` on 64
    queries, and an HTML report written with the port's ``html_report``."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from postgres_word2vec_tpu_torch.evaluation import harness, html_report

    saved = dataclasses.replace(eng.params)
    eng.set_statistics_table("t100k")
    queries = words[N - EVAL_Q:]
    tids = torch.arange(JOIN_T, device="cuda")
    t0 = time.perf_counter()
    recs = harness.time_precision_sweep(eng, queries, JOIN_K, "t100k",
                                        alphas=(50, 200), pvfs=(1, 5, 20))
    conf = harness.confidence_eval(eng, queries[:64], JOIN_K, tids,
                                   confidences=(0.2, 0.8))
    tc = harness.target_count_eval(eng, queries[:64], JOIN_K, tids)
    with tempfile.TemporaryDirectory() as tmp:
        page = html_report.write_html_report(
            Path(tmp) / "report.html",
            [html_report.figure_from_records(recs)],
            title="IVPQ join time / precision", subtitle=card)
        size = page.stat().st_size
    took = time.perf_counter() - t0
    eng.params = saved
    check(len(recs) == 10 and all(0 <= r["precision"] <= 1 for r in recs),
          f"time_precision_sweep records: {recs}")
    m1 = [r["precision"] for r in recs if r["method"] == 1
          and r["alpha"] == 200][0]
    check(m1 >= FLOORS["join_m1_a200@5"], f"harness method 1 alpha 200 "
          f"precision {m1:.4f} < {FLOORS['join_m1_a200@5']}")
    check(size > 10_000, f"the HTML report has {size} bytes")
    for r in recs:
        log(f"[11] sweep method {r['method']} alpha {r['alpha']} pvf "
            f"{r['pvf']}: precision {r['precision']:.4f}, "
            f"{r['per_query_ms']:.4f} ms/query on {card}")
    log(f"[11] confidence_eval {conf}; target_count_eval mean abs rel "
        f"divergence {tc['mean_abs_rel_divergence']:.4f}; HTML report "
        f"{size} bytes; harness phase {took:.1f} s")
    return {"sweep": recs, "confidence": conf,
            "target_count_divergence": tc["mean_abs_rel_divergence"],
            "report_bytes": size, "seconds": took}


def sharding_phase(torch, eng, store, q256, qjoin, jwords, ph100k, errs,
                   run_path, path_launches, card) -> dict:
    """Phase 12: row sharding (slice 11) on R shards of the one card. A
    second engine over the same store and indexes, sharded over each mesh
    of SHARD_MESHES; every sharded family is held to the unsharded engine
    on the same card, the kernels of the sharded paths to their plain
    versions at the shard shapes, and each family timed beside its
    unsharded twin. R shards of one card measure the shard-and-merge
    overhead, not multi-GPU scaling."""
    import dataclasses
    from postgres_word2vec_tpu_torch import Freddy
    from postgres_word2vec_tpu_torch.models import ivfadc as ivfadc_mod
    from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
    from postgres_word2vec_tpu_torch.ops import kernels, kmeans, lut
    from postgres_word2vec_tpu_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    saved = (dataclasses.replace(eng.params), dict(eng.dispatch))
    ivf, ivpq = eng.ivfadc, eng.ivpq
    stats = eng.statistics["t100k"]
    tids = ph100k.target_ids
    tmask = torch.ones(tids.shape, dtype=torch.bool, device=dev)
    jq, jw = qjoin[:EVAL_Q], jwords[:EVAL_Q]
    cc, cb = ivpq.coarse.centroids, ivpq.codebook.centroids
    sizes = (ivf.cell_offsets[1:] - ivf.cell_offsets[:-1]).long()
    _, near = torch.topk(kmeans.pairwise_sqdist(q256, ivf.coarse.centroids),
                         4, largest=False)
    cum = sizes[near].cumsum(1)
    # each query's last probe width under escalation (w 1, 2, 4): the first
    # whose nearest cells hold SHARD_ESCALATE_K rows
    w_final = torch.where(cum[:, 0] >= SHARD_ESCALATE_K, 1, torch.where(
        cum[:, 1] >= SHARD_ESCALATE_K, 2, 4))
    out = {}
    for rows, qx in SHARD_MESHES:
        tag = f"{rows}x{qx}"
        cells = rows * qx
        mesh = sharding.make_mesh([dev] * cells, rows=rows, q=qx)
        eng_s = Freddy(store, pq=eng.pq, ivfadc=ivf, ivpq=ivpq,
                       params=dataclasses.replace(eng.params))
        eng_s.statistics = eng.statistics
        eng_s.prepared_targets = eng.prepared_targets
        torch.cuda.synchronize()
        mem0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        eng_s.enable_sharding(mesh)
        torch.cuda.synchronize()
        bundle = eng_s._shard["ivf_bundle"]
        cap, m = bundle["list_cap"], ivf.codebook.centroids.shape[0]
        log(f"[12] mesh {tag} on {dev}: enable_sharding "
            f"{time.perf_counter() - t0:.2f} s, "
            f"+{(torch.cuda.memory_allocated() - mem0) / 2**30:.2f} GiB; "
            f"IVFADC list_cap {cap}: the row-1 probe's gathered codes at "
            f"B={EVAL_Q} w=3 are {EVAL_Q * 3 * cap * m:,} (w=4 at k="
            f"{SHARD_ESCALATE_K}: {EVAL_Q * 4 * cap * m:,}), in query chunks "
            f"of at most 2**26")
        for e in (eng, eng_s):
            e.set_w(3)
            e.set_pvf(20)
            e.set_alpha(200)
            e.set_confidence_value(0.8)
            e.set_statistics_table("t100k")
        eng.set_pv_shortlist("exact")       # the sharded PV's shortlist
        times, launched = {}, {}

        def compare(name, sharded, plain, atol, kernel=None):
            path = f"shard{tag}_{name}"
            d_s, i_s = run_path(path, sharded)
            launched[name] = path_launches[path]
            if kernel is not None:
                check(path_launches[path].get(kernel, 0) == cells,
                      f"{path} launched {path_launches[path]}, not "
                      f"{kernel} once per mesh cell ({cells})")
            d_u, i_u = plain()
            same_top_k(torch, d_s, i_s, d_u, i_u, atol, f"mesh {tag} {name}")
            times[name] = {
                "ms_per_query": p50(cuda_ms(torch, sharded, reps=5)) / EVAL_Q,
                "unsharded_ms_per_query": p50(cuda_ms(torch, plain,
                                                      reps=5)) / EVAL_Q}

        for name, family, lut_dtype, atol, kernel in (
                ("exact", "k_nearest_neighbour", "bf16", 1e-5, None),
                ("pq", "k_nearest_neighbour_pq", "bf16", 1e-5, "adc_scan"),
                ("pq_int8", "k_nearest_neighbour_pq", "int8", 1e-5,
                 "adc_scan_int8"),
                ("pq_pv20", "k_nearest_neighbour_pq_pv", "bf16", 1e-5,
                 "adc_scan"),
                ("ivfadc", "k_nearest_neighbour_ivfadc", "bf16", 1e-4, None),
                ("ivfadc_pv20", "k_nearest_neighbour_ivfadc_pv", "bf16",
                 1e-5, None)):
            for e in (eng, eng_s):
                e.set_knn_function(family)
                e.set_pq_lut_dtype(lut_dtype)
            compare(name, lambda: eng_s.knn_matrix(q256, K),
                    lambda: eng.knn_matrix(q256, K), atol, kernel)
        for e in (eng, eng_s):
            e.set_pq_lut_dtype("bf16")
        for name, impl, kernel in (("in_exact", "knn_in_exact", None),
                                   ("in_pq", "knn_in_pq", "adc_scan")):
            for e in (eng, eng_s):
                e.set_knn_in_function(impl)
            compare(name, lambda: eng_s.knn_in_matrix(q256, K, tids, tmask),
                    lambda: eng.knn_in_matrix(q256, K, tids, tmask), 1e-5,
                    kernel)

        # IVFADC's escalation: at k = SHARD_ESCALATE_K from w = 1 some
        # queries widen; each is held to the tiled probe at its last width
        d_e, i_e = run_path(f"shard{tag}_ivfadc_escalate",
                            lambda: sharding.sharded_ivfadc_adaptive(
                                mesh, q256, bundle, k=SHARD_ESCALATE_K, w=1))
        for w in (1, 2, 4):
            sel = torch.nonzero(w_final == w).flatten()
            if sel.numel():
                d_u, i_u = ivf.search(q256[sel], SHARD_ESCALATE_K, w=w)
                same_top_k(torch, d_e[sel], i_e[sel], d_u, i_u, 1e-4,
                           f"mesh {tag} IVFADC escalated to w={w}")
        escalated = int((w_final > 1).sum())
        check(escalated > 0, f"mesh {tag}: no query escalated at k="
              f"{SHARD_ESCALATE_K}")

        # the join at 100k prepared targets, alpha 200, t100k statistics
        join = {}
        for method in (0, 1, 2):
            eng_s.set_method_flag(method)
            path = f"shard{tag}_join_m{method}"
            rows_ = run_path(path, lambda: eng_s.knn_in_ivpq_batch(
                jw, JOIN_K, "t100k"))
            if method != 1:
                check(path_launches[path].get("adc_scan", 0) > 0,
                      f"{path} did not launch adc_scan")
            launched[f"join_m{method}"] = path_launches[path]
            kw = dict(statistics=stats, alpha=200, pvf=20, method=method,
                      confidence=0.8)
            d_s, i_s = sharding.sharded_ivpq_join(
                mesh, ivpq, jq, JOIN_K, tids, vectors=store.vectors_norm,
                **kw)
            check(torch.equal(rows_to_ids(torch, store, rows_, jw, JOIN_K),
                              i_s.cpu()),
                  f"{path}: the engine's rows differ from the sharded join")
            d_u, i_u = ivpq.search_join(jq, JOIN_K, prepared=ph100k,
                                        impl="dense", **kw)
            if method == 2:
                # per-shard shortlists: at least as good, and exact
                check(bool((d_s <= d_u + 1e-5).all()),
                      f"{path}: worse than the unsharded join")
                true = ((jq[:, None, :] - store.vectors_norm[
                    i_s.clamp_min(0)]) ** 2).sum(-1)
                check(bool(torch.allclose(d_s[i_s >= 0], true[i_s >= 0],
                                          atol=1e-4)),
                      f"{path}: a distance is not the row's exact one")
            else:
                same_top_k(torch, d_s, i_s, d_u, i_u, 1e-5,
                           f"mesh {tag} join method {method}")
            # budget round against dense round, round 1
            vecs = store.vectors_norm[tids] if method else None
            tiles = sharding.shard_join_tiles(ivpq, tids, tmask, vecs, mesh,
                                              with_vecs=method == 1)
            targets = sharding.shard_join_targets(ivpq, tids, tmask, vecs,
                                                  mesh)
            path = f"shard{tag}_join_budget_m{method}"
            d_b, i_b, found = run_path(
                path, lambda: sharding.sharded_ivpq_join_round_budget(
                    mesh, jq, cc, cb, tiles, stats, k=JOIN_K, alpha=200,
                    pvf=20, method=method, confidence=0.8))
            launched[f"join_budget_m{method}"] = path_launches[path]
            d_d, i_d, retrieved = sharding.sharded_ivpq_join_round(
                mesh, jq, cc, cb, statistics=stats, k=JOIN_K, alpha=200,
                pvf=20, method=method, confidence=0.8, **targets)
            full = found >= retrieved
            check(bool(full.all()), f"mesh {tag} method {method}: the "
                  f"budget round cut {int((~full).sum())} queries' cells "
                  f"short")
            tol = 1e-2 if method == 1 else 1e-5     # K9/K10 read bf16 rows
            if full.any():
                same_top_k(torch, d_b[full], i_b[full], d_d[full], i_d[full],
                           tol, f"mesh {tag} budget vs dense, method "
                           f"{method}")
            if method != 2 and (~full).any():
                check(bool((d_b[~full] >= d_d[~full] - tol).all()),
                      f"mesh {tag} method {method}: a budget round cut "
                      f"short beat the dense round")
            big = qjoin[:1024]
            path = f"shard{tag}_join_budget_full_m{method}"
            run_path(path, lambda: sharding.sharded_ivpq_join(
                mesh, ivpq, big, JOIN_K, tids, vectors=store.vectors_norm,
                impl="budget", **kw))
            launched[f"join_budget_full_m{method}"] = path_launches[path]
            # shard 0's plan, fitted to its largest selection as the
            # budget round fits it, for the budget kernels at its tiles
            jt = tiles["jt"][0][dev]
            start, cnt, *_ = ivpq_mod.select_tiles(
                jq, cc, stats, jt, JOIN_K, 200, 0.8, tiles["t_real"],
                tiles["cell_counts"])
            p0 = ivpq_mod.fit_budget([cnt], max(tiles["n_tiles"] - 1, 1))
            plan, _ = ivfadc_mod.plan_probe_tiles(p0, start, cnt, jt.inf_tile)
            join[f"m{method}"] = {
                "full_coverage_share": float(full.float().mean()),
                "p_budget": p0,
                "ms_per_query_dense": p50(cuda_ms(torch, lambda: eng_s
                                                  .knn_in_ivpq_batch(
                                                      jw, JOIN_K, "t100k"),
                                                  reps=3)) / EVAL_Q,
                "unsharded_ms_per_query_dense": p50(cuda_ms(
                    torch, lambda: ivpq.search_join(
                        jq, JOIN_K, prepared=ph100k, impl="dense", **kw),
                    reps=3)) / EVAL_Q}
            # the budget kernels at shard 0's tiles, block_t 128
            what = (f"mesh {tag} shard 0 join B={EVAL_Q} "
                    f"P={plan.shape[1]} block_t={jt.block_t}")
            if method == 0:
                luts = lut.build_luts(jq, cb)
                want = kernels.budget_adc_plain(luts, jt.codes_t, jt.rowterm,
                                                plan, block_t=jt.block_t)
                for name, got in (
                        ("budget_adc", kernels.budget_adc(
                            luts, jt.codes_t, jt.rowterm, plan,
                            block_t=jt.block_t)),
                        ("budget_adc_grouped", kernels.budget_adc_grouped(
                            luts, jt.codes_t, jt.rowterm, plan,
                            block_t=jt.block_t, rows=32))):
                    err = budget_err(torch, got, want, name, what)
                    check(err == 0.0, f"{name} {what}: err {err}, not equal")
                    errs[name] = max(errs[name], err)
            elif method == 1:
                want = kernels.budget_exact_plain(jq, jt.vecs, jt.rownorm,
                                                  plan, block_t=jt.block_t)
                for name, got in (
                        ("budget_exact", kernels.budget_exact(
                            jq, jt.vecs, jt.rownorm, plan,
                            block_t=jt.block_t)),
                        ("budget_exact_grouped",
                         kernels.budget_exact_grouped(
                             jq, jt.vecs, jt.rownorm, plan,
                             block_t=jt.block_t, rows=32))):
                    errs[name] = max(errs[name], budget_err(
                        torch, got, want, name, what))
            del tiles, targets
        # K2 and K3 at a shard's codes
        luts = eng_s._mesh_luts(eng.pq, q256)
        codes_t = eng_s._shard["pq_codes"].local(rows - 1)
        ql, sc = kernels.quantize_luts_int8(luts)
        for name, got, want in (
                ("adc_scan", kernels.adc_scan(luts, codes_t),
                 kernels.adc_scan_plain(luts, codes_t)),
                ("adc_scan_int8", kernels.adc_scan_int8(ql, sc, codes_t),
                 kernels.adc_scan_plain(ql, codes_t, scale=sc))):
            check(torch.equal(got, want), f"{name} at mesh {tag}'s shard "
                  f"{tuple(codes_t.shape)} differs from the plain version")
            errs[name] = max(errs[name], float((got - want).abs().max()))
        del got, want, luts, ql, sc
        kinds = {}
        for counts in launched.values():
            for name, v in counts.items():
                kinds[name] = kinds.get(name, 0) + v
        for pair in (("budget_adc", "budget_adc_grouped"),
                     ("budget_exact", "budget_exact_grouped")):
            check(any(kinds.get(n, 0) for n in pair),
                  f"mesh {tag}: the sharded budget join launched neither "
                  f"of {pair}: {kinds}")
        log(f"[12] R shards on one H100: shard-and-merge overhead, not "
            f"multi-GPU scaling (mesh {tag}, {card}): " + ", ".join(
                f"{n} {t['ms_per_query']:.5f} vs unsharded "
                f"{t['unsharded_ms_per_query']:.5f} ms/query"
                for n, t in times.items()) + "; join " + ", ".join(
                f"{n} dense {j['ms_per_query_dense']:.5f} vs unsharded "
                f"{j['unsharded_ms_per_query_dense']:.5f} ms/query, budget "
                f"P={j['p_budget']} full coverage "
                f"{j['full_coverage_share']:.3f}"
                for n, j in join.items()))
        log(f"[12] mesh {tag}: launches per sharded call {launched}; "
            f"{escalated} of {EVAL_Q} queries escalated at k="
            f"{SHARD_ESCALATE_K}")
        out[tag] = {"times": times, "join": join, "launches": launched,
                    "escalated": escalated}
        del eng_s, bundle
        torch.cuda.empty_cache()
    eng.params, eng.dispatch = saved
    return out


# --------------------------------------------------- 14: the CLI drivers
def write_word2vec_bin(path, words, vecs) -> None:
    """A word2vec ``.bin``: a ``N d`` header, then each word, a space, its
    float32 row and a newline."""
    import numpy as np

    rows = np.ascontiguousarray(vecs, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(f"{len(words)} {rows.shape[1]}\n".encode())
        f.write(b"".join(w.encode() + b" " + r.tobytes() + b"\n"
                         for w, r in zip(words, rows)))


def npz_arrays(path) -> dict:
    import numpy as np

    with np.load(path, allow_pickle=False) as f:
        return {name: f[name] for name in f.files}


def reports_digest() -> dict:
    """Every file under ``reports/`` → the SHA-256 of its bytes."""
    import hashlib
    from pathlib import Path

    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(REPO, "reports").rglob("*")) if p.is_file()}


@contextlib.contextmanager
def launches_by_join_call(kernels, Freddy, into: dict):
    """Count the kernels each IVPQ join call (by its method) and each PQ
    in-set batch launches, summed into ``into``: the drivers build their
    engines themselves, so the engine's class methods are wrapped."""
    names = ("knn_in_ivpq_batch", "knn_in_pq_batch")
    orig = {n: getattr(Freddy, n) for n in names}

    def wrap(name, fn):
        def call(self, *args, **kw):
            before = kernels.launch_counts()
            try:
                return fn(self, *args, **kw)
            finally:
                label = (f"m{self.params.method}" if name == names[0]
                         else "pq_in_batch")
                acc = into.setdefault(label, {})
                for k, v in kernels.launch_counts().items():
                    if v > before[k]:
                        acc[k] = acc.get(k, 0) + v - before[k]
        return call

    for n, fn in orig.items():
        setattr(Freddy, n, wrap(n, fn))
    try:
        yield into
    finally:
        for n, fn in orig.items():
            setattr(Freddy, n, fn)


def drivers_phase(torch, head_words, head_vecs, path_launches: dict,
                  card: str) -> dict:
    """Phase 14: the command-line drivers (``postgres_word2vec_tpu_torch
    .cli``) on the card, every file they write in a temporary directory.

    1. the offline chain as ``python -m`` subprocesses with no
       ``--device`` (so on the card), in the temporary directory: the
       first OFFLINE_N rows of the phase-4 store as a word2vec ``.bin``
       → ``vec2database`` → ``pq_index``, ``ivfadc`` and ``ivpq`` on the
       shipped configs (IVPQ with a STATS_WORDS-word statistics domain)
       → ``load_index`` of each, self-match@1 at least SELF_MATCH_FLOOR;
       ``transform_vecs`` of a MIGRATE_N-row ``.bin`` read back equal to
       its rows; ``import_freddy export`` then ``import`` of a saved
       MIGRATE_N-row engine, its codes and codebooks bit-equal;
    2. the evaluation drivers in-process on their shipped 3M configs
       (copies that write into the temporary directory):
       ``time_precision_eval`` (the README's figure), with the launches
       of each join method and the PQ baseline, ``step_wise``,
       ``confidence_eval``, ``target_counts`` and ``flexible_pq_eval``;
    3. ``time_measurement`` in its six methods and ``vec_distr`` on
       ``time_measurement.json``, and the three examples (the mesh one on
       4 × 1 entries of the card).

    Each driver's launches are counted from 0 and kept in
    ``path_launches`` under ``drivers_<name>``; nothing under ``reports/``
    may change."""
    import gc
    import importlib
    import io
    import tempfile
    from pathlib import Path

    import numpy as np

    from postgres_word2vec_tpu_torch import Freddy, VectorStore
    from postgres_word2vec_tpu_torch.evaluation import serving_bench as sb
    from postgres_word2vec_tpu_torch.ops import kernels

    before_reports = reports_digest()
    out = {"wall_s": {}, "launches": {}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))

    def module(name):
        return importlib.import_module(
            f"postgres_word2vec_tpu_torch.cli.{name}")

    def subprocess_driver(name, *args, cwd):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m",
                              f"postgres_word2vec_tpu_torch.cli.{name}",
                              *map(str, args)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=900)
        took = time.perf_counter() - t0
        check(res.returncode == 0, f"python -m {name} exited "
              f"{res.returncode}: {res.stderr[-2000:]}")
        check(not sb.child_processes(), f"python -m {name} left "
              f"{sb.child_processes()}")
        out["wall_s"][name] = took
        lines = res.stdout.strip().splitlines()
        log(f"[14] python -m {name}: {took:.1f} s, exit 0, no process left,"
            f" launches counted in its own process only; "
            f"{' | '.join(ln.split('INFO: ')[-1] for ln in lines)[:300]} "
            f"on {card}")
        return lines

    def in_process(name, fn, tmp, launches_label=None):
        """Run a driver's ``main`` with its counts set to 0 just before,
        its printout into a file in ``tmp``; → (result, launches)."""
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        label = launches_label or name
        path_launches[f"drivers_{label}"] = counts
        out["wall_s"][label] = took
        out["launches"][label] = counts
        Path(tmp, f"{label}.out").write_text(buf.getvalue())
        return res, counts, took

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- 1. the offline chain, as subprocesses on the card
        t_chain = time.perf_counter()
        (tmp / "vectors").mkdir()
        (tmp / "config").mkdir()
        write_word2vec_bin(tmp / "vectors" / "google_vecs.bin", head_words,
                           head_vecs)
        cfgs = {}
        for name in ("vecs_config", "pq_config", "ivfadc_config",
                     "ivpq_config"):
            cfgs[name] = json.loads(Path(
                REPO, "index_creation", "config", f"{name}.json").read_text())
        cfgs["vecs_config"]["vec_file_path"] = "vectors/google_vecs.bin"
        rng = np.random.default_rng(SEED)
        stats_ids = rng.choice(len(head_words), STATS_WORDS, replace=False)
        (tmp / "stats_words.txt").write_text(
            "\n".join(head_words[i] for i in stats_ids) + "\n")
        cfgs["ivpq_config"]["statistic_words_path"] = "stats_words.txt"
        for name, body in cfgs.items():
            (tmp / "config" / f"{name}.json").write_text(json.dumps(body))
        (tmp / "artifacts").mkdir()
        subprocess_driver("index_creation.vec2database",
                          "config/vecs_config.json", cwd=tmp)
        for fam in ("pq_index", "ivfadc", "ivpq"):
            cfg = fam.replace("_index", "") + "_config.json"
            subprocess_driver(f"index_creation.{fam}", f"config/{cfg}",
                              cwd=tmp)
        stats = np.load(tmp / "artifacts" / "ivpq_index.npz.stats.npy")
        check(stats[-1] == STATS_WORDS and abs(stats[:-1].sum() - 1) < 1e-4,
              f"ivpq statistics: total {stats[-1]}, shares sum "
              f"{stats[:-1].sum()}")
        self_match = {}
        for fam in ("pq", "ivfadc", "ivpq"):
            art = "pq_index.npz" if fam == "pq" else f"{fam}_index.npz"
            line = subprocess_driver(
                "index_creation.load_index", "artifacts/store.npz",
                f"artifacts/{art}", fam, cwd=tmp)[-1]
            self_match[fam] = float(line.rsplit(" ", 1)[1])
            check(line.startswith(f"loaded {fam} index: {len(head_words)} "
                                  "rows") and self_match[fam]
                  >= SELF_MATCH_FLOOR, f"load_index {fam}: {line}")
            # the same load in-process, for its launches
            _, counts, took = in_process(f"load_index_{fam}", lambda: module(
                "index_creation.load_index").main(
                    str(tmp / "artifacts" / "store.npz"),
                    str(tmp / "artifacts" / art), fam), tmp)
            log(f"[14] driver load_index {fam} in-process: {took:.1f} s, "
                f"launches {counts} on {card}")
        out["self_match@1"] = self_match

        small_words, small = head_words[:MIGRATE_N], head_vecs[:MIGRATE_N]
        write_word2vec_bin(tmp / "small.bin", small_words, small)
        subprocess_driver("index_creation.transform_vecs", "small.bin",
                          "small.txt", cwd=tmp)
        text = (tmp / "small.txt").read_text().splitlines()
        check(text[0] == f"{MIGRATE_N} {small.shape[1]}"
              and [ln.split(" ", 1)[0] for ln in text[1:]] == small_words,
              "transform_vecs wrote another header or other words")
        back = np.array([[float(x) for x in ln.split(" ")[1:]]
                         for ln in text[1:]], dtype=np.float32)
        check(np.array_equal(back, small), "transform_vecs' text does not "
              "read back equal to its rows")

        eng = Freddy.build(VectorStore.from_arrays(small_words, small),
                           seed=SEED, preset="reference", k_coarse=128,
                           ivpq_k_coarse=16, train_size=None, iters=8)
        eng.save(tmp / "engine")
        del eng
        subprocess_driver("index_creation.import_freddy", "export", "engine",
                          "dump", cwd=tmp)
        subprocess_driver("index_creation.import_freddy", "import", "dump",
                          "engine_back", cwd=tmp)
        for name in ("pq.npz", "ivfadc.npz", "ivpq.npz", "store.npz"):
            a, b = (npz_arrays(tmp / d / name)
                    for d in ("engine", "engine_back"))
            check(a.keys() == b.keys() and all(
                a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n])
                for n in a), f"import_freddy's round trip changed {name}")
        out["offline_chain_s"] = time.perf_counter() - t_chain
        log(f"[14] offline chain at {len(head_words)} x {head_vecs.shape[1]}"
            f" (the first {OFFLINE_N} rows of the phase-4 store): "
            f"self-match@1 {self_match}; transform_vecs equal; the FREDDY "
            f"round trip bit-equal; {out['offline_chain_s']:.1f} s on {card}")

        # ---- 2. the evaluation drivers at 3,072,000 x 300
        def eval_config(name, **over):
            body = json.loads(Path(REPO, "evaluation", "config",
                                   name).read_text())
            body.update(over)
            path = tmp / f"eval_{name}"
            path.write_text(json.dumps(body))
            return str(path)

        jax_tp = {(r["method"], r.get("alpha"),
                   r.get("pvf") if r["method"] == 2 else None): r["precision"]
                  for r in json.loads(Path(
                      REPO, "reports", "time_precision_records.json")
                      .read_text())}
        by_call: dict = {}
        cfg = eval_config("time_precision_full.json",
                          plot_path=str(tmp / "time_precision.png"))
        with launches_by_join_call(kernels, Freddy, by_call):
            recs, counts, took = in_process(
                "time_precision_eval", lambda: module(
                    "evaluation.time_precision_eval").main(cfg), tmp)
        check((tmp / "time_precision.html").stat().st_size > 10_000,
              "time_precision_eval wrote no HTML report")
        for r in recs:
            key = (r["method"], r.get("alpha"),
                   r.get("pvf") if r["method"] == 2 else None)
            log(f"[14] time_precision_full method {r['method']} alpha "
                f"{r.get('alpha')} pvf {r.get('pvf')}: precision@5 "
                f"{r['precision']:.4f} (JAX record {jax_tp.get(key)}), "
                f"{r['time_s']:.3f} s on {card}")
        best = {m: max(r["precision"] for r in recs if r["method"] == m
                       and r.get("alpha") == 200) for m in (1, 2)}
        check(best[2] >= FLOORS["join_m2_a200@5"], f"time_precision_full "
              f"method 2 alpha 200 precision {best[2]:.4f} < "
              f"{FLOORS['join_m2_a200@5']}")
        check(best[1] >= FLOORS["join_m1_a200@5"], f"time_precision_full "
              f"method 1 alpha 200 precision {best[1]:.4f} < "
              f"{FLOORS['join_m1_a200@5']}")
        budget_adc = ("budget_adc", "budget_adc_grouped")
        budget_exact = ("budget_exact", "budget_exact_grouped")
        for label, want in (("m0", budget_adc), ("m2", budget_adc),
                            ("m1", budget_exact),
                            ("pq_in_batch", ("adc_scan",))):
            check(any(by_call.get(label, {}).get(k, 0) > 0 for k in want),
                  f"time_precision_full {label} launched "
                  f"{by_call.get(label)}, none of {want}")
        out["time_precision_full"] = {"records": recs, "by_call": by_call}
        log(f"[14] driver time_precision_eval: {took:.1f} s, launches "
            f"{counts}, by call {by_call}; best precision@5 at alpha 200: "
            f"method 1 {best[1]:.4f}, method 2 {best[2]:.4f} on {card}")

        cfg = eval_config("step_wise_3M.json", out=str(tmp / "step_wise.json"))
        recs, counts, took = in_process("step_wise_time_measurement",
                                        lambda: module(
            "evaluation.step_wise_time_measurement").main(cfg), tmp)
        stages = ("precomputation_time", "data_retrieval_time",
                  "computation_time", "total_time", "query_construction_time")
        for r in recs:
            check(all(s in r["stages"] for s in stages)
                  and r["inner_s"] <= r["wall_s"],
                  f"step_wise record {r['method']} {r['queries']}: stages "
                  f"{sorted(r['stages'])}, inner {r['inner_s']} wall "
                  f"{r['wall_s']}")
        check(json.loads((tmp / "step_wise.json").read_text()) == recs,
              "step_wise's out file differs from its printout")
        out["step_wise"] = recs
        log(f"[14] driver step_wise_time_measurement: {took:.1f} s, launches"
            f" {counts}; " + "; ".join(
                f"{r['method']} q={r['queries']} wall {r['wall_s']:.4f} inner"
                f" {r['inner_s']:.4f} compile {r['compile_s']:.3f} s"
                for r in recs) + f" on {card}")

        conf_cfg = eval_config("confidence_eval_3M.json")
        flex_cfg = eval_config("flexible_pq_3M.json")
        recs, counts, took = in_process("confidence_eval", lambda: module(
            "evaluation.confidence_eval").main(conf_cfg), tmp)
        for r in recs:
            check(r["fraction_met"] >= r["confidence"], f"confidence_eval: "
                  f"the guarantee fails at {r}")
        out["confidence_eval"] = recs
        log(f"[14] driver confidence_eval: {took:.1f} s, launches {counts}; "
            + ", ".join(f"c {r['confidence']}: met {r['fraction_met']:.2f} "
                        f"(retrieved {r['mean_retrieved']:.1f})"
                        for r in recs) + f" on {card}")
        res, counts, took = in_process("target_counts", lambda: module(
            "evaluation.target_counts").main(conf_cfg), tmp)
        div = res["mean_abs_rel_divergence"]
        check(div <= TARGET_COUNT_CEILING, f"target_counts: mean abs rel "
              f"divergence {div:.4f} > {TARGET_COUNT_CEILING}")
        out["target_counts_divergence"] = div
        log(f"[14] driver target_counts: {took:.1f} s, launches {counts}; "
            f"mean abs rel divergence {div:.4f} (the JAX record "
            f"reports/target_counts_3M.json: 0.0260) on {card}")
        recs, counts, took = in_process("flexible_pq_eval", lambda: module(
            "evaluation.flexible_pq_eval").main(flex_cfg), tmp)
        for r in recs:
            gap = abs(r["long_codes"]["precision"]
                      - r["short_codes"]["precision"])
            check(gap <= 0.02, f"flexible_pq_eval: long and short codes "
                  f"differ by {gap:.4f} at {r['targets']} targets")
        out["flexible_pq_eval"] = recs
        log(f"[14] driver flexible_pq_eval: {took:.1f} s, launches {counts};"
            " " + ", ".join(
                f"{r['targets']} targets alpha {r['alpha']}: long "
                f"{r['long_codes']['precision']:.4f} in "
                f"{r['long_codes']['time_s']:.4f} s, short "
                f"{r['short_codes']['precision']:.4f} in "
                f"{r['short_codes']['time_s']:.4f} s" for r in recs)
            + f" on {card}")

        # ---- 3. the small drivers and the examples
        tm_cfg = Path(REPO, "evaluation", "config", "time_measurement.json")
        for method in ("default", "defaultpv", "sizedependend",
                       "postverification", "batch", "batch-precision"):
            cfg = eval_config("time_measurement.json", method=method)
            res, counts, took = in_process(
                f"time_measurement_{method}", lambda: module(
                    "evaluation.time_measurement").main(cfg), tmp)
            keys = {k: v for k, v in res.items()
                    if k not in ("method", "k", "queries")}
            log(f"[14] driver time_measurement {method}: {took:.1f} s, "
                f"launches {counts}; {json.dumps(keys)[:400]} on {card}")
        res, counts, took = in_process("vec_distr", lambda: module(
            "evaluation.vec_distr").main(str(tm_cfg)), tmp)
        check(-1 <= res["farthest_cos"]["mean"] < res["nearest_cos"]["mean"]
              <= 1, f"vec_distr: {res}")
        log(f"[14] driver vec_distr: {took:.1f} s, launches {counts}; "
            f"nearest cos {res['nearest_cos']['mean']:.4f}, farthest "
            f"{res['farthest_cos']['mean']:.4f} on {card}")
        eng, counts, took = in_process("quickstart", lambda: module(
            "examples.quickstart").main(), tmp)
        check(eng.store.device.type == "cuda" and eng.store.size == 2001,
              "the quickstart's engine is not on the card")
        del eng
        tuned = [ln for ln in (tmp / "quickstart.out").read_text()
                 .splitlines() if ln.startswith("autotune")]
        log(f"[14] driver quickstart: {took:.1f} s, launches {counts}; "
            f"{tuned} on {card}")
        health, counts, took = in_process("serving", lambda: module(
            "examples.serving").main(), tmp)
        check("serving example OK" in (tmp / "serving.out").read_text()
              and health["vocab"] == 2001, f"serving example: {health}")
        log(f"[14] driver serving: {took:.1f} s, launches {counts}; health "
            f"{health} on {card}")
        res, counts, took = in_process("multichip", lambda: module(
            "examples.multichip").main(4, 1), tmp)
        check("not multi-GPU scaling" in (tmp / "multichip.out").read_text()
              and res["exact"] == 1.0, f"multichip example: {res}")
        log(f"[14] driver multichip (4 x 1 entries of the one card: "
            f"shard-and-merge overhead, not multi-GPU scaling): {took:.1f} s,"
            f" launches {counts}; self-match@1 {res} on {card}")
        out["multichip"] = res
    check(not sb.child_processes(), f"processes left after the drivers: "
          f"{sb.child_processes()}")
    check(reports_digest() == before_reports, "a driver changed reports/")
    return out


# --------------------------------------------- 15: the research drivers
@contextlib.contextmanager
def held_to_plain(torch, kernels, names: tuple[str, ...], plain, when,
                  found: dict, tol: dict = TOL):
    """While the block runs, the first launch of any of the kernels
    ``names`` (functions of the module ``kernels``) whose arguments satisfy
    ``when`` is held to ``plain`` on the same arguments, at ``tol``: its
    error and shapes are put in ``found``. The main path's own launch is
    the one compared; the plain version launches no kernel."""
    saved = {name: getattr(kernels, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if not found and when(*args, **kw):
                want = plain(*args, **kw)
                if isinstance(out, tuple):
                    err = float((out[0] - want[0]).abs().max())
                    check(torch.equal(out[1], want[1]) and err <= tol[name],
                          f"{name}: ids or mins differ from the plain "
                          f"version (mins err {err})")
                else:
                    err = budget_err(torch, out, want, name, "research")
                found.update(name=name, err=err,
                             shapes=[tuple(a.shape) for a in args
                                     if hasattr(a, "shape")])
            return out
        return call

    for name, fn in saved.items():
        setattr(kernels, name, wrap(name, fn))
    try:
        yield found
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def research_phase(torch, path_launches: dict, card: str) -> dict:
    """Phase 15: the research drivers (``cli/evaluation``) in-process on
    the card, each at its JAX record's scale and flags (RESEARCH_ARGS),
    every file they write in a temporary directory. For each: its wall
    time, its launches (counted from 0, kept in ``path_launches`` under
    ``research_<name>``), its peak allocated memory and its key numbers
    beside the JAX record's, held to RESEARCH_FLOORS; the memory allocated
    after it returns must be under 1 GiB. K4 at 10,240,000 rows and 60×16
    (the quality regime's PQ scan) and the budget kernel of the 10.24M
    join's first call (the plan of one call) are held to their plain
    versions on their main-path launch; nothing under ``reports/``
    changes."""
    import gc
    import importlib
    import io
    import tempfile
    from pathlib import Path

    from postgres_word2vec_tpu_torch.ops import kernels

    before_reports = reports_digest()
    out = {"wall_s": {}, "launches": {}, "peak_gib": {}, "records": {}}

    def jax_record(name):
        return json.loads(Path(REPO, "reports", name).read_text())

    def run(label, module, args, tmp, hold=None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        outs = [] if module in ("roofline", "join_method_diag") else [
            "--out", str(tmp / f"{label}.json")]
        main = importlib.import_module(
            f"postgres_word2vec_tpu_torch.cli.evaluation.{module}").main
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), (
                hold or contextlib.nullcontext()):
            res = main([*args, *outs])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        path_launches[f"research_{label}"] = counts
        out["wall_s"][label], out["launches"][label] = took, counts
        out["peak_gib"][label], out["records"][label] = peak, res
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        check(left < 1.0, f"{label}: {left:.2f} GiB still allocated after "
              "the driver returned")
        log(f"[15] driver {label}: {took:.1f} s, launches {counts}, peak "
            f"{peak:.2f} GiB, {left:.2f} GiB left after it on {card}")
        return res, counts

    def floor(label, what, got, want_floor, jax=None):
        check(got >= want_floor, f"{label} {what} {got:.4f} < "
              f"{want_floor}")
        log(f"[15] {label} {what}: {got:.4f} (floor {want_floor}"
            + (f", JAX record {jax}" if jax is not None else "") + ")")

    def launched(label, counts, want):
        check(any(counts.get(k, 0) > 0 for k in want),
              f"{label} launched {counts}, none of {want}")

    def rising(label, recalls):
        check(all(b >= a - ALPHA_SLACK for a, b in zip(recalls, recalls[1:])),
              f"{label}: recall does not rise with alpha: {recalls}")

    budget = ("budget_adc", "budget_adc_grouped")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- roofline: the card's ceilings, then the scans at 3M
        res, counts = run("roofline", "roofline", RESEARCH_ARGS["roofline"],
                          tmp)
        launched("roofline", counts, ("adc_scan",))
        ceil, jr = res["ceilings"], jax_record("roofline_3M.json")
        for key, fl in RESEARCH_FLOORS["roofline"].items():
            floor("roofline", key, ceil[key], fl)
        log(f"[15] roofline ceilings on {card}: HBM read "
            f"{ceil['hbm_read_gbps']:.1f} GB/s (probes "
            f"{[round(r, 1) for r in ceil['hbm_probe_gbps']]}), bf16 "
            f"{ceil['mxu_bf16_tflops']:.1f} TFLOP/s, int8 "
            f"{ceil['mxu_int8_tops']:.1f} TOP/s (data sheet 3,350 GB/s, "
            f"989, 1,979)")
        for name, v in res["kernels"].items():
            log(f"[15] roofline {name}: {v['wall_s'] * 1e3:.3f} ms, "
                f"{v['gbps']:.1f} GB/s, {v['roofline']} bound, "
                f"{v['pct_of_bound']} % of bound"
                + (f" (card bound {v['bound_ms']:.4f} ms, "
                   f"{v['bound_term']}; {v['pct_of_measured_hbm']} % of "
                   f"the measured HBM rate)" if "bound_ms" in v else "")
                + f"; JAX record {jr['kernels'][name]['pct_of_bound']} % "
                f"on its TPU, on {card}")

        # ---- the recall ceiling at 3M
        res, counts = run("recall_ceiling", "recall_ceiling",
                          RESEARCH_ARGS["recall_ceiling"], tmp)
        launched("recall_ceiling", counts, ("adc_scan",))
        launched("recall_ceiling", counts, ("adc_scan_binned",))
        launched("recall_ceiling", counts, budget)
        jr = jax_record("recall_ceiling_v3_3M.json")
        for key, fl in RESEARCH_FLOORS["recall_ceiling"].items():
            floor("recall_ceiling", key, res[key], fl, jr[key])
        log(f"[15] recall_ceiling @10: pq {res['pq@10']:.4f}, pq_pv "
            f"{res['pq_pv@10']:.4f}, ivfadc {res['ivfadc@10']:.4f}, "
            f"ivfadc_pv {res['ivfadc_pv@10']:.4f} (JAX {jr['pq@10']}, "
            f"{jr['pq_pv@10']}, {jr['ivfadc@10']}, {jr['ivfadc_pv@10']})")

        # ---- the generator calibration, two configs at 307,200 rows
        res, counts = run("synth_calibrate", "synth_calibrate",
                          RESEARCH_ARGS["synth_calibrate"], tmp)
        launched("synth_calibrate", counts, ("adc_scan",))
        jr = {r["config"]: r for r in jax_record("synth_calib_307k.json")}
        for r in res:
            for key, fl in RESEARCH_FLOORS["synth_calibrate"][
                    r["config"]].items():
                floor(f"synth_calibrate {r['config']}", key, r[key], fl,
                      jr.get(r["config"], {}).get(key))

        # ---- the join's batch-size sweep at 3M
        res, counts = run("join_nq_sweep", "join_nq_sweep",
                          RESEARCH_ARGS["join_nq_sweep"], tmp)
        launched("join_nq_sweep", counts, budget)
        check(json.loads((tmp / "join_nq_sweep.json").read_text()) == res,
              "join_nq_sweep's out file differs from its record")
        jr = jax_record("join_nq_sweep_3M.json")
        log(f"[15] join_nq_sweep prepare_join over {res['n']:,} rows "
            f"{res['prepare_join_s']:.3f} s on {card}")
        for nq, row in res["sweep"].items():
            for key, fl in RESEARCH_FLOORS["join_nq_sweep"].items():
                floor(f"join_nq_sweep nq={nq}", f"{key} recall@5",
                      row[key]["recall5"], fl,
                      jr["sweep"].get(nq, {}).get(key, {}).get("recall5"))
            rising(f"join_nq_sweep nq={nq}",
                   [row[k]["recall5"] for k in row if k.startswith("ivpq")])
            log(f"[15] join_nq_sweep nq={nq} on {card}: " + ", ".join(
                f"{k} {v['total_s'] * 1e3:.2f} ms ({v['qps']:.0f} q/s, "
                f"recall@5 {v['recall5']:.4f})" for k, v in row.items()))

        # ---- method 0 against method 2 at 3M
        res, counts = run("join_method_diag", "join_method_diag",
                          RESEARCH_ARGS["join_method_diag"], tmp)
        launched("join_method_diag", counts, budget)
        check(all(v > 0 for v in res.values()), f"join_method_diag: {res}")
        log(f"[15] join_method_diag on {card}: {json.dumps(res)}")

        # ---- 10,240,000 rows on the card, both PQ regimes
        for regime in ("reference", "quality"):
            label = f"scale_capacity_{regime}"
            k4: dict = {}
            hold = held_to_plain(
                torch, kernels, ("adc_scan_binned",),
                lambda luts, codes_t, **kw: kernels.adc_scan_binned_plain(
                    luts, codes_t, block_n=kw.get("block_n", 2048),
                    bins=kw.get("bins", kernels.BINNED_BINS)),
                lambda luts, codes_t, **kw: (
                    regime == "quality" and luts.shape[1] == 60
                    and codes_t.shape[1] == SCALE_N), k4)
            res, counts = run(label, "scale_capacity", RESEARCH_ARGS[label],
                              tmp, hold)
            launched(label, counts, ("adc_scan_binned",))
            jr = jax_record(f"scale_10M_{regime}.json")
            for key, fl in RESEARCH_FLOORS[label].items():
                floor(label, f"{key} recall@10", res[key]["recall"], fl,
                      jr[key]["recall"])
            if regime == "quality":
                check(k4.get("name") == "adc_scan_binned",
                      "K4 at 10.24M and 60x16 was never held to its plain "
                      "version")
                out["k4_10M_err"] = k4["err"]
                log(f"[15] K4 at {k4['shapes']} (10.24M rows, 60x16) equal "
                    f"to its plain version: mins err {k4['err']}, ids equal"
                    f" on {card}")
            jax_bins = jr.get("bin_collision", {}).get(
                "colliding_gt10_pairs", "not recorded")
            log(f"[15] {label} on {card}: bin collisions "
                f"{res['bin_collision']['colliding_gt10_pairs']} (JAX "
                f"{jax_bins}); " + ", ".join(
                    f"{k} {v['per_query_ms']:.5f} ms/query at B = "
                    f"{v['batch']}, recall@10 {v['recall']:.4f}, @5 "
                    f"{v['recall5']:.4f} (JAX {jr[k].get('recall')})"
                    for k, v in res.items() if isinstance(v, dict)
                    and "per_query_ms" in v))

        # ---- the join over 10,240,000 rows
        plan: dict = {}

        def first_join_call(luts, codes_t, rowterm, tiles, **kw):
            return codes_t.shape[1] >= SCALE_N

        def plain_budget(luts, codes_t, rowterm, tiles, *, block_t, **kw):
            b, p = tiles.shape
            n_tiles = codes_t.shape[1] // block_t
            real = int((tiles != n_tiles - 1).sum())
            plan.update(queries=b, slots=p, block_t=block_t,
                        n_tiles=n_tiles, real_slots=real,
                        grouped=kernels._grouped_wins(
                            b * p, n_tiles, kernels.GROUPED_ROWS_DEFAULT,
                            luts.shape[1] * luts.shape[2] * 2))
            return kernels.budget_adc_plain(luts, codes_t, rowterm, tiles,
                                            block_t=block_t)

        held: dict = {}
        res, counts = run("scale_join_10M", "scale_join_10M",
                          RESEARCH_ARGS["scale_join_10M"], tmp,
                          held_to_plain(torch, kernels, budget, plain_budget,
                                        first_join_call, held))
        launched("scale_join_10M", counts, budget)
        check(held.get("name") in budget, "the 10.24M join's budget kernel "
              "was never held to its plain version")
        out["join_10M_budget"] = {**held, **plan}
        log(f"[15] the 10.24M join's first call: {held['name']} (the "
            f"grouped rule says {plan['grouped']}) at B = {plan['queries']},"
            f" P = {plan['slots']} slots of {plan['block_t']} rows over "
            f"{plan['n_tiles']} tiles, {plan['real_slots']} slots off the "
            f"inf tile (a share of "
            f"{plan['real_slots'] / (plan['queries'] * plan['slots']):.3f}),"
            f" equal to its plain version within {held['err']} on {card}")
        jr = jax_record("scale_join_10M.json")
        for key, fl in RESEARCH_FLOORS["scale_join_10M"].items():
            floor("scale_join_10M", f"{key} recall@5", res[key]["recall5"],
                  fl, jr[key]["recall5"])
        alphas = [k for k in res if k.startswith("ivpq_join")]
        rising("scale_join_10M", [res[k]["recall5"] for k in alphas])
        log(f"[15] scale_join_10M on {card}: prepare_join over {res['n']:,}"
            f" rows {res['prepare_join']['build_s']:.3f} s (JAX on its TPU "
            f"{jr['prepare_join']['build_s']:.1f} s); exact bf16 "
            f"{res['exact_bf16']['total_s']:.3f} s for {res['nq']:,} "
            "queries; "
            + ", ".join(f"{k} {res[k]['total_s']:.3f} s, recall@5 "
                        f"{res[k]['recall5']:.4f}, scanned "
                        f"{res[k]['scanned_rows_mean']:.0f} rows, "
                        f"{res[k]['rounds']} round(s)" for k in alphas))
    check(reports_digest() == before_reports,
          "a research driver changed reports/")
    return out


# ------------------------------- 16: the graft entry and the kernel sweeps
def sweeps_phase(torch, path_launches: dict, card: str) -> dict:
    """Phase 16: the last entry points, on the card.

    1. ``graft_entry.entry()``: the forward step's shapes, one K2 launch,
       and its answer held to the same forward over the index moved to
       the CPU (the plain path), ids up to ties, values within 1e-5;
    2. ``graft_entry.dryrun_multichip`` on 4 and 8 entries of the one card
       (the shard-and-merge overhead, not multi-GPU scaling);
    3. the three kernel sweeps at their JAX records' defaults
       (SWEEP_ARGS), every file they write in a temporary directory:
       ``budget_kernel_sweep`` (every ``_match`` true; in a process of its
       own, SWEEP_CHILD, since it reads ``torch.profiler`` traces),
       ``adc_kernel_probe --sweep`` (its first sweep point, K4 at forced
       queries per block, held to ``adc_scan_binned_plain`` by
       ``held_to_plain``, bit for bit) and
       ``exact_block_sweep`` (``overlap_vs_first`` at least
       EXACT_OVERLAP_FLOOR at every size that ran, block_n 8192 among
       them).

    Each step's launches are counted from 0 and kept in ``path_launches``
    under ``sweeps_<name>``, with its wall time and peak memory; less than
    1 GiB is left allocated after each; nothing under ``reports/``
    changes. The JAX records of ``reports/`` are printed only as a TPU's
    history."""
    import gc
    import importlib
    import io
    import tempfile
    from pathlib import Path

    from postgres_word2vec_tpu_torch import graft_entry
    from postgres_word2vec_tpu_torch.cli.evaluation import adc_kernel_probe
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
    from postgres_word2vec_tpu_torch.ops import kernels

    before_reports = reports_digest()
    out = {"wall_s": {}, "launches": {}, "peak_gib": {}, "records": {}}

    @contextlib.contextmanager
    def step(label):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        got = {"stdout": io.StringIO(), "stderr": io.StringIO()}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(got["stdout"]), \
                contextlib.redirect_stderr(got["stderr"]):
            yield got
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if "child" in got:      # the step ran in a process of its own
            counts, peak = got["child"]["counts"], got["child"]["peak_gib"]
        path_launches[f"sweeps_{label}"] = counts
        out["wall_s"][label], out["launches"][label] = took, counts
        out["peak_gib"][label] = peak
        got.update(counts=counts, took=took)
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        check(left < 1.0, f"{label}: {left:.2f} GiB still allocated after "
              "it returned")
        log(f"[16] {label}: {took:.1f} s, launches {counts}, peak "
            f"{peak:.2f} GiB, {left:.2f} GiB left after it on {card}")

    def relog(label, text):
        for line in text.getvalue().splitlines():
            if line.strip():
                log(f"[16] {label}: {line}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- the forward step on the card, held to the plain path
        with step("graft_entry") as got:
            fn, args = graft_entry.entry()
            vals, ids, retrieved = fn(*args)
        check(got["counts"] == {"adc_scan": 1},
              f"entry()'s forward launched {got['counts']}, not K2 once")
        check(vals.is_cuda and tuple(vals.shape) == (16, 5)
              and tuple(ids.shape) == (16, 5)
              and tuple(retrieved.shape) == (16,),
              f"entry()'s shapes {vals.shape} {ids.shape} {retrieved.shape}")
        fn.index.save(tmp / "tiny_ivpq.npz")
        fn_cpu = graft_entry.forward_step(
            IVPQIndex.load(tmp / "tiny_ivpq.npz", device="cpu"),
            fn.vecs.cpu())
        pv, pi, pr = fn_cpu(args[0].cpu(), args[1])
        same_top_k(torch, vals.cpu(), ids.cpu(), pv, pi, 1e-5,
                   "entry()'s forward on the card against the plain path")
        check(torch.equal(retrieved.cpu(), pr),
              "entry()'s retrieved counts differ from the plain path's")
        out["graft_entry_err"] = float((vals.cpu() - pv).abs().max())
        log(f"[16] entry() forward on {card}: shapes (16, 5), (16, 5), "
            f"(16,); K2 once; values within {out['graft_entry_err']:.3g} "
            f"of the plain path, ids equal up to ties, retrieved equal")
        del fn, args, vals, ids, retrieved, fn_cpu

        # ---- the mesh dry run on entries of the one card
        for n in (4, 8):
            with step(f"dryrun_multichip_{n}") as got:
                graft_entry.dryrun_multichip(n)
            text = got["stdout"].getvalue()
            check("dryrun_multichip ok" in text
                  and "not multi-GPU scaling" in text,
                  f"dryrun_multichip({n}): {text}")
            log(f"[16] dryrun_multichip({n}) on {n} entries of the one card"
                f" (the shard-and-merge overhead, not multi-GPU scaling): "
                f"{text.splitlines()[0][len('dryrun_multichip ok: '):]}")

        # ---- the kernel sweeps at their JAX records' defaults
        def sweep(label, args, hold=None, own_process=False):
            main = importlib.import_module(
                f"postgres_word2vec_tpu_torch.cli.evaluation.{label}").main
            outs = ([] if label == "adc_kernel_probe"
                    else ["--out", str(tmp / f"{label}.json")])
            with step(label) as got, (hold or contextlib.nullcontext()):
                if own_process:
                    proc = subprocess.run(
                        [sys.executable, "-c", SWEEP_CHILD, label, *args,
                         *outs], cwd=REPO, capture_output=True, text=True,
                        timeout=600)
                    check(proc.returncode == 0, f"{label} exited "
                          f"{proc.returncode}: {proc.stderr[-3000:]}")
                    *lines, last = proc.stderr.strip().splitlines()
                    got["stderr"].write("\n".join(lines))
                    got["child"] = json.loads(last)
                    res = got["child"]["record"]
                else:
                    res = main([*args, *outs])
            relog(label, got["stderr"])
            out["records"][label] = res
            return res, got["counts"]

        # in a process of its own: its programs are read from a
        # torch.profiler trace, and in this process, after the serving
        # phase's threads, the profiler has recorded no kernel in three
        # traces in a row (and its stop once crashed phase 8)
        res, counts = sweep("budget_kernel_sweep",
                            SWEEP_ARGS["budget_kernel_sweep"],
                            own_process=True)
        check(json.loads((tmp / "budget_kernel_sweep.json").read_text())
              == res, "budget_kernel_sweep's out file differs from its "
              "record")
        matches = {k: v for k, v in res.items() if k.endswith("_match")}
        check(len(matches) == 6 and all(matches.values()),
              f"budget_kernel_sweep: {matches}")
        check({"budget_adc", "budget_adc_grouped",
               "budget_adc_grouped_int8"} <= counts.keys(),
              f"budget_kernel_sweep launched {counts}")
        log(f"[16] budget_kernel_sweep on {card}: " + ", ".join(
            f"{k} {v * 1e3:.4f} ms" for k, v in res.items()
            if k.endswith("_s")) + "; programs " + ", ".join(
            f"{k[:-len('_programs')]} {v}" for k, v in res.items()
            if k.endswith("_programs")) + f"; mean_run {res['mean_run']}")
        jr = json.loads(Path(REPO, "reports",
                             "budget_kernel_sweep.json").read_text())
        check(res["mean_run"] == jr["mean_run"],
              f"budget_kernel_sweep draws: mean_run {res['mean_run']} is "
              f"not the JAX record's {jr['mean_run']}")
        log("[16] TPU record (history), reports/budget_kernel_sweep.json: "
            + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in jr.items()
                        if k.endswith("_s")))

        # the sweep's first point (block_n 2048, 16 queries a block, its
        # loop order) held to the plain version, bit for bit
        first: dict = {}
        res, counts = sweep(
            "adc_kernel_probe", SWEEP_ARGS["adc_kernel_probe"],
            held_to_plain(
                torch, adc_kernel_probe, ("binned_at",),
                lambda luts, codes_t, *, block_n, bins, qb:
                kernels.adc_scan_binned_plain(luts, codes_t,
                                              block_n=block_n, bins=bins),
                lambda *args, **kw: True, first,
                tol={"binned_at": TOL["adc_scan_binned"]}))
        check(first.get("name") == "binned_at" and first["err"] == 0.0,
              f"the probe's first sweep point was not held: {first}")
        points = res["sweep_m12k256_B256"]
        check(all(isinstance(v, float) for k, v in points.items()
                  if k.endswith("bins128")) and len(points) == 18,
              f"adc_kernel_probe --sweep: {points}")
        check({"adc_scan", "adc_scan_binned"} <= counts.keys(),
              f"adc_kernel_probe launched {counts}")
        log(f"[16] adc_kernel_probe on {card}: the first sweep point "
            f"(block_n 2048, qb 16, bins 128, {first['shapes']}) equal to "
            f"adc_scan_binned_plain; "
            + json.dumps(res))

        res, counts = sweep("exact_block_sweep",
                            SWEEP_ARGS["exact_block_sweep"])
        ran = {k: v for k, v in res.items()
               if isinstance(v, dict) and "scan_s" in v}
        check("bn8192" in ran, f"exact_block_sweep: block_n 8192 did not "
              f"run: {res.get('bn8192')}")
        check(all(v["overlap_vs_first"] >= EXACT_OVERLAP_FLOOR
                  for v in ran.values()),
              f"exact_block_sweep overlaps: {ran}")
        check(counts.get("fused_exact_scan", 0) > 0,
              f"exact_block_sweep launched {counts}")
        log(f"[16] exact_block_sweep on {card}: " + ", ".join(
            f"{k} {v['scan_s'] * 1e3:.3f} ms a B = {res['b']} scan, "
            f"{v['eff_gbps']:.1f} GB/s of table, overlap "
            f"{v['overlap_vs_first']}" for k, v in ran.items())
            + "".join(f"; {k} refused: {v['error']}"
                      for k, v in res.items()
                      if isinstance(v, dict) and v.get("failed")))
        jr = json.loads(Path(REPO, "reports",
                             "exact_block_sweep.json").read_text())
        log("[16] TPU record (history), reports/exact_block_sweep.json: "
            + ", ".join(f"{k} {v['scan_s'] * 1e3:.3f} ms"
                        for k, v in jr.items()
                        if isinstance(v, dict) and "scan_s" in v))
    check(reports_digest() == before_reports, "a sweep changed reports/")
    return out


# ----------------------------------------------- 17: the benchmark driver
@contextlib.contextmanager
def bench_holds(torch, kernels, found: dict):
    """While the block runs, the first launch of each of BENCH_KERNELS
    (functions of the module ``kernels``) is held to its plain version on
    the same arguments: ``found[name]`` gets its error and shapes. A call
    that does not launch the kernel itself (an int8 request, which runs
    the int8 twin) is passed by. Dense outputs are held as
    ``budget_err`` holds them, the binned scans' ids for equality and
    their mins at TOL, K1 to its binned contract (``verify_binned``, as
    phase 3 holds it). The plain versions launch no kernel."""
    def float_luts(args, kw):
        return kw.get("lut_dtype", "bf16") != "int8"

    def always(args, kw):
        return True

    def drop(plain, *names):
        return lambda *args, **kw: plain(*args, **{
            k: v for k, v in kw.items() if k not in names})

    def scaled(plain):
        return lambda luts, scale, *rest, rows=None, **kw: plain(
            luts, *rest, scale=scale, **kw)

    def fused_err(name, out, want, args, kw):
        q, table, norms = args[:3]
        valid = int(torch.isfinite(norms).sum())

        def score_at(i):
            res = torch.empty(i.shape, device=i.device)
            for s in range(0, i.shape[0], 16):
                rows = table[i[s:s + 16]].float()
                res[s:s + 16] = (norms[i[s:s + 16]] - 2.0 * torch.einsum(
                    "bwd,bd->bw", rows, q[s:s + 16].float()))
            return res

        return kernels.verify_binned(
            out[0], out[1], want[0], score_at,
            block_n=kw.get("block_n", 8192), bins=kw.get("bins", 128),
            valid_n=valid, atol=TOL[name])

    def binned_err(name, out, want, args, kw):
        check(torch.equal(out[1], want[1]),
              f"{name} bench: ids differ from the plain version")
        return budget_err(torch, out[0], want[0], name, "bench")

    def dense_err(name, out, want, args, kw):
        return budget_err(torch, out, want, name, "bench")

    holds = {
        "fused_exact_scan": (always, kernels.fused_exact_scan_plain,
                             fused_err),
        "adc_scan": (float_luts, drop(kernels.adc_scan_plain, "lut_dtype"),
                     dense_err),
        "adc_scan_int8": (always, scaled(kernels.adc_scan_plain), dense_err),
        "adc_scan_binned": (float_luts, drop(kernels.adc_scan_binned_plain,
                                             "lut_dtype"), binned_err),
        "adc_scan_binned_int8": (always,
                                 scaled(kernels.adc_scan_binned_plain),
                                 binned_err),
        "budget_adc": (always, kernels.budget_adc_plain, dense_err),
        "budget_adc_grouped": (float_luts, drop(kernels.budget_adc_plain,
                                                "rows", "lut_dtype"),
                               dense_err),
        "budget_adc_grouped_int8": (always, scaled(kernels.budget_adc_plain),
                                    dense_err),
    }
    saved = {name: getattr(kernels, name) for name in holds}

    def wrap(name, fn, when, plain, err_of):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name not in found and when(args, kw):
                want = plain(*args, **kw)
                found[name] = {"err": err_of(name, out, want, args, kw),
                               "shapes": [list(a.shape) for a in args
                                          if hasattr(a, "shape")]}
            return out
        return call

    for name, (when, plain, err_of) in holds.items():
        setattr(kernels, name, wrap(name, saved[name], when, plain, err_of))
    try:
        yield found
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def bench_phase(torch, path_launches: dict, card: str,
                bench_out: str | None) -> dict:
    """Phase 17: ``cli.bench`` at full scale in a process of its own
    (BENCH_CHILD; it reads a ``torch.profiler`` trace, and after the
    serving phase this process's traces come back empty), its record in a
    temporary directory.

    Fails on a non-zero exit, a row of the committed JAX record
    (``BENCH_LOCAL_latest.json``, a full-scale run of ``bench.py``)
    missing or one added, a one line that does not parse or is 2,048 B or
    longer, ``insert_batch.probe_ok`` false, a recall@5 under
    BENCH_FLOORS, a kernel of BENCH_KERNELS not launched or not held to its
    plain version, or a change under ``reports/`` or to the JAX record.
    Logs each row with its time, recalls and launches, the launches of
    each section, the one line, the table the port's ``gen_readme_table``
    renders from the record, and the JAX r05 line as a TPU's history; the
    run's launches go into ``path_launches["bench"]``."""
    import tempfile
    from pathlib import Path

    from postgres_word2vec_tpu_torch.cli.evaluation import gen_readme_table

    jax_record = Path(REPO, "BENCH_LOCAL_latest.json")

    def digest():
        import hashlib
        return {**reports_digest(), str(jax_record): hashlib.sha256(
            jax_record.read_bytes()).hexdigest()}

    before = digest()
    want_rows = set(json.loads(jax_record.read_text())["configs"])
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp, "bench.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", BENCH_CHILD, "--out",
                               str(out)], cwd=REPO, capture_output=True,
                              text=True, timeout=900)
        took = time.perf_counter() - t0
        for line in proc.stderr.strip().splitlines()[:-1]:
            if line.strip() and "SyncActivityProfilerHandler" not in line:
                log(f"[17] {line}")
        check(proc.returncode == 0, f"cli.bench exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        child = json.loads(proc.stderr.strip().splitlines()[-1])
        text = proc.stdout.strip().splitlines()[-1]
        check(len(text) < 2048, f"the bench line is {len(text)} B")
        line = json.loads(text)
        detail = json.loads(out.read_text())
        if bench_out:
            Path(bench_out).parent.mkdir(parents=True, exist_ok=True)
            Path(bench_out).write_text(out.read_text())
    rows = detail["configs"]
    check(set(rows) == want_rows,
          f"bench rows: missing {sorted(want_rows - set(rows))}, added "
          f"{sorted(set(rows) - want_rows)}")
    check(detail["n_vectors"] == N and detail["device"] == card,
          f"bench record: n_vectors {detail['n_vectors']}, device "
          f"{detail['device']!r}")
    check(rows["insert_batch"]["probe_ok"] is True,
          "insert_batch: a just-inserted phrase is not its own 1-NN")
    for name, floor in BENCH_FLOORS.items():
        check(rows[name]["recall5"] >= floor,
              f"bench {name} recall@5 {rows[name]['recall5']:.4f} < floor "
              f"{floor}")
    counts = child["counts"]
    missing = [k for k in BENCH_KERNELS if not counts.get(k)]
    check(not missing, f"bench launched none of {missing}: {counts}")
    unheld = [k for k in BENCH_KERNELS if k not in child["held"]]
    check(not unheld, f"bench: {unheld} not held to the plain version")
    path_launches["bench"] = counts

    for name, r in rows.items():
        if "per_query_ms" in r:
            t = f"{r['per_query_ms']:.5f} ms/query"
            t += f" (batch {r['batch']})" if "batch" in r else ""
        elif "qps" in r:
            t = f"{r['qps']:.0f} QPS ({r['total_s']:.4f} s)"
        else:
            t = json.dumps({k: v for k, v in r.items() if k != "note"})
        rec = (f", recall@5 {r['recall5']:.4f}, @10 {r['recall']:.4f}"
               if "recall5" in r else "")
        log(f"[17] {name} on {card}: {t}{rec}, launches "
            f"{detail['launches'].get(name, {})}")
    for name, v in child["sections"].items():
        log(f"[17] section {name} launched {v}")
    for name, h in child["held"].items():
        log(f"[17] {name} held to its plain version on its first bench "
            f"launch: err {h['err']}, shapes {h['shapes']}")
    log(f"[17] bench line on {card}: {text}")
    r05 = json.loads(Path(REPO, "BENCH_r05.json").read_text())["parsed"]
    log(f"[17] TPU record (history), BENCH_r05.json: {json.dumps(r05)}")
    for row_text in gen_readme_table.render(detail, "bench.json"):
        log(f"[17] table: {row_text}")
    log(f"[17] bench took {took:.1f} s in its own process, peak "
        f"{child['peak_gib']:.2f} GiB, launches {counts}")
    check(digest() == before, "the bench changed reports/ or "
          "BENCH_LOCAL_latest.json")
    return {"wall_s": took, "launches": counts, "held": child["held"],
            "sections": child["sections"], "line": line}


# ------------------------------- 18: the join round's captured CUDA graphs
#: the benchmark's two join cells: α, long-codes threshold, the kernel
GRAPH_SHAPES = (("long_a200", 200, 1e7, "budget_adc_grouped"),
                ("short_a10000", 10_000, 0.0, "budget_adc"))
GRAPH_SETS, GRAPH_WORDS = 8, 1024


def graphs_phase(torch, eng, words, card: str) -> dict:
    """The served /knn_join round replayed from its two CUDA graphs
    (``models/join_graphs.py``) against the same round run eager, at both
    join cells' statement shapes: 1,024 words a statement against the
    prepared 100k set "t100k" with its statistics, k 5, PQ + PV (pvf 20),
    α 200 in long codes and α 10,000 at threshold 0 in short codes.
    Checks: the facade's rows, and ``search_join``'s answers, counts and
    launches, equal to an eager twin's once the graphs replay;
    ``join_graph_rounds`` 1 and ``join_host_reads`` 5 a warm statement.
    Reports the facade's ms a statement eager and replayed, the plan
    sizes P, the graphs held, the memory their pool pins (reserved memory
    with the graphs and without, each after ``empty_cache``) and the peak
    allocated while they replay."""
    import gc

    from postgres_word2vec_tpu_torch.models.ivpq import PQ_PV_CALC, IVPQIndex
    from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs
    from postgres_word2vec_tpu_torch.ops import kernels
    from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER

    ivpq, p = eng.ivpq, eng.params
    ph, stats = eng.prepared_targets["t100k"], eng.statistics["t100k"]
    saved = {f: getattr(p, f) for f in (
        "alpha", "pvf", "method", "confidence", "long_codes_threshold",
        "statistics_table", "pq_lut_dtype", "use_targetlist")}
    eager = IVPQIndex(ivpq.coarse, ivpq.codebook, ivpq.codes, ivpq.cell_of)
    eager._round_graphs = off = RoundGraphs(engages=lambda x: False)
    gen = torch.Generator().manual_seed(SEED + 18)
    sets = [[words[i] for i in torch.randint(0, len(words), (GRAPH_WORDS,),
                                             generator=gen).tolist()]
            for _ in range(GRAPH_SETS)]
    out = {}
    for name, alpha, threshold, kernel in GRAPH_SHAPES:
        p.alpha, p.pvf, p.method, p.confidence = alpha, 20, PQ_PV_CALC, 0.8
        p.long_codes_threshold, p.statistics_table = threshold, "t100k"
        p.pq_lut_dtype, p.use_targetlist = "bf16", True
        graphs = ivpq._round_graphs = RoundGraphs()

        def statements(n_pass):
            rows, ms = [], []
            for _ in range(n_pass):
                rows, ms = [], []
                for ws in sets:
                    t0 = time.perf_counter()
                    rows.append(eng.knn_in_ivpq_batch(ws, JOIN_K, "t100k"))
                    ms.append((time.perf_counter() - t0) * 1e3)
            return rows, ms

        ivpq._round_graphs = off
        want_rows, eager_ms = statements(2)
        ivpq._round_graphs = graphs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        got_rows, graph_ms = statements(4)
        res = GLOBAL_TRACKER.get_results()
        warm = res["join_graph_rounds"][-GRAPH_SETS:]
        check(got_rows == want_rows, f"[18] {name}: replayed rows differ "
              "from the eager round's")
        check(warm == [1.0] * GRAPH_SETS, f"[18] {name}: a warm statement "
              f"ran eager: join_graph_rounds {warm}")
        check(res["join_host_reads"][-GRAPH_SETS:] == [5.0] * GRAPH_SETS,
              f"[18] {name}: join_host_reads "
              f"{res['join_host_reads'][-GRAPH_SETS:]}")
        peak_gib = (torch.cuda.max_memory_allocated() - base_alloc) / 2**30
        sizes = set()
        for ws in sets:
            q = eng._query_matrix(ws)
            one = []
            for index in (ivpq, eager):
                kernels.reset_launch_counts()
                d, i, info = index.search_join(
                    q, JOIN_K, prepared=ph, statistics=stats, alpha=alpha,
                    pvf=20, method=PQ_PV_CALC, confidence=0.8,
                    long_codes_threshold=threshold, return_info=True)
                torch.cuda.synchronize()
                one.append((d, i, info, kernels.launch_counts()))
            (d, i, info, n), (d0, i0, info0, n0) = one
            check(torch.equal(d, d0) and torch.equal(i, i0)
                  and torch.equal(info["retrieved"], info0["retrieved"])
                  and torch.equal(info["target_count"],
                                  info0["target_count"])
                  and info["scan_slots"] == info0["scan_slots"],
                  f"[18] {name}: the replayed round differs from eager")
            check(info["graph_rounds"] == 1.0 and n == n0 and n[kernel] == 2,
                  f"[18] {name}: launches replayed {n}, eager {n0}")
            sizes.add(int(info["scan_slots"]) // ph.block_t)
        held, captures = len(graphs), graphs.captures
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with_graphs = torch.cuda.memory_reserved()
        graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        pinned_mib = (with_graphs - torch.cuda.memory_reserved()) / 2**20
        out[name] = {
            "p": sorted(sizes), "graphs_held": held, "captures": captures,
            "pool_pinned_mib": round(pinned_mib, 1),
            "peak_above_base_gib": round(peak_gib, 3),
            "eager_ms_p50": round(p50(eager_ms), 3),
            "replayed_ms_p50": round(p50(graph_ms), 3)}
        log(f"[18] {name}: {GRAPH_SETS} statements of {GRAPH_WORDS} words, "
            f"P {sorted(sizes)}, {held} graphs held ({captures} captures), "
            f"pool pins {pinned_mib:.1f} MiB, peak {peak_gib:.3f} GiB above "
            f"the engine; facade ms a statement p50 eager "
            f"{p50(eager_ms):.2f}, replayed {p50(graph_ms):.2f} on {card}")
    for f, v in saved.items():
        setattr(p, f, v)
    ivpq._round_graphs = RoundGraphs()
    return out


def engine_phases(torch, args) -> dict:
    """Phases 1-13 on the phase-4 engine → the numbers the summary lines
    print, the launches of each path, and the head of the phase-4 store
    (OFFLINE_N words and rows, on the host) for phase 14. Returning drops
    the engine and its tables."""
    from postgres_word2vec_tpu_torch import ExactIndex, Freddy, VectorStore
    from postgres_word2vec_tpu_torch.evaluation import synth
    from postgres_word2vec_tpu_torch.models import ivfadc as ivfadc_mod
    from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
    from postgres_word2vec_tpu_torch.models.exact import exact_top_k_precast
    from postgres_word2vec_tpu_torch.evaluation.bounds import (
        bound, smem_bytes_per_s)
    from postgres_word2vec_tpu_torch.ops import _build, kernels, lut

    # ---------------------------------------------------------------- 1
    card = gpu_line()
    log(card)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} "
        f"hopper {kernels.supports_hopper()}")
    check(kernels.supports_hopper(), "device is not compute capability 9.x")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    built = _build.build()
    _build.load()
    log(f"[2] kernels built in {built.seconds:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with load): {built.path.name}")
    if built.compiler_output:
        regs = ptxas_report(built.compiler_output, (
            "adc_scan_kernel", "adc_scan_int8_kernel",
            "adc_scan_binned_kernel", "adc_scan_binned_int8_kernel",
            "budget_exact_grouped_kernel", "budget_adc_kernel",
            "budget_adc_grouped_int8_kernel", "budget_adc_grouped_kernel",
            "budget_exact_kernel", "budget_pair_count_kernel",
            "budget_pair_place_kernel"), int16=("budget_adc_grouped_kernel",))
        # (K7's int16 instantiation spilled at ptxas's own cap of 64
        # registers until its launch bounds asked for two blocks an SM)
        log("[2] ptxas, uint8 codes (K7 int16 too): " + ", ".join(
            f"{n} {r} regs {sp} spill bytes" for n, r, sp in regs))
        for want in ("adc_scan_binned_int8_kernel<",
                     "budget_exact_grouped_kernel<3>", "budget_adc_kernel<",
                     "budget_adc_grouped_int8_kernel<packed>",
                     "budget_adc_grouped_kernel<32,1>",
                     "budget_adc_grouped_kernel<32,4>",
                     "budget_adc_grouped_kernel<32,1,int16>",
                     "budget_adc_grouped_kernel<0,1,int16>",
                     "budget_adc_grouped_kernel<0,4,int16>",
                     "budget_exact_kernel<2>", "budget_pair_count_kernel",
                     "budget_pair_place_kernel"):
            check(any(n.startswith(want) for n, _, _ in regs),
                  f"ptxas reported no {want}")
        check(all(sp == 0 for _, _, sp in regs),
              "a walk kernel, K6-K10 or the pair layout spills registers")

    # ---------------------------------------------------------- 3a: edges
    boundary_checks(torch, kernels)
    budget_boundary_checks(torch, kernels)
    int8_boundary_checks(torch, kernels)

    # ------------------------------------------------- 4 (set-up): data
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    V = synth.generate_wordlike(gen, N, D)
    words = [f"w{i}" for i in range(N)]
    store = VectorStore.from_arrays(words, V, normalized=True)
    torch.cuda.synchronize()
    log(f"[4] data {N}x{D} generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = Freddy.build(store, seed=SEED, with_ivfadc=True, with_ivpq=True,
                       **PROBE_BUILD, **BUILD)
    torch.cuda.synchronize()
    log(f"[4] Freddy.build (OPQ 12x256, IVFADC 12x256 / 1000 cells, IVPQ "
        f"30x32 / 1024 flat cells) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tiled = eng.ivfadc.tiled()
    ph100k = eng.prepare_targets(torch.arange(JOIN_T, device=dev),
                                 name="t100k")
    torch.cuda.synchronize()
    log(f"[4] IVFADC tiles (block_t {tiled.block_t}, avg "
        f"{tiled.avg_tile_cnt:.2f} max {tiled.max_tile_cnt} per cell) and "
        f"prepare_targets({JOIN_T}) in {time.perf_counter() - t0:.1f} s")
    fused = ExactIndex(store.vectors_norm, "bfloat16", approx=True,
                       fused=True)
    q256 = store.vectors_norm[:EVAL_Q]
    q1024 = store.vectors_norm[:FUSED_B]
    qwords = words[:EVAL_Q]
    jwords = words[N - JOIN_Q:]
    qjoin = store.vectors_norm[N - JOIN_Q:]
    stats_all = None                        # whole store: uniform statistics

    # -------------------------------------------- 3b: main-path shapes
    pq = eng.pq
    luts = lut.build_luts(pq._rotate(q256), pq.codebook.centroids)
    codes_t = pq.transposed_codes()
    errs = {}
    dense = kernels.adc_scan_plain(luts, codes_t)
    got = kernels.adc_scan(luts, codes_t)
    errs["adc_scan"] = float((got - dense).abs().max())
    check(torch.equal(got, dense), f"adc_scan main path: differs from the "
          f"plain version, max abs err {errs['adc_scan']}")
    del got
    mins, ids = kernels.adc_scan_binned(luts, codes_t)
    ref, ref_ids = kernels.adc_scan_binned_plain(luts, codes_t)
    check(torch.equal(ids, ref_ids), "adc_scan_binned main path: ids differ "
          "from the plain version")
    errs["adc_scan_binned"] = kernels.verify_binned(
        mins, ids, ref, lambda i: torch.gather(dense, 1, i), block_n=2048,
        bins=128, valid_n=N, atol=TOL["adc_scan_binned"])
    del dense, mins, ids, ref, ref_ids
    # K3/K5 at the same shape, over the same LUTs quantized to int8
    ql, sc = kernels.quantize_luts_int8(luts)
    dense = kernels.adc_scan_plain(ql, codes_t, scale=sc)
    errs["adc_scan_int8"] = float((kernels.adc_scan_int8(ql, sc, codes_t)
                                   - dense).abs().max())
    check(errs["adc_scan_int8"] <= TOL["adc_scan_int8"],
          f"adc_scan_int8 main path: err {errs['adc_scan_int8']}")
    mins, ids = kernels.adc_scan_binned_int8(ql, sc, codes_t)
    ref, ref_ids = kernels.adc_scan_binned_plain(ql, codes_t, scale=sc)
    check(torch.equal(ids, ref_ids), "adc_scan_binned_int8 main path: ids "
          "differ from the plain version")
    errs["adc_scan_binned_int8"] = kernels.verify_binned(
        mins, ids, ref, lambda i: torch.gather(dense, 1, i), block_n=2048,
        bins=128, valid_n=N, atol=TOL["adc_scan_binned_int8"])
    del dense, mins, ids, ref, ref_ids
    qb = kernels.pad_queries(q1024, fused._tiled.shape[1])
    mins, ids = kernels.fused_exact_scan(qb, fused._tiled,
                                         fused._tiled_norms)
    ref, _ = kernels.fused_exact_scan_plain(qb, fused._tiled,
                                            fused._tiled_norms)

    def fused_score_at(i):
        out = torch.empty(i.shape, device=dev)
        for s in range(0, i.shape[0], 16):
            rows = fused._tiled[i[s:s + 16]].float()      # (16, W, Dp)
            out[s:s + 16] = (fused._tiled_norms[i[s:s + 16]] - 2.0
                             * torch.einsum("bwd,bd->bw", rows,
                                            qb[s:s + 16].float()))
        return out

    errs["fused_exact_scan"] = kernels.verify_binned(
        mins, ids, ref, fused_score_at, block_n=8192, bins=128, valid_n=N,
        atol=TOL["fused_exact_scan"])
    del mins, ids, ref

    # the budget kernels at the shapes their paths give them
    ivf = eng.ivfadc
    p_ivf = ivf._auto_budget(3, None, full=True)
    _, _, tiles_ivf, _ = ivfadc_mod.probe_plan(
        q256, ivf.coarse.centroids, tiled, 0, 3, p_ivf)
    luts_ivf = lut.build_luts(q256, ivf.codebook.centroids)
    ivpq = eng.ivpq
    stats100k = None

    def join_plan(jt, qs, alpha, stats):
        """The served budget round's plan: its selections' tiles, P fitted
        to the largest (``IVPQIndex._budget_for``)."""
        st = ivpq_mod.uniform_statistics(ivpq.coarse.cell_counts) \
            if stats is None else stats
        start, cnt, *_ = ivpq_mod.select_tiles(
            qs, ivpq.coarse.centroids, st, jt, JOIN_K, alpha, 0.8)
        p = ivpq._budget_for(jt, None, lambda: ivpq_mod.budget_need([cnt]))
        tiles, _ = ivfadc_mod.plan_probe_tiles(p, start, cnt, jt.inf_tile)
        return tiles

    eng.create_statistics("t100k", words[:JOIN_T])
    stats100k = eng.statistics["t100k"]
    jt100 = ph100k.tiles(with_vecs=False)
    jt100v = ph100k.tiles(with_vecs=True)
    qj = qjoin[:512]
    luts_join = lut.build_luts(qj, ivpq.codebook.centroids)
    ql_join, sc_join = kernels.quantize_luts_int8(luts_join)
    tiles_j = join_plan(jt100, qj, 200, stats100k)
    tiles_jv = join_plan(jt100v, qj, 200, stats100k)
    tiles_1 = join_plan(jt100v, q256[7:8], 200, stats100k)
    shapes = {
        "budget_adc": (
            lambda: kernels.budget_adc(luts_ivf, tiled.codes_t,
                                       tiled.rowterm, tiles_ivf,
                                       block_t=tiled.block_t),
            lambda: kernels.budget_adc_plain(luts_ivf, tiled.codes_t,
                                             tiled.rowterm, tiles_ivf,
                                             block_t=tiled.block_t),
            f"IVFADC B={EVAL_Q} P={p_ivf} block_t={tiled.block_t} 12x256"),
        "budget_adc_grouped": (
            lambda: kernels.budget_adc_grouped(
                luts_join, jt100.codes_t, jt100.rowterm, tiles_j,
                block_t=jt100.block_t, rows=32),
            lambda: kernels.budget_adc_plain(
                luts_join, jt100.codes_t, jt100.rowterm, tiles_j,
                block_t=jt100.block_t),
            f"join 100k B=512 P={tiles_j.shape[1]} block_t=256 30x32"),
        "budget_exact": (
            lambda: kernels.budget_exact(q256[7:8], jt100v.vecs,
                                         jt100v.rownorm, tiles_1,
                                         block_t=jt100v.block_t),
            lambda: kernels.budget_exact_plain(q256[7:8], jt100v.vecs,
                                               jt100v.rownorm, tiles_1,
                                               block_t=jt100v.block_t),
            f"single query B=1 P={tiles_1.shape[1]} block_t=256 d=300"),
        "budget_exact_grouped": (
            lambda: kernels.budget_exact_grouped(
                qj, jt100v.vecs, jt100v.rownorm, tiles_jv,
                block_t=jt100v.block_t, rows=32),
            lambda: kernels.budget_exact_plain(
                qj, jt100v.vecs, jt100v.rownorm, tiles_jv,
                block_t=jt100v.block_t),
            f"join 100k method 1 B=512 P={tiles_jv.shape[1]} d=300"),
        "budget_adc_grouped_int8": (
            lambda: kernels.budget_adc_grouped_int8(
                ql_join, sc_join, jt100.codes_t, jt100.rowterm, tiles_j,
                block_t=jt100.block_t, rows=32),
            lambda: kernels.budget_adc_plain(
                ql_join, jt100.codes_t, jt100.rowterm, tiles_j,
                block_t=jt100.block_t, scale=sc_join),
            f"join 100k int8 B=512 P={tiles_j.shape[1]} block_t=256 30x32"),
    }
    for name, (kfn, pfn, what) in shapes.items():
        errs[name] = budget_err(torch, kfn(), pfn(), name, what)
    # and K6 at the 3M join's shape, K9 at a batch
    ph_all = eng.prepare_targets(torch.arange(N, device=dev), name="all")
    jt_all = ph_all.tiles(with_vecs=False)
    tiles_3m = join_plan(jt_all, qj, 600, stats_all)
    errs["budget_adc"] = max(errs["budget_adc"], budget_err(
        torch, kernels.budget_adc(luts_join, jt_all.codes_t, jt_all.rowterm,
                                  tiles_3m, block_t=jt_all.block_t),
        kernels.budget_adc_plain(luts_join, jt_all.codes_t, jt_all.rowterm,
                                 tiles_3m, block_t=jt_all.block_t),
        "budget_adc", "join 3M B=512"))
    # K6 over fused-pair int16 codes at the short-codes join's shape
    # (set_long_codes_threshold(0), alpha = |targets| / (2k) = 10,000):
    # 15 x 1024 float32 LUTs a query, P near 600 tiles of 256 rows
    luts_short = lut.build_double_luts(luts_join)
    codes_short = jt100.fused_codes_t(ivpq.codebook.centroids.shape[1])
    tiles_short = join_plan(jt100, qj, 10_000, stats100k)
    errs["budget_adc"] = max(errs["budget_adc"], budget_err(
        torch, kernels.budget_adc(luts_short, codes_short, jt100.rowterm,
                                  tiles_short, block_t=jt100.block_t),
        kernels.budget_adc_plain(luts_short, codes_short, jt100.rowterm,
                                 tiles_short, block_t=jt100.block_t),
        "budget_adc", f"short-codes join 100k B=512 "
        f"P={tiles_short.shape[1]} 15x1024 int16"))
    del luts_short, tiles_short
    errs["budget_exact"] = max(errs["budget_exact"], budget_err(
        torch, kernels.budget_exact(qj, jt100v.vecs, jt100v.rownorm,
                                    tiles_jv, block_t=jt100v.block_t),
        kernels.budget_exact_plain(qj, jt100v.vecs, jt100v.rownorm, tiles_jv,
                                   block_t=jt100v.block_t),
        "budget_exact", "join 100k B=512"))
    torch.cuda.synchronize()
    log("[3] main-path shapes agree: " + ", ".join(
        f"{k} max_abs_err {v:.3g} (tol {TOL[k]})" for k, v in errs.items()))
    # K7's pair layout at the 100k join's plan against the plain layout (the
    # same tile per group, the same real slots, every pair once), and the
    # device kernels one K7 and one K9 wrapper call launch
    nt_j = jt100.codes_t.shape[1] // jt100.block_t
    pairs_7, tog_7 = kernels.budget_pair_layout(tiles_j, nt_j, 32)
    want_pairs, want_tog = kernels.budget_pair_layout_plain(tiles_j, nt_j, 32)
    real = pairs_7 >= 0
    check(torch.equal(tog_7, want_tog) and torch.equal(real, want_pairs >= 0)
          and torch.equal(torch.sort(pairs_7[real]).values,
                          torch.arange(tiles_j.numel(), dtype=torch.int32,
                                       device=dev)),
          "the pair layout breaks its contract at the 100k join's plan")
    del want_pairs, want_tog, real
    wrapper_kernels = {name: device_kernels(torch, shapes[name][0])
                       for name in ("budget_adc_grouped", "budget_exact")}
    check(sorted(wrapper_kernels["budget_adc_grouped"]) == [
        "budget_adc_grouped_kernel", "budget_pair_count_kernel",
        "budget_pair_place_kernel"],
        f"a K7 wrapper call launched {wrapper_kernels['budget_adc_grouped']}"
        f", not the pair layout's two kernels and K7 once each")
    check(wrapper_kernels["budget_exact"] == ["budget_exact_kernel"],
          f"a K9 wrapper call launched {wrapper_kernels['budget_exact']}")
    log(f"[3] pair layout at the 100k join's plan holds its contract; device "
        f"kernels per wrapper call: {wrapper_kernels}")

    # ------------------------------------------------------ 4: the paths
    _, gt = eng.exact.search(q1024, K)        # float32 exact ground truth
    gt256 = gt[:EVAL_Q]
    gt_join = eng.exact.search_in(qjoin[:EVAL_Q], K, ph100k.target_ids)[1]
    gt_3m = eng.exact.search(qjoin[:EVAL_Q], K)[1]
    path_launches: dict[str, dict[str, int]] = {}

    def run_path(name, fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        path_launches[name] = {k: v for k, v in
                               kernels.launch_counts().items() if v}
        return out

    def slice1():
        res = eng.knn(qwords[0], K)
        check(len(res) == K and res[0][0] == qwords[0]
              and abs(res[0][1] - 1.0) < 1e-4,
              f"exact knn of {qwords[0]} does not return itself first: "
              f"{res[:2]}")
        rows = eng.knn_batch_exact(qwords, K)
        check(len(rows) == EVAL_Q * K, "knn_batch_exact row count")
        eng.set_knn_function("k_nearest_neighbour_pq")
        res = eng.knn(qwords[0], K)
        check(len(res) == K, "pq knn result length")
        _, ids_pq = eng.knn_matrix(q256, K)
        check(kernels.KERNELS["adc_scan"].launches > 0,
              "PQ knn did not launch adc_scan")
        eng.set_knn_function("k_nearest_neighbour_pq_pv")
        d_pv, ids_pv = eng.knn_matrix(q256, K)
        check(kernels.KERNELS["adc_scan_binned"].launches > 0,
              "PQ-PV knn did not launch adc_scan_binned")
        d_fx, ids_fx = fused.search(q1024, K)
        check(kernels.KERNELS["fused_exact_scan"].launches > 0,
              "fused exact search did not launch fused_exact_scan")
        return ids_pq, d_pv, ids_pv, d_fx, ids_fx

    ids_pq, d_pv, ids_pv, d_fx, ids_fx = run_path("knn_slice1", slice1)
    for t in (d_pv, d_fx):
        check(bool(torch.isfinite(t).all()), "non-finite distances")
    rec = {"pq@5": recall_at(ids_pq, gt256, 5),
           "pq@10": recall_at(ids_pq, gt256, 10),
           "pq_pv@5": recall_at(ids_pv, gt256, 5),
           "pq_pv@10": recall_at(ids_pv, gt256, 10),
           "fused@5": recall_at(ids_fx, gt, 5),
           "fused@10": recall_at(ids_fx, gt, 10)}

    # slice 2: IVFADC
    eng.set_w(3)
    eng.set_pvf(20)
    rows = run_path("ivfadc_knn_batch", lambda: eng.knn_batch(qwords, K))
    check(len(rows) >= EVAL_Q * K // 2 and all(
        -1.0 <= s <= 1.0 + 1e-4 for _, _, s in rows), "IVFADC batch rows")
    ids_ivf = rows_to_ids(torch, store, rows, qwords, K)
    eng.set_knn_function("k_nearest_neighbour_ivfadc_pv")
    d_ivpv, ids_ivpv = run_path("ivfadc_pv20_knn_matrix",
                                lambda: eng.knn_matrix(q256, K))
    check(bool(torch.isfinite(d_ivpv).all()), "IVFADC-PV distances")
    rec.update({"ivfadc@5": recall_at(ids_ivf, gt256, 5),
                "ivfadc@10": recall_at(ids_ivf, gt256, 10),
                "ivfadc_pv20@5": recall_at(ids_ivpv, gt256, 5),
                "ivfadc_pv20@10": recall_at(ids_ivpv, gt256, 10)})

    # slice 2: the kNN-join at 100k prepared targets, statistics active
    eng.set_statistics_table("t100k")
    eng.set_alpha(200)
    eng.set_confidence_value(0.8)

    def join(name, method, targets, k=JOIN_K, qw=jwords):
        eng.set_method_flag(method)
        rows = eng.knn_in_ivpq_batch(qw, k, targets)
        check(len(rows) >= len(qw) * k * 9 // 10 and all(
            -1.0 - 1e-3 <= s <= 1.0 + 1e-3 for _, _, s in rows),
            f"{name}: join rows")
        return rows_to_ids(torch, store, rows, qw[:EVAL_Q], k)

    for method in (0, 2, 1):
        name = f"join_m{method}_a200"
        ids5 = run_path(name, lambda m=method: join(name, m, "t100k"))
        ids10 = join(name, method, "t100k", k=K, qw=jwords[:EVAL_Q])
        rec[f"{name}@5"] = recall_at(ids5, gt_join, 5)
        rec[f"{name}@10"] = recall_at(ids10, gt_join, 10)
    eng.set_method_flag(0)
    res0 = run_path("knn_in_ivpq_single_m0",
                    lambda: eng.knn_in_ivpq("w7", JOIN_K, "t100k"))
    check(len(res0) == JOIN_K and "w7" in [w for w, _ in res0],
          f"knn_in_ivpq method 0 misses its own word: {res0}")
    eng.set_method_flag(1)
    res1 = run_path("knn_in_ivpq_single_m1",
                    lambda: eng.knn_in_ivpq("w7", JOIN_K, "t100k"))
    check(res1[0][0] == "w7" and abs(res1[0][1] - 1.0) < 1e-2,
          f"knn_in_ivpq method 1 does not return its word first: {res1}")

    # slice 2: the join over the whole store
    eng.set_statistics_table(None)
    eng.set_alpha(600)
    ids5 = run_path("join_3M_m2_a600", lambda: join("join_3M", 2, "all"))
    ids10 = join("join_3M", 2, "all", k=K, qw=jwords[:EVAL_Q])
    rec["join_3M_m2_a600@5"] = recall_at(ids5, gt_3m, 5)
    rec["join_3M_m2_a600@10"] = recall_at(ids10, gt_3m, 10)

    # slice 3: the int8 configuration
    eng.set_pq_lut_dtype("int8")
    eng.set_knn_function("k_nearest_neighbour_pq")
    _, ids_pq8 = run_path("pq_int8_knn_matrix",
                          lambda: eng.knn_matrix(q256, K))
    check(path_launches["pq_int8_knn_matrix"].get("adc_scan_int8", 0) > 0,
          "int8 PQ knn did not launch adc_scan_int8")
    eng.set_knn_function("k_nearest_neighbour_pq_pv")
    d_pv8, ids_pv8 = run_path("pq_int8_pv20_knn_matrix",
                              lambda: eng.knn_matrix(q256, K))
    check(path_launches["pq_int8_pv20_knn_matrix"].get(
        "adc_scan_binned_int8", 0) > 0,
        "int8 PQ-PV knn did not launch adc_scan_binned_int8")
    check(bool(torch.isfinite(d_pv8).all()), "int8 PQ-PV distances")
    rec.update({"pq_int8@5": recall_at(ids_pq8, gt256, 5),
                "pq_int8@10": recall_at(ids_pq8, gt256, 10),
                "pq_int8_pv20@5": recall_at(ids_pv8, gt256, 5),
                "pq_int8_pv20@10": recall_at(ids_pv8, gt256, 10)})
    eng.set_statistics_table("t100k")
    eng.set_alpha(200)
    for method in (0, 2):
        name = f"join_int8_m{method}_a200"
        ids5 = run_path(name, lambda m=method: join(name, m, "t100k"))
        check(path_launches[name].get("budget_adc_grouped_int8", 0) > 0,
              f"{name} did not launch budget_adc_grouped_int8")
        ids10 = join(name, method, "t100k", k=K, qw=jwords[:EVAL_Q])
        rec[f"{name}@5"] = recall_at(ids5, gt_join, 5)
        rec[f"{name}@10"] = recall_at(ids10, gt_join, 10)
    eng.set_statistics_table(None)
    eng.set_alpha(600)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ids5 = run_path("join_int8_3M_m2_a600",
                        lambda: join("join_int8_3M", 2, "all"))
    check(any("no int8 variant" in str(w.message) for w in caught),
          "the int8 join over 3M did not warn that it keeps float LUTs")
    check(path_launches["join_int8_3M_m2_a600"].get("budget_adc", 0) > 0,
          "the int8 join over 3M did not keep the per-query kernel")
    rec["join_int8_3M_m2_a600@5"] = recall_at(ids5, gt_3m, 5)
    eng.set_pq_lut_dtype("bf16")
    t0 = time.perf_counter()
    exact8 = ExactIndex(store.vectors_norm, "int8")
    torch.cuda.synchronize()
    log(f"[4] int8 exact index built in {time.perf_counter() - t0:.2f} s")
    _, ids_x8 = run_path("exact_int8_b256", lambda: exact8.search(q256, K))
    rec.update({"exact_int8@5": recall_at(ids_x8, gt256, 5),
                "exact_int8@10": recall_at(ids_x8, gt256, 10)})

    def tally():
        launches = {name: 0 for name in kernels.KERNELS}
        for counts in path_launches.values():
            for name, v in counts.items():
                launches[name] += v
        return launches

    launches = tally()
    for name, counts in path_launches.items():
        log(f"[4] path {name} launched {counts}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the paths was not launched: {launches}")
    log("[4] recall vs float32 exact: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec.items()))
    for name, floor in FLOORS.items():
        check(rec[name] >= floor, f"{name} {rec[name]:.4f} < floor {floor}")
    for name, ref in INT8_DROP.items():
        check(rec[name] >= rec[ref] - INT8_MAX_DROP,
              f"{name} {rec[name]:.4f} is more than {INT8_MAX_DROP} below "
              f"{ref} {rec[ref]:.4f}")

    # ---------------------------------------------------------- 5: times
    kernel_ms, plain_ms = {}, {}
    pairs = {
        "adc_scan": (lambda: kernels.adc_scan(luts, codes_t),
                     lambda: kernels.adc_scan_plain(luts, codes_t)),
        "adc_scan_binned": (
            lambda: kernels.adc_scan_binned(luts, codes_t),
            lambda: kernels.adc_scan_binned_plain(luts, codes_t)),
        "fused_exact_scan": (
            lambda: kernels.fused_exact_scan(qb, fused._tiled,
                                             fused._tiled_norms),
            lambda: kernels.fused_exact_scan_plain(qb, fused._tiled,
                                                   fused._tiled_norms)),
        "adc_scan_int8": (
            lambda: kernels.adc_scan_int8(ql, sc, codes_t),
            lambda: kernels.adc_scan_plain(ql, codes_t, scale=sc)),
        "adc_scan_binned_int8": (
            lambda: kernels.adc_scan_binned_int8(ql, sc, codes_t),
            lambda: kernels.adc_scan_binned_plain(ql, codes_t, scale=sc)),
        **{name: (kfn, pfn) for name, (kfn, pfn, _) in shapes.items()},
    }

    # Each kernel's bound at these shapes: its inputs read once and its
    # outputs written once; the budget kernels read only the distinct tiles
    # they probe. Operations count what the data needs: d = 300 columns
    # and the N real rows for the exact products, m adds per ADC sum. The
    # walk kernels K2-K5 also make B*N*m lookups in shared memory, 4 bytes
    # each for float LUTs and 1 for int8 ones, and the ADC budget kernels
    # K6-K8 one per (query, tile) pair, row and subspace, not counting the
    # pairs on the inf tile (a plan's padding), which need no sum.
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def probe_bytes(tiles, block_t, row_bytes, *inputs):
        return (nbytes(tiles, *inputs) + tiles.numel() * block_t * 4
                + int(torch.unique(tiles).numel()) * block_t * row_bytes)

    adc_ops = EVAL_Q * N * luts.shape[1]
    shared_rate = smem_bytes_per_s()
    dense_out = EVAL_Q * N * 4
    binned_out = EVAL_Q * -(-N // 2048) * 128 * 8
    fx_out = FUSED_B * fused._tiled.shape[0] // 8192 * 128 * 8
    ivf_row = tiled.codes_t.shape[0] * tiled.codes_t.element_size() + 4
    join_row = jt100.codes_t.shape[0] * jt100.codes_t.element_size() + 4
    vec_row = jt100v.vecs.shape[1] * 2 + 4

    def adc_probe_ops(tiles, jt, m):
        real = int((tiles != jt.codes_t.shape[1] // jt.block_t - 1).sum())
        return real * jt.block_t * m

    join_ops = adc_probe_ops(tiles_j, jt100, luts_join.shape[1])
    ivf_ops = adc_probe_ops(tiles_ivf, tiled, luts_ivf.shape[1])
    work = {
        "adc_scan": (nbytes(luts, codes_t) + dense_out, adc_ops, "fp32",
                     4 * adc_ops),
        "adc_scan_binned": (nbytes(luts, codes_t) + binned_out, adc_ops,
                            "fp32", 4 * adc_ops),
        "fused_exact_scan": (
            nbytes(qb, fused._tiled, fused._tiled_norms) + fx_out,
            2 * FUSED_B * N * D, "bf16"),
        "adc_scan_int8": (nbytes(ql, sc, codes_t) + dense_out, adc_ops,
                          "fp32", adc_ops),
        "adc_scan_binned_int8": (nbytes(ql, sc, codes_t) + binned_out,
                                 adc_ops, "fp32", adc_ops),
        "budget_adc": (
            probe_bytes(tiles_ivf, tiled.block_t, ivf_row, luts_ivf),
            ivf_ops, "fp32", 4 * ivf_ops),
        "budget_adc_grouped": (
            probe_bytes(tiles_j, jt100.block_t, join_row, luts_join),
            join_ops, "fp32", 4 * join_ops),
        "budget_adc_grouped_int8": (
            probe_bytes(tiles_j, jt100.block_t, join_row, ql_join, sc_join),
            join_ops, "fp32", join_ops),
        "budget_exact": (
            probe_bytes(tiles_1, jt100v.block_t, vec_row, q256[7:8]),
            2 * tiles_1.numel() * jt100v.block_t * D, "fp32"),
        # three bf16 products per query value on the tensor cores
        "budget_exact_grouped": (
            probe_bytes(tiles_jv, jt100v.block_t, vec_row, qj),
            3 * 2 * tiles_jv.numel() * jt100v.block_t * D, "bf16"),
    }
    bounds = {name: bound(*w, shared_rate=shared_rate)
              for name, w in work.items()}
    log(f"[5] shared-memory rate {shared_rate / 1e12:.2f} TB/s (128 B per "
        f"clock per SM at the max SM clock) on {card}")
    for name, (kfn, pfn) in pairs.items():
        pl1, kt, kt2, pl2 = (cuda_ms(torch, pfn, reps=3),
                             cuda_ms(torch, kfn, reps=3),
                             cuda_ms(torch, kfn, reps=3),
                             cuda_ms(torch, pfn, reps=3))
        kernel_ms[name], plain_ms[name] = p50(kt + kt2), p50(pl1 + pl2)
        log(f"[5] kernel {name}: {kernel_ms[name]:.3f} ms, plain "
            f"{plain_ms[name]:.3f} ms per call (p50 of 6, plain-kernel-"
            f"kernel-plain), bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}, {bounds[name][2]}) on {card}")
    # K1's yardstick, never called by the port: one bf16 matmul of the
    # same (B, D) x (D, N_pad) product, without the bin reduction
    library_ms = {name: None for name in kernels.KERNELS}
    library_ms["fused_exact_scan"] = p50(cuda_ms(
        torch, lambda: torch.matmul(qb, fused._tiled.t()), reps=3))
    log(f"[5] library for fused_exact_scan: bf16 torch.matmul "
        f"{tuple(qb.shape)} x {tuple(fused._tiled.t().shape)} "
        f"{library_ms['fused_exact_scan']:.3f} ms on {card}")
    # K2's yardstick, never called by the port: one F.embedding_bag summing,
    # for each row, the m rows j·k + code_j of the (m·k, B) LUT table (the
    # table and the index made beforehand, not timed)
    emb_w = luts.reshape(EVAL_Q, -1).t().contiguous()
    emb_idx = codes_t.t().long() + torch.arange(
        luts.shape[1], device=dev) * luts.shape[2]
    emb = torch.nn.functional.embedding_bag(emb_idx, emb_w, mode="sum")
    k2_library_err = float((emb.t() - kernels.adc_scan(luts, codes_t))
                           .abs().max())
    del emb
    library_ms["adc_scan"] = p50(cuda_ms(
        torch, lambda: torch.nn.functional.embedding_bag(emb_idx, emb_w,
                                                         mode="sum"),
        reps=3))
    log(f"[5] library for adc_scan: F.embedding_bag {tuple(emb_idx.shape)} "
        f"over {tuple(emb_w.shape)} {library_ms['adc_scan']:.3f} ms, max abs "
        f"diff from K2 {k2_library_err:.3g} on {card}")
    # K3's yardstick, never called by the port: the same F.embedding_bag
    # over the int8 LUTs cast to float32 (the integer sums are exact in
    # float32), then times each query's scale, as K3 rescales once
    emb_w = ql.float().reshape(EVAL_Q, -1).t().contiguous()

    def k3_library():
        return torch.nn.functional.embedding_bag(emb_idx, emb_w,
                                                 mode="sum") * sc
    k3_library_err = float((k3_library().t() - kernels.adc_scan_int8(
        ql, sc, codes_t)).abs().max())
    library_ms["adc_scan_int8"] = p50(cuda_ms(torch, k3_library, reps=3))
    log(f"[5] library for adc_scan_int8: F.embedding_bag "
        f"{tuple(emb_idx.shape)} over the int8 LUTs as float32 "
        f"{tuple(emb_w.shape)}, times the scale, "
        f"{library_ms['adc_scan_int8']:.3f} ms, max abs diff from K3 "
        f"{k3_library_err:.3g} on {card}")
    del emb_w, emb_idx
    # K10's yardstick, never called by the port: one bf16 torch.bmm of the
    # groups' (rows, D) x (D, block_t) products over the join's real groups,
    # queries and tiles gathered beforehand (not timed); no row norms
    nt_v = jt100v.vecs.shape[0] // jt100v.block_t
    qidx_j, tog_j, _ = kernels._grouped_layout(tiles_jv.to(torch.int32),
                                               nt_v, 32)
    real = qidx_j[:, 0] < qj.shape[0]
    q_g = kernels.pad_queries(qj, jt100v.vecs.shape[1])[
        qidx_j[real].clamp(max=qj.shape[0] - 1).long()]
    t_g = jt100v.vecs.view(nt_v, jt100v.block_t, -1)[
        tog_j[real].clamp(0, nt_v - 1).long()].transpose(1, 2)
    library_ms["budget_exact_grouped"] = p50(cuda_ms(
        torch, lambda: torch.bmm(q_g, t_g), reps=3))
    log(f"[5] library for budget_exact_grouped: bf16 torch.bmm "
        f"{tuple(q_g.shape)} x {tuple(t_g.shape)} "
        f"{library_ms['budget_exact_grouped']:.3f} ms on {card}")
    del q_g, t_g
    # K9's yardstick, never called by the port: one float32 torch.baddbmm,
    # rownorm − 2·v·q over each (query, slot) pair's tile, at the single
    # query (the kernels line) and at the join's method-1 batch (B = 512);
    # rows widened to float32, gathered with their norms and the padded
    # queries beforehand (not timed)
    def k9_library(q, tl):
        nt = jt100v.vecs.shape[0] // jt100v.block_t
        ids = tl.reshape(-1).clamp(0, nt - 1).long()
        v_g = jt100v.vecs.view(nt, jt100v.block_t, -1)[ids].float()
        n_g = jt100v.rownorm.view(nt, jt100v.block_t, 1)[ids]
        q_g = kernels._pad_f32(q, v_g.shape[2])[
            torch.arange(q.shape[0], device=dev).repeat_interleave(
                tl.shape[1])][:, :, None]
        def call():
            return torch.baddbmm(n_g, v_g, q_g, alpha=-2.0)
        got = call().reshape(q.shape[0], -1)
        want = kernels.budget_exact(q, jt100v.vecs, jt100v.rownorm, tl,
                                    block_t=jt100v.block_t)
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)),
              "K9's library call is finite where K9 is not")
        err = float((got - want)[fin].abs().max())
        ms = p50(cuda_ms(torch, call, reps=3))
        log(f"[5] library for budget_exact: float32 torch.baddbmm "
            f"{tuple(v_g.shape)} x {tuple(q_g.shape)} (B={q.shape[0]} "
            f"P={tl.shape[1]}) {ms:.4f} ms, max abs diff from K9 {err:.3g} "
            f"on {card}")
        return ms
    library_ms["budget_exact"] = k9_library(q256[7:8], tiles_1)
    k9_library_batch_ms = k9_library(qj, tiles_jv)
    # The budget ADC kernels' yardstick, never called by the port: one
    # F.embedding_bag summing each (query, slot) pair's row's m LUT entries,
    # LUT id · m·k + j·k + code_j, over the plan's whole (B·P·block_t, m)
    # index made beforehand (not timed); int8 LUTs cast to float32 (exact
    # integer sums) and times the query's scale; the row term is left out
    # of the timed call, as K10's yardstick leaves out the row norms, and
    # added back for the comparison with the kernel. K7 at the 100k join's
    # plan, K6 at its kernels-line shape (the IVFADC batch), K8 at K7's.
    def pair_library(name, lt, jt, tl, kernel_out, scale=None):
        nt = jt.codes_t.shape[1] // jt.block_t
        b, m, k = lt.shape
        flat = tl.reshape(-1).clamp(0, nt - 1).long()
        idx = (jt.codes_t.view(m, nt, jt.block_t)[:, flat].permute(1, 2, 0)
               .long() + torch.arange(m, device=dev) * k
               + (torch.arange(b, device=dev).repeat_interleave(tl.shape[1])
                  * m * k)[:, None, None]).reshape(-1, m)
        w = lt.float().reshape(-1, 1)
        rows_scale = (None if scale is None else scale.repeat_interleave(
            tl.shape[1] * jt.block_t)[:, None])

        def call():
            bag = torch.nn.functional.embedding_bag(idx, w, mode="sum")
            return bag if rows_scale is None else bag * rows_scale
        got = call() + jt.rowterm.view(nt, jt.block_t)[flat].reshape(-1, 1)
        want = kernel_out.reshape(-1, 1)
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)),
              f"{name}'s library call is finite where {name} is not")
        err = float((got - want)[fin].abs().max())
        del got, want, fin
        library_ms[name] = p50(cuda_ms(torch, call, reps=3))
        log(f"[5] library for {name}: F.embedding_bag {tuple(idx.shape)} "
            f"over {tuple(w.shape)}{'' if scale is None else ' times scale'}"
            f" (every pair, the inf tile's too; no row term) "
            f"{library_ms[name]:.4f} ms, max abs diff from the kernel after "
            f"the row term {err:.3g} on {card}")
        return err

    library_err = {
        "budget_adc_grouped": pair_library(
            "budget_adc_grouped", luts_join, jt100, tiles_j,
            kernels.budget_adc_grouped(luts_join, jt100.codes_t,
                                       jt100.rowterm, tiles_j,
                                       block_t=jt100.block_t, rows=32)),
        "budget_adc": pair_library(
            "budget_adc", luts_ivf, tiled, tiles_ivf,
            kernels.budget_adc(luts_ivf, tiled.codes_t, tiled.rowterm,
                               tiles_ivf, block_t=tiled.block_t)),
        "budget_adc_grouped_int8": pair_library(
            "budget_adc_grouped_int8", ql_join, jt100, tiles_j,
            kernels.budget_adc_grouped_int8(ql_join, sc_join, jt100.codes_t,
                                            jt100.rowterm, tiles_j,
                                            block_t=jt100.block_t, rows=32),
            scale=sc_join)}
    # The queries per block of K4, K2, K3 and K5, swept at the main shape
    # through the C entry points that take them (the wrappers let the
    # kernels choose: 16 for K4 and K2, 64 for K3 and K5)
    lib = _build.load()
    sweep_out = kernels.adc_scan_binned(luts, codes_t)
    dense_out = torch.empty(EVAL_Q, N, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    mk = (luts.shape[1], luts.shape[2])

    def k4_at(qblk):
        return lib.pw2v_adc_scan_binned_qb(
            luts.data_ptr(), codes_t.data_ptr(), codes_t.element_size(),
            sweep_out[0].data_ptr(), sweep_out[1].data_ptr(), EVAL_Q, *mk,
            N, 2048, 128, qblk, stream)

    def k2_at(qblk):
        return lib.pw2v_adc_scan_qb(
            luts.data_ptr(), codes_t.data_ptr(), codes_t.element_size(),
            dense_out.data_ptr(), EVAL_Q, *mk, N, qblk, stream)

    def k3_at(qblk):
        return lib.pw2v_adc_scan_int8_qb(
            ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(),
            codes_t.element_size(), dense_out.data_ptr(), EVAL_Q, *mk, N,
            qblk, stream)

    # K10's bf16 parts per query value at the join's shape: 3 is the
    # kernel's (exact); 2 and 1 lose precision and show what a part costs
    q_jv = kernels._pad_f32(qj, jt100v.vecs.shape[1])
    k10_out = torch.empty(qidx_j.numel(), jt100v.block_t, device=dev)

    def k10_at(parts):
        return lib.pw2v_budget_exact_grouped_parts(
            q_jv.data_ptr(), jt100v.vecs.data_ptr(),
            jt100v.rownorm.data_ptr(), qidx_j.data_ptr(), tog_j.data_ptr(),
            k10_out.data_ptr(), qj.shape[0], q_jv.shape[1],
            jt100v.vecs.shape[0], tog_j.shape[0], 32, jt100v.block_t, parts,
            stream)

    def k5_at(qblk):
        return lib.pw2v_adc_scan_binned_int8_qb(
            ql.data_ptr(), sc.data_ptr(), codes_t.data_ptr(),
            codes_t.element_size(), sweep_out[0].data_ptr(),
            sweep_out[1].data_ptr(), EVAL_Q, *mk, N, 2048, 128, qblk, stream)

    sweep = {}
    for name, at, qbs in (("K4", k4_at, (16, 8)), ("K2", k2_at, (16, 8)),
                          ("K3", k3_at, (64, 32)), ("K5", k5_at, (64, 32)),
                          ("K10", k10_at, (3, 2, 1))):
        for qblk in qbs:
            def run(at=at, qblk=qblk):
                err = at(qblk)
                check(err == 0, f"{name} {qblk}: CUDA error {err}")
            key = f"{name} {'parts' if name == 'K10' else 'qb'}={qblk}"
            sweep[key] = p50(cuda_ms(torch, run, reps=5 if name == "K10"
                                     else 3))
    log(f"[5] sweep at B={EVAL_Q}, 12x256 (K10 at the join's method-1 "
        f"shape): " + ", ".join(
        f"{k} {t:.3f} ms" for k, t in sweep.items()) + f" on {card}")
    # K6 through the entry point that takes its slots per block and ring
    # depth (0: the kernel's choice), at the 3M join's shape (10 launches
    # per call there), the IVFADC batch's and the 100k join's (the shape K7
    # and K8 are timed at); K8 through the one that takes its staged width.
    # 20 launches between two events, so a launch's gap is spread thin.
    def per_launch(run, n=20):
        def many():
            for _ in range(n):
                check(run() == 0, "a sweep launch failed")
        return p50(cuda_ms(torch, many, reps=3)) / n

    k6_shapes = {"3M": (luts_join, jt_all, tiles_3m),
                 "ivfadc": (luts_ivf, tiled, tiles_ivf),
                 "100k": (luts_join, jt100, tiles_j)}
    k6_ms = {}
    for shape, (lt, jt, tl) in k6_shapes.items():
        tl = tl.to(torch.int32).contiguous()
        k6_out = torch.empty(tl.shape[0], tl.shape[1] * jt.block_t,
                             device=dev)

        def k6_at(spb, depth, lt=lt, jt=jt, tl=tl, k6_out=k6_out):
            return lib.pw2v_budget_adc_spb(
                lt.data_ptr(), jt.codes_t.data_ptr(),
                jt.codes_t.element_size(), jt.rowterm.data_ptr(),
                tl.data_ptr(), k6_out.data_ptr(), *lt.shape,
                jt.codes_t.shape[1], tl.shape[1], jt.block_t, spb, depth,
                stream)

        k6_ms[shape] = per_launch(lambda: k6_at(0, 0))
        for spb, depth in ((0, 2), (0, 3), (0, 4), (2, 0), (4, 0), (8, 0),
                           (12, 0), (16, 0), (24, 0), (32, 0)):
            if spb <= tl.shape[1]:
                sweep[f"K6 {shape} spb={spb} depth={depth}"] = per_launch(
                    lambda: k6_at(spb, depth))
        del k6_out
    qidx_8, tog_8, _ = kernels._grouped_layout(tiles_j.to(torch.int32), nt_j,
                                               32)
    k8_out = torch.empty(qidx_8.numel(), jt100.block_t, device=dev)

    def k8_at(wmax):
        return lib.pw2v_budget_adc_grouped_int8_w(
            ql_join.data_ptr(), sc_join.data_ptr(), jt100.codes_t.data_ptr(),
            jt100.codes_t.element_size(), jt100.rowterm.data_ptr(),
            qidx_8.data_ptr(), tog_8.data_ptr(), k8_out.data_ptr(),
            *ql_join.shape, jt100.codes_t.shape[1], tog_8.shape[0], 32,
            jt100.block_t, wmax, stream)

    for wmax in (0, 32, 16, 8):
        sweep[f"K8 wmax={wmax}"] = per_launch(lambda: k8_at(wmax))
    # K7 through the entry point that takes its widest staging and its rows
    # a thread (1, or 4 on the passes that keep half the block busy), over
    # the pair layout built once; the layout alone through its own
    k7_out = torch.empty(qj.shape[0], tiles_j.shape[1] * jt100.block_t,
                         device=dev)

    def k7_at(wmax, rpt):
        return lib.pw2v_budget_adc_grouped_w(
            luts_join.data_ptr(), jt100.codes_t.data_ptr(),
            jt100.codes_t.element_size(), jt100.rowterm.data_ptr(),
            pairs_7.data_ptr(), tog_7.data_ptr(), k7_out.data_ptr(),
            *luts_join.shape, jt100.codes_t.shape[1], tiles_j.shape[1],
            tog_7.shape[0], 32, jt100.block_t, wmax, rpt, stream)

    k7_name = ("budget_adc_grouped_kernel",)
    for wmax, rpt in ((0, 0), (16, 1), (8, 1), (4, 1), (2, 1), (1, 1),
                      (16, 4), (8, 4)):
        sweep[f"K7 wmax={wmax} rpt={rpt}"] = device_ms(
            torch, lambda: k7_at(wmax, rpt), k7_name)
    layout_buf = torch.empty(
        tog_7.shape[0] * 33 + lib.pw2v_budget_pair_layout_scratch(
            tiles_j.numel(), nt_j), dtype=torch.int32, device=dev)

    def layout_at():
        base = layout_buf.data_ptr()
        return lib.pw2v_budget_pair_layout(
            tiles_j.data_ptr(), base, base + 4 * tog_7.shape[0] * 32,
            base + 4 * tog_7.shape[0] * 33, tiles_j.numel(), nt_j,
            tog_7.shape[0], 32, stream)

    layout_steps = {step: device_ms(torch, layout_at,
                                    (f"budget_pair_{step}_kernel",))
                    for step in ("count", "place")}
    layout_ms = sum(layout_steps.values())
    # K9 through the entry point that takes the blocks a slot is split over
    # (0: its choice) at the single query's plan, and alone there and at
    # the batch it is checked at (the 100k join's method-1 plan, B = 512)
    q1 = q256[7:8]
    k9_out1 = torch.empty(1, tiles_1.shape[1] * jt100v.block_t, device=dev)
    k9_outb = torch.empty(qj.shape[0], tiles_jv.shape[1] * jt100v.block_t,
                          device=dev)

    def k9_at(q, tl, out, bps):
        return lib.pw2v_budget_exact_bps(
            q.data_ptr(), jt100v.vecs.data_ptr(), jt100v.rownorm.data_ptr(),
            tl.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
            jt100v.vecs.shape[1], jt100v.vecs.shape[0], tl.shape[1],
            jt100v.block_t, bps, stream)

    k9_name = ("budget_exact_kernel",)
    k9_ms = {"single": device_ms(
        torch, lambda: k9_at(q1, tiles_1, k9_out1, 0), k9_name),
        "batch": device_ms(
            torch, lambda: k9_at(qj, tiles_jv, k9_outb, 0), k9_name)}
    for bps in (1, 2, 4, 8, 16, 32):
        sweep[f"K9 bps={bps}"] = device_ms(
            torch, lambda: k9_at(q1, tiles_1, k9_out1, bps), k9_name)
    log(f"[5] sweep of K6 (slots per block, ring depth; 0 = its choice) and "
        f"K8 (widest staging; 0 = its choice), per launch of 20, and of K7 "
        f"(widest staging, rows a thread) and K9 (blocks per slot at the single query), "
        f"device time per launch: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in sweep.items()
            if k[:3] in ("K6 ", "K7 ", "K8 ", "K9 ")) + f" on {card}")
    log(f"[5] kernel budget_exact, device time per launch: single query "
        f"(B=1 P={tiles_1.shape[1]}) {k9_ms['single']:.4f} ms, join batch "
        f"(B={qj.shape[0]} P={tiles_jv.shape[1]}) {k9_ms['batch']:.4f} ms "
        f"on {card}")
    # the 100k join's groups: (query, tile) pairs, groups with a real slot,
    # and how many of them each staged width takes
    per_group = (qidx_8 < qj.shape[0]).sum(1)
    real_groups = int((per_group > 0).sum())
    group_stats = {
        "pairs": int(per_group.sum()), "groups": int(tog_8.shape[0]),
        "real_groups": real_groups,
        "mean_queries_per_real_group": float(per_group.sum()) / real_groups,
        "groups_by_width": {w: int(((per_group > lo) & (per_group <= w)).sum())
                            for lo, w in ((0, 4), (4, 8), (8, 16), (16, 32))}}
    log(f"[5] join 100k groups (rows 32): {group_stats}")
    # how much of each plan is padding: slots that name the inf tile
    inf_share = {}
    for shape, (_, jt, tl) in k6_shapes.items():
        last = jt.codes_t.shape[1] // jt.block_t - 1
        inf_share[shape] = float((tl == last).float().mean())
    log("[5] share of plan slots on the inf tile: " + ", ".join(
        f"{k} {v:.3f}" for k, v in inf_share.items()))
    # K6's bound and time at the two join shapes
    k6_bounds = {}
    for shape in ("3M", "100k"):
        lt, jt, tl = k6_shapes[shape]
        row_b = jt.codes_t.shape[0] * jt.codes_t.element_size() + 4
        ops = adc_probe_ops(tl, jt, lt.shape[1])
        k6_bounds[shape] = bound(probe_bytes(tl, jt.block_t, row_b, lt), ops,
                                 "fp32", 4 * ops, shared_rate)
        log(f"[5] kernel budget_adc at the {shape} join (B={tl.shape[0]} "
            f"P={tl.shape[1]} block_t={jt.block_t} 30x32): "
            f"{k6_ms[shape]:.4f} ms per launch of 20, bound "
            f"{k6_bounds[shape][0]:.4f} ms ({k6_bounds[shape][1]}, "
            f"{k6_bounds[shape][2]}) on {card}")
    # K7 beside K6 at the 100k join's plan; its bound with the pairs on the
    # inf tile left out (as in the kernels line) and with every pair counted
    all_ops = tiles_j.numel() * jt100.block_t * luts_join.shape[1]
    k7_bound_all = bound(work["budget_adc_grouped"][0], all_ops, "fp32",
                         4 * all_ops, shared_rate)
    log(f"[5] kernel budget_adc_grouped at the 100k join: "
        f"{sweep['K7 wmax=0 rpt=0']:.4f} ms device time per launch (K6 at the same "
        f"plan {k6_ms['100k']:.4f} per launch of 20), its pair layout "
        f"{layout_ms:.4f} ms (count {layout_steps['count']:.4f}, place "
        f"{layout_steps['place']:.4f}); bound "
        f"{bounds['budget_adc_grouped'][0]:.4f} ms "
        f"({bounds['budget_adc_grouped'][2]}) without the inf-tile pairs, "
        f"{k7_bound_all[0]:.4f} ms ({k7_bound_all[2]}) with every pair on "
        f"{card}")
    del k8_out, k7_out, layout_buf, k9_out1, k9_outb
    del luts, ql, sc, sweep_out, dense_out, k10_out

    def joined(method, targets, alpha, stats, lut_dtype="bf16"):
        def go():
            eng.set_method_flag(method)
            eng.set_alpha(alpha)
            eng.set_statistics_table(stats)
            eng.set_pq_lut_dtype(lut_dtype)
            try:
                return eng.knn_in_ivpq_batch(jwords, JOIN_K, targets)
            finally:
                eng.set_pq_lut_dtype("bf16")
        return go

    def ivfadc_pv():
        eng.set_knn_function("k_nearest_neighbour_ivfadc_pv")
        return eng.knn_matrix(q256, K)

    paths = {
        "exact_f32_b256": (lambda: eng.exact.search(q256, K), False, EVAL_Q),
        "pq_b256": (lambda: pq.search(q256, K), True, EVAL_Q),
        "pq_pv20_b256": (
            lambda: pq.search_pv(q256, K, 20, store.vectors_norm), True,
            EVAL_Q),
        "exact_bf16_fused_b1024": (lambda: fused.search(q1024, K), False,
                                   FUSED_B),
        "ivfadc_batch_w3_b256": (lambda: eng.knn_batch(qwords, K), True,
                                 EVAL_Q),
        "ivfadc_pv20_b256": (ivfadc_pv, True, EVAL_Q),
        "join_m0_a200_100k": (joined(0, "t100k", 200, "t100k"), True,
                              JOIN_Q),
        "join_m2_a200_100k": (joined(2, "t100k", 200, "t100k"), True,
                              JOIN_Q),
        "join_m1_a200_100k": (joined(1, "t100k", 200, "t100k"), True,
                              JOIN_Q),
        "join_m2_a600_3M": (joined(2, "all", 600, None), True, JOIN_Q),
        "pq_int8_b256": (lambda: pq.search(q256, K, impl="kernel_int8"),
                         True, EVAL_Q),
        "pq_int8_pv20_b256": (
            lambda: pq.search_pv(q256, K, 20, store.vectors_norm,
                                 impl="kernel_int8"), True, EVAL_Q),
        "join_int8_m2_a200_100k": (joined(2, "t100k", 200, "t100k", "int8"),
                                   True, JOIN_Q),
        "exact_int8_b256": (lambda: exact8.search(q256, K), False, EVAL_Q),
    }
    plain_alt = {"exact_bf16_fused_b1024": lambda: exact_top_k_precast(
        q1024, fused._table, fused._norms, K)}
    times = {}
    for name, (kfn, has_plain, b) in paths.items():
        kt = cuda_ms(torch, kfn, reps=5)
        row = {"ms_per_query": p50(kt) / b}
        if has_plain:
            with plain_kernels(kernels):
                if name in ("pq_b256", "pq_pv20_b256"):
                    pfn = {"pq_b256": lambda: pq.search(q256, K,
                                                        impl="plain"),
                           "pq_pv20_b256": lambda: pq.search_pv(
                               q256, K, 20, store.vectors_norm,
                               impl="plain")}[name]
                else:
                    pfn = kfn
                row["plain_ms_per_query"] = p50(cuda_ms(torch, pfn,
                                                        reps=5)) / b
        elif name in plain_alt:
            row["plain_ms_per_query"] = p50(cuda_ms(torch, plain_alt[name],
                                                    reps=5)) / b
        times[name] = row
        log(f"[5] path {name} B={b}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in row.items()) + f" on {card}")
    def single(method):
        def go():
            eng.set_statistics_table("t100k")
            eng.set_alpha(200)
            eng.set_method_flag(method)
            return eng.knn_in_ivpq("w7", JOIN_K, "t100k")
        return go

    singles = {"knn_in_ivpq_single_m0": single(0),
               "knn_in_ivpq_single_m1": single(1)}
    for name, fn in singles.items():
        kt = cuda_ms(torch, fn, reps=9)
        with plain_kernels(kernels):
            pt = cuda_ms(torch, fn, reps=9)
        times[name] = {"ms_per_query": p50(kt), "plain_ms_per_query": p50(pt)}
        log(f"[5] path {name} B=1: ms_per_query {p50(kt):.5f}, "
            f"plain_ms_per_query {p50(pt):.5f} on {card}")

    # ------------------------------------------------- 6: opt-in profile
    if args.profile:
        profile_paths(torch, kernels, {
            **{name: fn for name, (fn, _, _) in paths.items()}, **singles},
            card, args.profile)

    # ------------------------------------- 7: slice 9, the rest of the engine
    t0 = time.perf_counter()
    engine = engine_phase(torch, eng, store, words, qjoin, jwords, run_path,
                          path_launches, card)
    log(f"[7] slice 9 phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 8: serving
    t0 = time.perf_counter()
    serving = serving_phase(torch, eng, fused, run_path, path_launches,
                            card)
    log(f"[8] serving phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------- 9-11: builders, aniso, harness
    t0 = time.perf_counter()
    built_rows = builders_phase(torch, store, card)
    aniso = aniso_phase(torch, store, q256, gt256, card)
    evaluation = harness_phase(torch, eng, words, card)
    log(f"[9-11] builders, anisotropic and harness phases took "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 12: sharding
    t0 = time.perf_counter()
    sharded = sharding_phase(torch, eng, store, q256, qjoin, jwords, ph100k,
                             errs, run_path, path_launches, card)
    log(f"[12] sharding phase took {time.perf_counter() - t0:.1f} s")

    # ------------- 18: the join round's CUDA graphs (before the insert)
    t0 = time.perf_counter()
    join_graphs = graphs_phase(torch, eng, words, card)
    log(f"[18] join graphs phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 13: insert
    inserted = insert_phase(torch, ExactIndex, eng, exact8, run_path,
                            path_launches, card)
    log(f"[13] path after_insert launched {path_launches['after_insert']}")
    numbers = {k.name: {
        "max_abs_err": errs[k.name], "ms": kernel_ms[k.name],
        "plain_ms": plain_ms[k.name], "bound_ms": bounds[k.name][0],
        "bound_by": bounds[k.name][1], "bound_term": bounds[k.name][2],
        "library_ms": library_ms[k.name]} for k in kernels.KERNELS.values()}
    report = {"recall": rec, "paths_ms_per_query": times,
              "insert": inserted, "engine": engine,
              "serving": serving, "builders": built_rows,
              "aniso": aniso, "harness": evaluation,
              "sharding": sharded, "join_graphs": join_graphs,
              "path_launches": path_launches,
              "sweep_ms": sweep, "budget_adc_join_ms": k6_ms,
              "budget_adc_join_bounds": k6_bounds,
              "budget_adc_grouped_bound_all_pairs": k7_bound_all,
              "pair_layout_ms": layout_ms, "budget_exact_ms": k9_ms,
              "budget_exact_library_batch_ms": k9_library_batch_ms,
              "wrapper_kernels": wrapper_kernels,
              "adc_scan_library_err": k2_library_err,
              "adc_scan_int8_library_err": k3_library_err,
              "budget_library_err": library_err,
              "join_100k_groups": group_stats,
              "inf_tile_share": inf_share, "gpu": card}
    head = (words[:OFFLINE_N], store.vectors[:OFFLINE_N].cpu().numpy())
    return {"report": report, "numbers": numbers, "card": card,
            "path_launches": path_launches, "head": head}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="OUT.json",
                    help="also profile each path and write the report here")
    ap.add_argument("--bench-out", metavar="BENCH.json",
                    help="also write phase 17's bench record here")
    args = ap.parse_args()
    started = time.perf_counter()
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from postgres_word2vec_tpu_torch.ops import kernels

    res = engine_phases(torch, args)
    card, path_launches = res["card"], res["path_launches"]

    # ------------------------------------------------ 14: the CLI drivers
    # the phase-4 engine, the sharded one and their tables are gone with
    # engine_phases' frame: give the drivers' own 3M engines the card
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14] phases 1-13 released: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    t0 = time.perf_counter()
    res["report"]["drivers"] = drivers_phase(torch, *res["head"],
                                             path_launches, card)
    log(f"[14] drivers phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 15: the research drivers
    t0 = time.perf_counter()
    res["report"]["research"] = research_phase(torch, path_launches, card)
    log(f"[15] research drivers phase took {time.perf_counter() - t0:.1f} s")

    # ---------------------- 16: the graft entry and the kernel sweeps
    t0 = time.perf_counter()
    res["report"]["sweeps"] = sweeps_phase(torch, path_launches, card)
    log(f"[16] graft entry and kernel sweeps phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 17: the benchmark driver
    t0 = time.perf_counter()
    res["report"]["bench"] = bench_phase(torch, path_launches, card,
                                         args.bench_out)
    log(f"[17] benchmark driver phase took {time.perf_counter() - t0:.1f} s")

    launches = {name: 0 for name in kernels.KERNELS}
    for counts in path_launches.values():
        for name, v in counts.items():
            launches[name] += v
    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **res["numbers"][k.name]}
        for k in kernels.KERNELS.values()]}
    stop_children()
    log(f"[end] the whole run took {time.perf_counter() - started:.1f} s")
    log(json.dumps(res["report"]))
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
