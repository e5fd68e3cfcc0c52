"""Benchmark driver — prints ONE JSON line with the headline metric.

The port's ``bench.py``: the same workload (3,072,000 × 300 normalized
word-like vectors, the reference's published table, README.md:115-123,
BASELINE.md), the same rows under the same names, keys and batch sizes,
the same headline rule and the same one line, measured on one card.

Every search family at full scale: exact (single query; bf16 and int8
at batch 1024; the fused bf16 scan, K1), PQ 12×256 (K2, the PV
shortlists on K4; int8 LUTs, K3 and K5), OPQ 12×256, 4-bit PQ 60×16 with
and without OPQ, PQ 12×1024, IVFADC 12×256 over 1000 cells (w 1 and 3,
a 16-tile budget, one query, PV; K6), 4-bit IVFADC, the IVPQ kNN-join
at 100,000 prepared targets with statistics (methods 0 and 2, the α
ladder, the unprepared path, int8 LUTs; K6, K7, K8 as
``kernels.budget_adc_auto`` picks) and at 1M and 3M targets with their
exact in-set baselines, and online insert.

Data: the port's ``synth.generate_wordlike`` (the V3 parameters), drawn
from ``torch.Generator(device).manual_seed(0)`` on the device. Its draws
differ from the JAX package's for the same seed, so recalls are compared
with the JAX records within margins, never bit for bit.

Recall is reported at k=5 (``recall5``, the reference's precision
column) and k=10 (``recall``, the BASELINE.json metric). Headline: the
per-query time of the fastest batch kNN row whose recall@10 meets the
reference's batchwise IVFADC operating point (recall ≈ 0.35 at 10
ms/query, README.md:121); ``vs_baseline`` = 10 ms / ours.

Times: :func:`benchutil.timeit` synchronizes the device around every
call (median of 5 after a warm call); ``per_query_ms_pipelined`` is
:func:`benchutil.timeit_piped`'s enqueue-N, wait-once time a call.
Every section's exception propagates: a row that fails fails the run.

    python -m postgres_word2vec_tpu_torch.cli.bench [--small] \\
        [--out BENCH_LOCAL_torch_latest.json] [--device cpu]

``--small`` (or ``BENCH_SMALL=1``) runs 307,200 rows, a 500 × 10,000
join and no 1M/3M joins. The full record
goes to ``--out`` (default ``BENCH_LOCAL_torch_latest.json`` at the
repository root; the JAX record ``BENCH_LOCAL_latest.json`` is never
written), with the card's name and power limit under ``device`` and the
kernel launches of each row under ``launches``; the one line goes to
stdout, progress to stderr.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    parse, write_json)
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    device_ms, last_timing, log, log_mem, materialize, recall_at_k, timeit,
    timeit_piped)
from postgres_word2vec_tpu_torch.models.exact import (ExactIndex,
                                                      exact_top_k,
                                                      exact_top_k_in)
from postgres_word2vec_tpu_torch.models.ivfadc import (IVFADCIndex,
                                                       _ivfadc_probe_budget)
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                     build_statistics)
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[2]
#: the record's default path, beside the JAX package's
#: ``BENCH_LOCAL_latest.json``
DEFAULT_OUT = REPO / "BENCH_LOCAL_torch_latest.json"

N_FULL, N_SMALL = 3_072_000, 307_200
D = 300
K = 10
EVAL_Q = 256
BASELINE_MS = 10.0          # FREDDY batchwise IVFADC per-query (README:121)
BASELINE_RECALL = 0.35
BUILD = dict(train_size=100_000, iters=25, init="kmeans++")
#: the reference's published recall@5 bars (README.md:118-123)
REFERENCE_BARS = {"pq@5": 0.38, "pq_pv@5": 0.87, "ivfadc@5": 0.35,
                  "ivfadc_pv@5": 0.65}
#: the large-target joins: (targets, tag, [(alpha, pvf), ...]); None
#: targets means every row of the store. 3M ladders up past recall@5 0.90
#: (the crossover claim's quality bar) in both alpha and pvf.
LARGE_TARGETS = ((1_000_000, "1M", ((200, 20), (600, 20), (1200, 20),
                                    (2400, 20))),
                 (None, "3M", ((200, 20), (600, 20), (1200, 20), (1200, 50),
                               (2400, 20), (2400, 50))))
#: queries per call of the exact in-set baselines
EXACT_CHUNK = 512
#: method 0 may take at most this times method 2's join time
METHOD0_SLACK = 1.5


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Bench:
    """What the sections share: the table, its evaluation queries and
    their float32 ground truth, the build settings, the rows measured so
    far and the kernel launches of each row."""

    def __init__(self, V: torch.Tensor, *, small: bool):
        self.V = V
        self.n = int(V.shape[0])
        self.device = V.device
        self.small = small
        self.build = dict(BUILD)
        self.queries_eval = V[:EVAL_Q]
        self.gt10 = self.gt5 = None
        self.results: dict = {}
        self.launches: dict = {}
        self._seen_timing = 0

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    @contextlib.contextmanager
    def row(self, name: str):
        """Add the kernel launches of the block to row ``name``'s."""
        before = kernels.launch_counts()
        try:
            yield
        finally:
            acc = self.launches.setdefault(name, {})
            for kname, v in kernels.launch_counts().items():
                if v > before[kname]:
                    acc[kname] = acc.get(kname, 0) + v - before[kname]

    def add(self, name: str, ids5, ids10, **kw) -> None:
        """Record a kNN row: recall@10 and @5 against the ground truth,
        and the spread of the last :func:`timeit` behind its time."""
        self.results[name] = dict(recall=recall_at_k(ids10, self.gt10),
                                  recall5=recall_at_k(ids5, self.gt5), **kw)
        info = last_timing()
        if (info and info["seq"] != self._seen_timing
                and "timing_spread_s" not in self.results[name]):
            self._seen_timing = info["seq"]
            self.results[name]["timing_spread_s"] = [info["min_s"],
                                                     info["max_s"]]
        r = self.results[name]
        log(f"[{name}] {r.get('per_query_ms', r.get('total_s', 0)):.4g} "
            f"recall@10={r['recall']:.3f} recall@5={r['recall5']:.3f}")

    def knn_row(self, name: str, search, B: int, **kw) -> None:
        """Time ``search(q, k)`` at batch ``B`` and score it on the
        evaluation queries at k = 10 and 5 → row ``name``."""
        V, qe = self.V, self.queries_eval
        with self.row(name):
            t, _ = timeit(lambda q: search(q, K), V[:B])
            _, ids = search(qe, K)
            _, ids5 = search(qe, 5)
            self.add(name, ids5, ids, per_query_ms=t / B * 1e3, batch=B,
                     **kw)


# ------------------------------------------------------------ the exact rows
def time_exact(b: Bench) -> dict:
    """Time the exact paths before the float32 ground-truth scan → their
    indexes and times (bench.py:72-116)."""
    V = b.V
    ex = ExactIndex(V, "bfloat16")
    rows: dict = {"ex": ex}
    with b.row("exact_single"):
        t, _ = timeit(lambda q: ex.search(q, K, approx=False), V[:1])
        tp = timeit_piped(lambda q: ex.search(q, K, approx=False), V[:1])
    rows["exact_single"] = (t, tp)
    B = 1024
    with b.row("exact_batch"):
        t, _ = timeit(lambda q: ex.search(q, K, approx=True), V[:B])
        sp = last_timing()
        tp = timeit_piped(lambda q: ex.search(q, K, approx=True), V[:B])
    rows["exact_batch"] = (t, B, sp, tp)
    ex8 = ExactIndex(V, "int8")
    rows["ex8"] = ex8
    with b.row("exact_int8"):
        t, _ = timeit(lambda q: ex8.search(q, K, approx=True), V[:B])
        sp = last_timing()
        tp = timeit_piped(lambda q: ex8.search(q, K, approx=True), V[:B])
    rows["exact_int8"] = (t, B, sp, tp)

    # the fused scan (K1: matmul + strided-bin min/argmin, one pass over
    # the table at block_n 8192)
    tiled, tnorms, valid = rows["fused"] = kernels.tile_table(V)
    with b.row("exact_fused"):
        t, _ = timeit(lambda q: kernels.fused_exact_top_k(
            q, tiled, tnorms, K, valid_n=valid), V[:B])
        sp = last_timing()
        tp = timeit_piped(lambda q: kernels.fused_exact_top_k(
            q, tiled, tnorms, K, valid_n=valid), V[:B])
    rows["exact_fused"] = (t, B, sp, tp)
    return rows


def ground_truth(b: Bench) -> None:
    """Float32 exact top-10 (and its top-5) of the evaluation queries
    (bench.py:119-124)."""
    t0 = time.perf_counter()
    _, gt10 = exact_top_k(b.queries_eval, b.V, 10, chunk_size=524288)
    b.gt10 = _host(gt10)
    b.gt5 = b.gt10[:, :5]
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")


def exact_section(b: Bench, ex_rows: dict) -> None:
    """The exact rows, scored after the ground truth (bench.py:146-197).
    The port's bf16 and int8 scans select an exact top-k: it has no
    ``approx_max_k``."""
    qe, res = b.queries_eval, b.results
    t, tp = ex_rows["exact_single"]
    res["exact_single"] = {
        "per_query_ms": t * 1e3, "per_query_ms_pipelined": tp * 1e3,
        "recall": 1.0, "recall5": 1.0,
        "ref_s": 8.79, "note": "exact bf16 full scan, B=1"}

    for name, index, note in (
            ("exact_batch", ex_rows["ex"],
             "exact bf16 scan (torch.matmul, float32 accumulation) + an "
             "exact top-k: approx=True selects no approximate top-k"),
            ("exact_int8", ex_rows["ex8"],
             "int8 exact mode (torch._int_mm, exact f32 norms) + an exact "
             "top-k: approx=True selects no approximate top-k")):
        t, B, sp, tp = ex_rows[name]
        with b.row(name):
            _, ids = index.search(qe, K, approx=True)
            _, ids5 = index.search(qe, 5, approx=True)
            b.add(name, ids5, ids, per_query_ms=t / B * 1e3, batch=B,
                  per_query_ms_pipelined=tp / B * 1e3,
                  timing_spread_s=[sp["min_s"], sp["max_s"]], note=note)

    tiled, tnorms, valid = ex_rows["fused"]
    t, B, sp, tp = ex_rows["exact_fused"]
    with b.row("exact_fused"):
        _, ids = kernels.fused_exact_top_k(qe, tiled, tnorms, K,
                                           valid_n=valid)
        _, ids5 = kernels.fused_exact_top_k(qe, tiled, tnorms, 5,
                                            valid_n=valid)
        b.add("exact_fused", ids5, ids, per_query_ms=t / B * 1e3, batch=B,
              per_query_ms_pipelined=tp / B * 1e3,
              timing_spread_s=[sp["min_s"], sp["max_s"]],
              note="fused exact scan (K1, one pass over the table, "
                   "bn=8192)")


# --------------------------------------------------------- the PQ families
def _pq_build(b: Bench, label: str, **kw) -> PQIndex:
    t0 = time.perf_counter()
    pq = PQIndex.build(b.gen(1), b.V, **kw)
    pq.transposed_codes()
    log(f"{label} built in {time.perf_counter() - t0:.1f}s "
        f"(codes dtype {pq.codes.dtype})")
    return pq


def pq256_section(b: Bench) -> None:
    """PQ 12×256: the scan at B 64 and 256, PV 20 and 100, and the int8
    LUT rows (bench.py:199-265)."""
    pq = _pq_build(b, "PQ k=256", m=12, k=256, **b.build)
    V = b.V
    b.knn_row("pq_scan", pq.search, 64, ref_s=1.06, ref_recall=0.38,
              note="ADC full scan k=256 (K2)")
    for pvf in (20, 100):
        b.knn_row(f"pq_pv_{pvf}",
                  lambda q, k, pvf=pvf: pq.search_pv(q, k, pvf, V), 64,
                  ref_s=1.29, ref_recall=0.87,
                  note=f"ADC shortlist (K4) + exact re-rank pvf={pvf}")
    # throughput-shaped point: the same scan at batch 256
    b.knn_row("pq_scan_b256", pq.search, 256, ref_s=1.06, ref_recall=0.38,
              note="same kernel at batch 256 (throughput shape)")

    # int8 LUTs: per-query quantized LUTs summed exactly in int32
    def int8(q, k):
        return pq.search(q, k, impl="kernel_int8")

    b.knn_row("pq_scan_int8", int8, 64, ref_s=1.06, ref_recall=0.38,
              note="int8-LUT ADC full scan (K3)")
    qe = b.queries_eval
    with b.row("pq_scan_int8_b256"):
        t, _ = timeit(lambda q: int8(q, K), V[:256])
        _, ids = int8(qe, K)
        _, ids5 = int8(qe, 5)
        b.add("pq_scan_int8_b256", ids5, ids, per_query_ms=t / 256 * 1e3,
              batch=256, ref_s=1.06, ref_recall=0.38,
              note="int8-LUT ADC at batch 256 (throughput shape)")
    b.knn_row("pq_pv_20_int8",
              lambda q, k: pq.search_pv(q, k, 20, V, impl="kernel_int8"),
              64, ref_s=1.29, ref_recall=0.87,
              note="int8-LUT ADC shortlist (K5) + exact re-rank pvf=20")
    del pq


def _scan_and_pv(b: Bench, pq: PQIndex, scan: str, pv: str, B: int,
                 scan_note: str, pv_note: str) -> None:
    V = b.V
    b.knn_row(scan, pq.search, B, ref_s=1.06, ref_recall=0.38,
              note=scan_note)
    b.knn_row(pv, lambda q, k: pq.search_pv(q, k, 20, V), B, ref_s=1.29,
              ref_recall=0.87, note=pv_note)


def opq_section(b: Bench) -> None:
    """OPQ 12×256 (bench.py:267-291)."""
    pq = _pq_build(b, "OPQ PQ", m=12, k=256, train_size=100_000,
                   iters=b.build["iters"], opq_iters=10)
    _scan_and_pv(b, pq, "pq_opq_scan", "pq_opq_pv_20", 64,
                 "OPQ-rotated ADC full scan (framework quantizer edge)",
                 "OPQ ADC + exact re-rank pvf=20")
    del pq


def pq4bit_section(b: Bench) -> None:
    """4-bit PQ 60×16, the Quick-ADC regime (bench.py:293-319)."""
    pq = _pq_build(b, "PQ 60x16", m=60, k=16, **b.build)
    _scan_and_pv(b, pq, "pq4bit_scan", "pq4bit_pv_20", 256,
                 "60x16 4-bit codes, ADC full scan",
                 "60x16 ADC + exact re-rank pvf=20")
    del pq


def pq4bit_opq_section(b: Bench) -> None:
    """OPQ × 4-bit, the best quality point (bench.py:321-347)."""
    pq = _pq_build(b, "OPQ 60x16", m=60, k=16, opq_iters=10, **b.build)
    _scan_and_pv(b, pq, "pq4bit_opq_scan", "pq4bit_opq_pv_20", 256,
                 "OPQ rotation + 60x16 4-bit codes, ADC full scan",
                 "OPQ 60x16 ADC + exact re-rank pvf=20")
    del pq


def pq1024_section(b: Bench) -> None:
    """PQ 12×1024, int16 codes (README.md:125's regime;
    bench.py:349-373)."""
    pq = _pq_build(b, "PQ k=1024", m=12, k=1024, **b.build)
    _scan_and_pv(b, pq, "pq1024_scan", "pq1024_pv_20", 64,
                 "ADC full scan, 12x1024 int16 codes",
                 "12x1024 ADC + exact re-rank pvf=20")
    del pq


# ------------------------------------------------------------------ IVFADC
def _coverage(info: dict) -> float:
    return float(int(info["found"].sum()) / max(int(info["needed"].sum()),
                                                1))


def _ivfadc_build(b: Bench, label: str, m: int, k: int) -> IVFADCIndex:
    t0 = time.perf_counter()
    ivf = IVFADCIndex.build(b.gen(2), b.V, m=m, k=k, k_coarse=1000,
                            **b.build)
    td = ivf.tiled()
    log(f"{label} built in {time.perf_counter() - t0:.1f}s "
        f"(list_cap={ivf.list_cap}, tiles avg {td.avg_tile_cnt:.1f} max "
        f"{td.max_tile_cnt})")
    return ivf


def ivfadc_section(b: Bench) -> None:
    """IVFADC 12×256 over 1000 cells: w 1 and 3, the 16-tile budget, one
    query, PV 20 (bench.py:375-461)."""
    ivf = _ivfadc_build(b, "IVFADC", 12, 256)
    V, qe, res = b.V, b.queries_eval, b.results
    B = 256
    for w in (1, 3):
        name = f"ivfadc_batch_w{w}"
        with b.row(name):
            t, _ = timeit(lambda q: ivf.search(q, K, w=w), V[:B])
            _, ids, info = ivf.search(qe, K, w=w, return_info=True)
            _, ids5 = ivf.search(qe, 5, w=w)
            b.add(name, ids5, ids, per_query_ms=t / B * 1e3, batch=B, w=w,
                  coverage=_coverage(info), ref_s=0.01, ref_recall=0.35,
                  note=f"tiled budget probe w={w}, full coverage")

    # latency-bound budgeted point
    with b.row("ivfadc_batch_w3_b16"):
        t, _ = timeit(lambda q: ivf.search(q, K, w=3, budget_tiles=16),
                      V[:B])
        _, ids, info = ivf.search(qe, K, w=3, budget_tiles=16,
                                  return_info=True)
        _, ids5 = ivf.search(qe, 5, w=3, budget_tiles=16)
        b.add("ivfadc_batch_w3_b16", ids5, ids, per_query_ms=t / B * 1e3,
              batch=B, coverage=_coverage(info), ref_s=0.01,
              ref_recall=0.35, note="budget 16 tiles/query")

    # one query: the host's wall time of a call, the enqueue-N time, and
    # the device time of one w=3 probe read from a profiler trace
    td = ivf.tiled()
    p3 = ivf._auto_budget(3, None, full=True)
    with b.row("ivfadc_single"):
        t, _ = timeit(lambda q: ivf.search(q, K, w=3), V[:1])
        tp = timeit_piped(lambda q: ivf.search(q, K, w=3), V[:1])
        dev_ms = device_ms(lambda: _ivfadc_probe_budget(
            V[:1], ivf.coarse.centroids, ivf.codebook.centroids, td, 0, 3,
            K, p3), 32)
    res["ivfadc_single"] = {
        "per_query_ms": t * 1e3, "per_query_ms_pipelined": tp * 1e3,
        "device_ms": dev_ms,
        "recall": res["ivfadc_batch_w3"]["recall"],
        "recall5": res["ivfadc_batch_w3"]["recall5"],
        "ref_s": 0.03, "ref_recall": 0.35,
        "note": ("single query w=3; per_query_ms is the host's wall time "
                 "of one synchronized call; device_ms is measured device "
                 "time, the profiler's, of one w=3 probe "
                 "(_ivfadc_probe_budget at the full budget) averaged over "
                 "32 calls, not a wall-clock chain")}
    log(f"[ivfadc_single] wall={t * 1e3:.2f}ms piped={tp * 1e3:.2f}ms "
        f"device={dev_ms:.3f}ms")

    b.knn_row("ivfadc_pv", lambda q, k: ivf.search_pv(q, k, 20, V, w=3), B,
              ref_s=0.26, ref_recall=0.65,
              note="tiled probe w=3 + exact re-rank pvf=20")
    del ivf


def ivfadc4bit_section(b: Bench) -> None:
    """IVFADC with 4-bit residual codes, 60×16 (bench.py:463-490)."""
    ivf = _ivfadc_build(b, "IVFADC 60x16", 60, 16)
    V = b.V
    b.knn_row("ivfadc4bit_w3", lambda q, k: ivf.search(q, k, w=3), 256,
              w=3, ref_s=0.01, ref_recall=0.35,
              note="tiled probe w=3, 60x16 4-bit residual codes")
    b.knn_row("ivfadc4bit_pv", lambda q, k: ivf.search_pv(q, k, 20, V, w=3),
              256, ref_s=0.26, ref_recall=0.65,
              note="4-bit tiled probe w=3 + exact re-rank pvf=20")
    del ivf


# ---------------------------------------------------------------- the joins
class Join:
    """The join rows' shared state: the IVPQ index, the query block (the
    store's last ``nq`` rows), the 100k (or SMALL 10k) target set with its
    statistics, ground truth and prepared handle."""

    def __init__(self, b: Bench, ivpq: IVPQIndex, nq: int, nt: int):
        self.b, self.ivpq, self.nq, self.nt = b, ivpq, nq, nt
        V = b.V
        self.qv = V[b.n - nq:]
        self.tgt = torch.arange(nt, dtype=torch.int32, device=b.device)
        self.stats = build_statistics(ivpq.cell_of, self.tgt,
                                      ivpq.num_cells)
        _, gt = exact_top_k(self.qv[:EVAL_Q], V[:nt], 5, chunk_size=524288)
        self.gt = _host(gt)
        self.prepared = None

    def cfg(self, name: str, prepared="default", tgt_=None, gt_=None,
            stats_=None, nt_=None, **kw) -> None:
        """One join row: a warm call at 512 queries and at the full block,
        then the median of 3 timed full-block calls; recall@5 and the scan
        counters on the evaluation queries (bench.py:545-589)."""
        b, ivpq, qv, nq = self.b, self.ivpq, self.qv, self.nq
        prepared = self.prepared if prepared == "default" else prepared
        tgt_ = self.tgt if tgt_ is None else tgt_
        gt_ = self.gt if gt_ is None else gt_
        stats_ = self.stats if stats_ is None else stats_
        nt_ = self.nt if nt_ is None else nt_
        jkw = dict(statistics=stats_, **kw)
        if prepared is not None:
            jkw["prepared"] = prepared
            jkw.pop("vectors", None)
        else:
            jkw["target_ids"] = tgt_
        with b.row(name):
            materialize(ivpq.search_join(qv[:512], 5, query_chunk=512,
                                         **jkw))
            materialize(ivpq.search_join(qv, 5, **jkw))
            trials = []
            for _ in range(3):
                t0 = time.perf_counter()
                materialize(ivpq.search_join(qv, 5, **jkw))
                trials.append(time.perf_counter() - t0)
            dt = float(np.median(trials))
            _, i2, info = ivpq.search_join(qv[:EVAL_Q], 5, query_chunk=512,
                                           return_info=True, **jkw)
        r = recall_at_k(i2, gt_)
        b.results[name] = {
            "total_s": dt, "trials_s": [round(t, 4) for t in trials],
            "queries": nq, "targets": nt_,
            "qps": nq / dt, "recall": r, "recall5": r, "k": 5,
            "prepared": prepared is not None,
            "scanned_rows_mean": float(_host(info["retrieved"]).mean()),
            # escalation rounds and the final alpha: each extra round is
            # a full re-dispatch
            "rounds": int(_host(info["rounds"]).max()),
            "final_alpha": int(_host(info["final_alpha"]).max()),
            **{kk: vv for kk, vv in kw.items() if kk != "vectors"}}
        log(f"[{name}] {dt:.3f}s qps={nq / dt:.0f} recall@5={r:.3f} "
            f"scanned~{b.results[name]['scanned_rows_mean']:.0f}")

    def exact_in_row(self, name: str, tgt_, gt_, nt_) -> None:
        """The exact float32 in-set baseline over ``nt_`` targets, in
        chunks of 512 queries: the masked product (``exact_top_k_in``) or,
        when the targets are the whole store, the chunked full scan (no
        (B, T) buffer, no table-sized gather; bench.py:626-653)."""
        b, qv, nq, V = self.b, self.qv, self.nq, self.b.V
        if nt_ >= b.n:
            def run(qb):
                return exact_top_k(qb, V, 5, chunk_size=524288)
        else:
            mask = torch.ones(nt_, dtype=torch.bool, device=b.device)

            def run(qb):
                return exact_top_k_in(qb, V, tgt_, mask, 5)
        with b.row(name):
            materialize(run(qv[:EXACT_CHUNK]))
            if nq % EXACT_CHUNK:
                materialize(run(qv[:nq % EXACT_CHUNK]))
            t0 = time.perf_counter()
            for s in range(0, nq, EXACT_CHUNK):
                out = run(qv[s:s + EXACT_CHUNK])
            materialize(out)
            ex_s = time.perf_counter() - t0
            _, ie = run(qv[:EVAL_Q])
        r = recall_at_k(ie, gt_)
        b.results[name] = {
            "total_s": ex_s, "queries": nq, "targets": nt_,
            "qps": nq / ex_s, "recall": r, "recall5": r, "k": 5,
            "note": (f"exact f32 in-set baseline at {nt_} targets"
                     if name != "join_exact_in"
                     else "exact masked matmul (knn_in_exact baseline)")}
        log(f"[{name}] {ex_s:.3f}s")


def join_section(b: Bench) -> Join:
    """The IVPQ kNN-join at 100k prepared targets (SMALL: 500 queries ×
    10,000 targets): the exact baseline, the prepared handle, methods 0
    and 2 over the alpha ladder, the unprepared path and int8 LUTs
    (bench.py:492-614) → the join state for the large-target rows."""
    t0 = time.perf_counter()
    nq, nt = (500, 10_000) if b.small else (5000, 100_000)
    ivpq = IVPQIndex.build(b.gen(3), b.V, m=30, k=32, k_coarse=1024,
                           coarse_positions=1, **b.build)
    log(f"IVPQ (flat 1024) built in {time.perf_counter() - t0:.1f}s")
    j = Join(b, ivpq, nq, nt)
    j.exact_in_row("join_exact_in", j.tgt, j.gt, nt)

    # the prepared handle: target gathers and cell tiling paid once
    t0 = time.perf_counter()
    with b.row("ivpq_join_prepare"):
        j.prepared = ivpq.prepare_join(j.tgt, vectors=b.V[:nt],
                                       vecs_pregathered=True)
        materialize(j.prepared)
    prep_s = time.perf_counter() - t0
    log(f"prepare_join({nt}) in {prep_s:.3f}s")
    b.results["ivpq_join_prepare"] = {"build_s": prep_s, "targets": nt}

    j.cfg("ivpq_join_adc_a200", alpha=200, method=0, confidence=0.8)
    j.cfg("ivpq_join_pv_a100", alpha=100, method=2, confidence=0.8, pvf=20)
    j.cfg("ivpq_join_pv_a200", alpha=200, method=2, confidence=0.8, pvf=20)
    # the same config without the prepared handle: per-call target
    # gathers and the cached tile lookup
    j.cfg("ivpq_join_pv_a200_adhoc", prepared=None, alpha=200, method=2,
          confidence=0.8, pvf=20, vectors=b.V)
    j.cfg("ivpq_join_pv_a400", alpha=400, method=2, confidence=0.8, pvf=20)
    j.cfg("ivpq_join_pv_a600", alpha=600, method=2, confidence=0.8, pvf=20)
    # int8 gathered LUTs on the join's budget round
    j.cfg("ivpq_join_pv_a200_i8", alpha=200, method=2, confidence=0.8,
          pvf=20, lut_dtype="int8")
    return j


def large_target_section(j: Join, plan=LARGE_TARGETS) -> None:
    """The selectivity crossover: the exact in-set baseline and the
    prepared join's alpha ladder at 1M targets and at the whole store
    (bench.py:626-692). ``plan``: (targets or None for every row, tag,
    [(alpha, pvf), ...])."""
    b, ivpq, V = j.b, j.ivpq, j.b.V
    for ntN, tag, ladder in plan:
        ntN = b.n if ntN is None else ntN
        tgtN = torch.arange(ntN, dtype=torch.int32, device=b.device)
        statsN = build_statistics(ivpq.cell_of, tgtN, ivpq.num_cells)
        _, gtN = exact_top_k(j.qv[:EVAL_Q], V[:ntN], 5, chunk_size=524288)
        gtN = _host(gtN)
        j.exact_in_row(f"join_exact_in_{tag}", tgtN, gtN, ntN)
        t0 = time.perf_counter()
        with b.row(f"ivpq_join_prepare_{tag}"):
            phN = ivpq.prepare_join(tgtN, vectors=V if ntN >= b.n
                                    else V[:ntN], vecs_pregathered=True)
            materialize(phN)
        prepN = time.perf_counter() - t0
        log(f"prepare_join({ntN}) in {prepN:.3f}s")
        b.results[f"ivpq_join_prepare_{tag}"] = {"build_s": prepN,
                                                 "targets": ntN}
        for a, pvf_ in ladder:
            nm = (f"ivpq_join_pv_a{a}_{tag}" if pvf_ == 20
                  else f"ivpq_join_pv_a{a}_pvf{pvf_}_{tag}")
            j.cfg(nm, prepared=phN, gt_=gtN, stats_=statsN, nt_=ntN,
                  alpha=a, method=2, confidence=0.8, pvf=pvf_)
        del phN


def method_guard(results: dict) -> None:
    """Method 0 (ADC only) does strictly less work than method 2 (ADC +
    post-verify) at equal alpha, so it must not take more than 1.5× its
    time (bench.py:693-716); ``PW2V_BENCH_STRICT`` makes a breach fatal."""
    m0 = results.get("ivpq_join_adc_a200", {}).get("total_s")
    m2 = results.get("ivpq_join_pv_a200", {}).get("total_s")
    if m0 and m2:
        results["join_method0_vs_method2"] = {
            "ratio": round(m0 / m2, 3), "ok": m0 <= METHOD0_SLACK * m2}
        if m0 > METHOD0_SLACK * m2:
            log(f"WARNING method-0 join regression: {m0:.3f}s vs "
                f"method-2 {m2:.3f}s (ratio {m0 / m2:.2f})")
            if os.environ.get("PW2V_BENCH_STRICT"):
                raise SystemExit(
                    f"method-0 join regression (strict mode): "
                    f"{m0:.3f}s vs {m2:.3f}s")


# ------------------------------------------------------------------- insert
def insert_section(b: Bench) -> None:
    """Online insert over the full table (int8 exact family): one warm
    batch of 1,024 terms, then 3 timed batches, then a just-inserted
    phrase must be its own 1-NN (bench.py:722-794)."""
    from postgres_word2vec_tpu_torch.api import Freddy
    from postgres_word2vec_tpu_torch.store import VectorStore

    N = b.n
    t0 = time.perf_counter()
    store = VectorStore.from_arrays([f"w{i}" for i in range(N)], b.V,
                                    normalized=True)
    eng = Freddy(store, exact_dtype="int8", exact_approx=True)
    log(f"insert engine built in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(11)

    def _terms(n_terms):  # unseen 2-word phrases over the base vocab
        pairs = rng.integers(0, N, size=(n_terms, 2))
        return [f"w{a} w{b2}" for a, b2 in pairs]

    ib = 1024
    with b.row("insert_batch"):
        eng.insert_batch(_terms(ib))           # warm: the capacity grow
        materialize(eng.exact._table[-1, :1])
        b.V = b.queries_eval = None            # the store holds the table
        log_mem("insert warm")
        reps = 3
        t0 = time.perf_counter()
        inserted = 0
        for _ in range(reps):
            inserted += eng.insert_batch(_terms(ib))
        materialize(eng.exact._table[-1, :1])
        dt = time.perf_counter() - t0
        res = b.results["insert_batch"] = {
            "total_s": dt, "terms": inserted, "batches": reps,
            "batch_size": ib, "terms_per_s": inserted / dt,
            "note": ("insert_batch: batched tokenize + store append + "
                     "int8 append-quantize into capacity buffers "
                     "(freddy.c:1403-1658 parity); device work O(batch)")}
        log(f"[insert_batch] {inserted} terms in {dt:.3f}s "
            f"({inserted / dt:.0f} terms/s)")
        probe = _terms(1)[0]
        eng.insert_batch([probe])
        top = eng.knn(probe, 1)
    res["probe_ok"] = bool(top and top[0][0] == probe)
    if not res["probe_ok"]:
        log(f"WARNING insert probe: knn({probe!r}) -> {top}")
    del eng, store


# ----------------------------------------------------------------- headline
def headline(results: dict) -> tuple[str, dict]:
    """The fastest batch row (batch > 1) whose recall@10 meets
    BASELINE_RECALL, else ``exact_single`` → (name, row)
    (bench.py:796-805)."""
    eligible = [(name, cfg) for name, cfg in results.items()
                if "per_query_ms" in cfg and cfg.get("batch", 1) > 1
                and cfg.get("recall", 0.0) >= BASELINE_RECALL]
    if eligible:
        return min(eligible, key=lambda kv: kv[1]["per_query_ms"])
    return "exact_single", results["exact_single"]


def one_line(results: dict, n: int) -> dict:
    """The compact result line, bench.py's keys (bench.py:826-869)."""
    name, best = headline(results)
    value = best["per_query_ms"]

    def _r5(row):
        c = results.get(row, {})
        return round(c.get("recall5", 0.0), 3) if c else None

    # the quality-bar row: the fastest 3M join at recall@5 >= 0.90
    hi = sorted(((n_, c_) for n_, c_ in results.items()
                 if n_.startswith("ivpq_join_pv_") and n_.endswith("_3M")
                 and c_.get("recall5", 0.0) >= 0.90),
                key=lambda kv: -kv[1]["qps"])
    hi_join = ({"join_3M_hi": hi[0][0],
                "join_3M_hi_qps": round(hi[0][1]["qps"], 0),
                "join_3M_hi_r5": round(hi[0][1]["recall5"], 3)}
               if hi else {})
    return {
        "metric": f"batch_knn_p50_per_query_ms[{name}]",
        "value": round(value, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / value, 1),
        "recall": round(best.get("recall", 1.0), 4),
        "n_vectors": n,
        "pq_r5": _r5("pq_scan"), "pq_pv20_r5": _r5("pq_pv_20"),
        "pq_opq_r5": _r5("pq_opq_scan"),
        "ivfadc_r5": _r5("ivfadc_batch_w3"), "ivfadc_pv_r5": _r5("ivfadc_pv"),
        "best_quality_r5": _r5("pq4bit_opq_pv_20"),
        "join_pv_a200_qps": round(
            results.get("ivpq_join_pv_a200", {}).get("qps", 0.0), 0),
        "join_pv_a200_r5": _r5("ivpq_join_pv_a200"),
        "join_3M_qps": round(
            results.get("ivpq_join_pv_a600_3M", {}).get("qps", 0.0), 0),
        "join_3M_r5": _r5("ivpq_join_pv_a600_3M"),
        **hi_join,
        "join_exact_3M_qps": round(
            results.get("join_exact_in_3M", {}).get("qps", 0.0), 0),
        "insert_tps": round(
            results.get("insert_batch", {}).get("terms_per_s", 0.0), 0),
    }


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--small", action="store_true",
                    default=bool(int(os.environ.get("BENCH_SMALL", "0"))),
                    help="307,200 rows, a 500 x 10,000 join, no 1M/3M "
                         "joins (also BENCH_SMALL=1)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    N = N_SMALL if args.small else N_FULL
    log(f"bench: N={N} D={D} device={dev}")
    t0 = time.perf_counter()
    V = synth.generate_wordlike(torch.Generator(dev).manual_seed(0), N, D)
    materialize(V)
    log(f"data generated in {time.perf_counter() - t0:.1f}s")
    b = Bench(V, small=args.small)
    del V

    # the exact paths are timed before the ground-truth scan, as in
    # bench.py, and scored after it
    ex_rows = time_exact(b)
    ground_truth(b)
    exact_section(b, ex_rows)
    del ex_rows
    log_mem("exact")
    for section, tag in ((pq256_section, "pq256"), (opq_section, "pq_opq"),
                         (pq4bit_section, "pq4bit"),
                         (pq4bit_opq_section, "pq4bit_opq"),
                         (pq1024_section, "pq1024"),
                         (ivfadc_section, "ivfadc"),
                         (ivfadc4bit_section, "ivfadc4bit")):
        section(b)
        log_mem(tag)
    j = join_section(b)
    if not b.small:
        large_target_section(j)
    del j
    method_guard(b.results)
    log_mem("ivpq")
    insert_section(b)
    log_mem("insert")

    detail = {"n_vectors": N,
              # the generator behind every recall: a cross-record recall
              # comparison holds only at equal dataset parameters, and
              # these draws are the port's, not the JAX package's
              "dataset": dict(synth.V3_PARAMS, generator="wordlike",
                              version="v3",
                              draws="postgres_word2vec_tpu_torch "
                                    "torch.Generator seed 0"),
              "reference_bars": dict(REFERENCE_BARS),
              "configs": b.results,
              "device": device_line(dev),
              "launches": b.launches}
    path = write_json(args.out, detail, 1)
    log(f"full detail written to {path}")
    line = one_line(b.results, N)
    out = json.dumps(line)
    assert len(out) < 2048, f"bench line too long ({len(out)} B)"
    print(out, flush=True)
    return detail


if __name__ == "__main__":
    main()
