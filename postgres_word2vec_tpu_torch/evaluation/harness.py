"""Evaluation methodology — ports of the reference's evaluation/ scripts.

Counterpart of ``postgres_word2vec_tpu/evaluation/harness.py`` on the
port's :class:`~postgres_word2vec_tpu_torch.api.Freddy`, with the same
record keys (the reference's TRACK names).

The reference treats "correctness = precision against exact search" and
"performance harness = smoke test" (SURVEY §4). This module reproduces that
methodology in-process:

- :func:`calculate_precision` — precision@k of approximate vs exact result
  sets (evaluation_utils.py:230-238, time_measurement.py:168-176),
- :func:`get_exact_results` — ground truth via IVPQ method=1 with huge
  alpha (ivpq_evaluation.py:33-43),
- :func:`measurement` / :func:`batch_measurement` — per-query and batch
  wall-time harnesses (evaluation_utils.py:118-176),
- :func:`create_track_statistics` — run a query and scrape stage metrics
  (evaluation_utils.py:84-98; the psycopg2 notice scraping collapses into
  the in-process Tracker),
- :func:`time_precision_sweep` — the kNN-join time/precision trade-off grid
  over alphas × pvf × methods (time_precision_eval.py, ivpq_evaluation.py:
  103-176),
- :func:`confidence_eval` — empirical validation of the probing guarantee:
  fraction of queries whose retrieved target count reaches k·alpha, per
  configured confidence (confidence_eval.py),
- :func:`target_count_eval` — predicted (statistics model) vs actually
  retrieved target counts (target_counts.py).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from postgres_word2vec_tpu_torch.api import Freddy


def calculate_precision(approx: Sequence[tuple], exact: Sequence[tuple]
                        ) -> float:
    """Precision@k between two [(query, target, sim)] result lists, averaged
    over queries (evaluation_utils.py:230-238)."""
    def group(rows):
        g: dict[str, set] = {}
        for q, t, _ in rows:
            g.setdefault(q, set()).add(t)
        return g

    ga, ge = group(approx), group(exact)
    if not ge:
        return 0.0
    scores = [len(ga.get(q, set()) & ts) / max(len(ts), 1)
              for q, ts in ge.items()]
    return float(np.mean(scores))


def get_exact_results(engine: Freddy, queries: Sequence[str], k: int,
                      targets) -> list[tuple]:
    """Exact kNN-join ground truth.

    The reference extracts ground truth by running the IVPQ kernel with
    method=1 (exact distances) and alpha=10⁶ so every cell is probed
    (ivpq_evaluation.py:33-43); with the statistics-free engine that is
    equivalent to the exact join, which is what we run (one masked matmul).
    """
    return engine.knn_search_in_batch(queries, k, targets)


def measurement(engine: Freddy, query_words: Sequence[str], k: int,
                fn_name: str = "knn") -> dict:
    """Word-keyed single-query timing (evaluation_utils.py:118-136).

    Returns {"times": {word: seconds}, "results": {word: rows}}.
    """
    fn = getattr(engine, fn_name)
    times, results = {}, {}
    for w in query_words:
        t0 = time.perf_counter()
        results[w] = fn(w, k)
        times[w] = time.perf_counter() - t0
    return {"times": times, "results": results}


def batch_measurement(engine: Freddy, queries: Sequence[str], k: int,
                      targets=None, fn_name: str | None = None) -> dict:
    """One batched call, timed (evaluation_utils.py:138-176)."""
    if targets is None:
        fn_name = fn_name or "knn_batch"
        t0 = time.perf_counter()
        rows = getattr(engine, fn_name)(queries, k)
    else:
        fn_name = fn_name or "knn_join"
        t0 = time.perf_counter()
        rows = getattr(engine, fn_name)(queries, k, targets)
    dt = time.perf_counter() - t0
    return {"time": dt, "per_query": dt / max(len(queries), 1),
            "results": rows}


def create_track_statistics(engine: Freddy, fn_name: str, *args) -> dict:
    """Run a query family and return the stage-metric dict
    (evaluation_utils.py:84-98). Metric names match the reference's TRACK
    keys so step-wise breakdowns port directly; the server's spans and
    counters are left out."""
    engine.tracker.clear_track()
    getattr(engine, fn_name)(*args)
    return engine.tracker.track_results()


def time_precision_sweep(engine: Freddy, queries: Sequence[str], k: int,
                         targets, *, alphas=(50, 100, 150, 200),
                         pvfs=(3, 5, 10, 15), methods=(0, 1, 2),
                         repeats: int = 1) -> list[dict]:
    """The kNN-join time/precision grid (time_precision_eval.py: alphas
    {50,100,150,200}, pvf sweep, methods Baseline/PQ/Exact/PQ+PV).

    Returns one record per configuration:
    {method, alpha, pvf, time_s, per_query_ms, precision}.
    """
    exact = get_exact_results(engine, queries, k, targets)
    saved = (engine.params.alpha, engine.params.pvf, engine.params.method)
    records = []
    try:
        for method in methods:
            engine.set_method_flag(method)
            for alpha in alphas:
                engine.set_alpha(alpha)
                pvf_list = pvfs if method == 2 else (engine.params.pvf,)
                for pvf in pvf_list:
                    engine.set_pvf(pvf)
                    times = []
                    for _ in range(repeats):
                        t0 = time.perf_counter()
                        rows = engine.knn_in_ivpq_batch(queries, k, targets)
                        times.append(time.perf_counter() - t0)
                    records.append({
                        "method": method, "alpha": alpha, "pvf": pvf,
                        "time_s": float(np.median(times)),
                        "per_query_ms": float(np.median(times)) * 1e3
                        / max(len(queries), 1),
                        "precision": calculate_precision(rows, exact)})
    finally:
        engine.params.alpha, engine.params.pvf, engine.params.method = saved
    return records


def confidence_eval(engine: Freddy, queries: Sequence[str], k: int,
                    targets, *, confidences=(0.05, 0.2, 0.4, 0.6, 0.8,
                                             0.95)) -> list[dict]:
    """Empirical confidence validation (confidence_eval.py): for each
    configured confidence, the fraction of queries whose probed cells
    actually contained ≥ k·alpha targets (uses the kernel's ``retrieved``
    counter — the reference's ``TRACK retrieved``)."""
    ivpq = engine.ivpq
    q = engine._query_matrix(list(queries))
    tids, tmask = engine._target_ids(targets)
    p = engine.params
    out = []
    for conf in confidences:
        _, _, info = ivpq.search_join(
            q, k, tids, target_mask=tmask, vectors=engine.store.vectors_norm,
            statistics=engine._active_statistics(), alpha=p.alpha,
            pvf=p.pvf, method=p.method, confidence=conf,
            long_codes_threshold=p.long_codes_threshold, max_rounds=1,
            return_info=True)
        retrieved = info["retrieved"].cpu().numpy()
        goal = min(k * p.alpha, int(tmask.sum()))
        out.append({"confidence": conf,
                    "fraction_met": float((retrieved >= goal).mean()),
                    "mean_retrieved": float(retrieved.mean())})
    return out


def target_count_eval(engine: Freddy, queries: Sequence[str], k: int,
                      targets) -> dict:
    """Predicted vs retrieved target counts (target_counts.py): pairs for
    scatter plotting plus mean absolute relative divergence."""
    ivpq = engine.ivpq
    q = engine._query_matrix(list(queries))
    tids, tmask = engine._target_ids(targets)
    p = engine.params
    _, _, info = ivpq.search_join(
        q, k, tids, target_mask=tmask, vectors=engine.store.vectors_norm,
        statistics=engine._active_statistics(), alpha=p.alpha, pvf=p.pvf,
        method=p.method, confidence=p.confidence,
        long_codes_threshold=p.long_codes_threshold, max_rounds=1,
        return_info=True)
    predicted = info["target_count"].cpu().numpy().astype(np.float64)
    retrieved = info["retrieved"].cpu().numpy().astype(np.float64)
    rel = np.abs(predicted - retrieved) / np.maximum(retrieved, 1.0)
    return {"predicted": predicted.tolist(),
            "retrieved": retrieved.tolist(),
            "mean_abs_rel_divergence": float(rel.mean())}
