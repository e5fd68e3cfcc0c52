"""Query-family timing harness.

The port's ``evaluation/time_measurement.py`` (the reference's
``time_measurement.py`` / ``evaluation_utils.py main``).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.time_measurement \\
        evaluation/config/time_measurement.json [--device cpu]

Methods (the reference's CLI set, evaluation_utils.py:390-456):
``default`` (single kNN per family), ``defaultpv`` (post-verified
variants), ``sizedependend`` (exact vs PQ knn_in over growing random
target-set sizes ``basis·n + k``), ``postverification`` (PQ / IVFADC
post-verified at growing shortlist factors ``basis·n + k``), ``batch``
(batched IVFADC), ``batch-precision`` (batch + precision vs exact).
Results printed as JSON.

Config keys for the sweep modes: ``resolution`` (number of sizes/factors,
default 10) and ``basis`` (step, default 100).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.evaluation.harness import (
    batch_measurement, calculate_precision, measurement)
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _mean_s(eng, queries, k, fn) -> dict:
    times = list(measurement(eng, queries, k, fn)["times"].values())
    return {"mean_s": sum(times) / len(times)}


def _overlap(exact, approx) -> float:
    ex_set = {t for (t, _s) in exact}
    ap_set = {t for (t, _s) in approx}
    return len(ex_set & ap_set) / max(len(ex_set), 1)


def main(config_path: str,
         device: torch.device | str | None = None) -> dict:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    k = cfg.get_value_or("k", 5)
    n_q = cfg.get_value_or("query_sample", 20)
    method = cfg.get_value_or("method", "default")
    queries = sample_words(eng, n_q, cfg.get_value_or("seed", 0))

    out: dict = {"method": method, "k": k, "queries": len(queries)}
    if method == "default":
        for fn in ("k_nearest_neighbour", "k_nearest_neighbour_pq",
                   "k_nearest_neighbour_ivfadc"):
            out[fn] = _mean_s(eng, queries, k, fn)
    elif method == "defaultpv":
        for fn in ("k_nearest_neighbour_pq_pv",
                   "k_nearest_neighbour_ivfadc_pv"):
            out[fn] = _mean_s(eng, queries, k, fn)
    elif method == "sizedependend":
        # target-set sizes basis·n + k over one global id shuffle
        # (size_dependend_measurement, evaluation_utils.py:357-368)
        resolution = cfg.get_value_or("resolution", 10)
        basis = cfg.get_value_or("basis", 100)
        rng = np.random.default_rng(cfg.get_value_or("seed", 0))
        ids = rng.permutation(eng.store.size)
        out["sizes"] = {}
        for n_ in range(resolution):
            size = basis * n_ + k
            targets = [int(i) for i in ids[:size]]
            t_ex, t_pq, prec = [], [], []
            for w in queries:
                t0 = time.perf_counter()
                exact = eng.knn_in_exact(w, k, targets)
                t_ex.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                approx = eng.knn_in_pq(w, k, targets)
                t_pq.append(time.perf_counter() - t0)
                prec.append(_overlap(exact, approx))
            out["sizes"][size] = {
                "exact_mean_s": sum(t_ex) / len(t_ex),
                "pq_mean_s": sum(t_pq) / len(t_pq),
                "precision": sum(prec) / len(prec)}
    elif method == "postverification":
        # shortlist factors basis·n + k (post_verif_measurement,
        # evaluation_utils.py:347-355); the reference's factor is an
        # absolute candidate count, mapped to pvf = factor // k
        resolution = cfg.get_value_or("resolution", 10)
        basis = cfg.get_value_or("basis", 100)
        exact = {w: eng.k_nearest_neighbour(w, k) for w in queries}
        saved_pvf = eng.params.pvf
        out["factors"] = {}
        try:
            for n_ in range(resolution):
                factor = basis * n_ + k
                eng.set_pvf(max(1, factor // k))
                row: dict = {}
                for fn in ("k_nearest_neighbour_pq_pv",
                           "k_nearest_neighbour_ivfadc_pv"):
                    res = measurement(eng, queries, k, fn)
                    times = list(res["times"].values())
                    prec = [_overlap(exact[w], res["results"][w])
                            for w in queries]
                    row[fn] = {"mean_s": sum(times) / len(times),
                               "precision": sum(prec) / len(prec)}
                out["factors"][factor] = row
        finally:
            eng.set_pvf(saved_pvf)
    elif method == "batch":
        b = batch_measurement(eng, queries, k)
        out["batch"] = {"time_s": b["time"], "per_query_s": b["per_query"]}
    elif method == "batch-precision":
        b = batch_measurement(eng, queries, k)
        exact = eng.knn_batch_exact(queries, k)
        out["batch"] = {"time_s": b["time"],
                        "precision": calculate_precision(b["results"],
                                                         exact)}
    else:
        raise SystemExit(f"unknown method {method!r}")
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    config_cli(main, __doc__)
