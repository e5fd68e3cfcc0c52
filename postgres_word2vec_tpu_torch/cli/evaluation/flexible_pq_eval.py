"""Short codes (fused-pair LUT) vs long codes in the IVPQ join.

The port's ``evaluation/flexible_pq_eval.py`` (the reference's
``flexible_pq_eval.py``: toggles ``set_long_codes_threshold(0 | 1e7)`` and
sets alpha = |targets| / (2k), flexible_pq_eval.py:63-71).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.flexible_pq_eval \\
        evaluation/config/flexible_pq_3M.json [--device cpu]

Config: ``k``, ``query_sample``, ``target_steps``, ``num_iters`` + engine
keys.
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.evaluation.harness import (
    calculate_precision, get_exact_results)
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> list[dict]:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    k = cfg.get_value_or("k", 5)
    queries = sample_words(eng, cfg.get_value_or("query_sample", 50),
                           cfg.get_value_or("seed", 0))
    out = []
    for n_targets in cfg.get_value_or("target_steps", [1000, 2000, 4000]):
        targets = sample_words(eng, n_targets,
                               cfg.get_value_or("seed", 0) + 1)
        eng.set_alpha(max(1, len(targets) // (2 * k)))  # ref: size/(2k)
        exact = get_exact_results(eng, queries, k, targets)
        rec = {"targets": len(targets), "alpha": eng.params.alpha}
        num_iters = cfg.get_value_or("num_iters", 1)  # ref: num_iters
        for label, threshold in (("long_codes", 1e7), ("short_codes", 0.0)):
            eng.set_long_codes_threshold(threshold)
            times = []
            for _ in range(num_iters):
                t0 = time.perf_counter()
                rows = eng.knn_in_ivpq_batch(queries, k, targets)
                times.append(time.perf_counter() - t0)
            rec[label] = {
                "time_s": min(times), "times_s": times,
                "precision": calculate_precision(rows, exact)}
        out.append(rec)
    eng.set_long_codes_threshold(1e7)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    config_cli(main, __doc__)
