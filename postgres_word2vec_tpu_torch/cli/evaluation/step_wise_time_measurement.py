"""Stage breakdown vs query-set size, from the TRACK-named stage metrics
of the in-process tracker.

The port's ``evaluation/step_wise_time_measurement.py`` (the reference's
``step_wise_time_measurement.py``).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.step_wise_time_measurement \\
        evaluation/config/step_wise.json [--device cpu]

Config: ``k``, ``query_steps`` (list of query-set sizes),
``target_sample``, optional ``out`` (a JSON file for the records) +
engine keys.

Each (method, query count) pair runs once warm and then once with the
TRACK capture, the reference's warm-backend numbers. The first call's
extra wall time is reported as ``compile_s``, under the JAX package's
key; on the card it is the first call's overhead, including a kernel
build at the first launch of the process (the kernels compile at first
use) and the allocator's first growth.
"""

from __future__ import annotations

import json
import time

import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> list[dict]:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    eng.set_track_stages(True)   # the full 5-stage TRACK breakdown
    k = cfg.get_value_or("k", 5)
    targets = sample_words(eng, cfg.get_value_or("target_sample", 5000),
                           cfg.get_value_or("seed", 0) + 1)
    # both in-set batch families the reference breaks down: the IVPQ
    # probe (ivpq_search_in.c TRACK sites) and the PQ in-set batch whose
    # data_retrieval_time is the target-code gather (freddy.c:527-651)
    methods = {"ivpq": eng.knn_in_ivpq_batch, "pq": eng.knn_in_pq_batch}
    out = []
    for n_q in cfg.get_value_or("query_steps", [10, 50, 100]):
        queries = sample_words(eng, n_q, cfg.get_value_or("seed", 0))
        for mname, fn in methods.items():
            t0 = time.perf_counter()
            fn(queries, k, targets)
            cold = time.perf_counter() - t0
            eng.tracker.clear_track()
            t0 = time.perf_counter()
            fn(queries, k, targets)
            wall = time.perf_counter() - t0
            stages = eng.tracker.track_results()
            inner = sum(stages.get("total_time", [0.0]))
            out.append({"method": mname, "queries": n_q,
                        "targets": len(targets),
                        "wall_s": wall, "inner_s": inner,
                        "compile_s": max(cold - wall, 0.0),
                        "cold_wall_s": cold,
                        "interface_overhead_s": wall - inner,
                        "stages": stages})
    out_path = cfg.get_value_or("out", "")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    config_cli(main, __doc__)
