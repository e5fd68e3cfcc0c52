"""The README's kNN-join time / precision figure.

The port's ``evaluation/time_precision_eval.py`` (the reference's
``time_precision_eval.py``: Baseline / PQ / Exact / PQ + PV over alphas,
pvf sweep).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.time_precision_eval \\
        evaluation/config/time_precision_eval.json [--device cpu]

Config: ``k``, ``query_sample``, ``target_sample``, ``alphas``, ``pvfs``,
``methods``, ``statistics_domain``, ``plot_path`` + engine keys (see
``cli/_common.py``). Prints the JSON records, with the PQ
``knn_in_pq_batch`` baseline the reference plots. With ``plot_path`` it
writes the self-contained HTML report beside it (``<plot_path>.html``,
no dependency) and the PNG where matplotlib imports; where it does not,
it says so on stderr and goes on.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.evaluation import html_report
from postgres_word2vec_tpu_torch.evaluation.harness import (
    calculate_precision, get_exact_results, time_precision_sweep)
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _plot(records: list[dict], plot_path: str, k: int, n_targets: int
          ) -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {plot_path} not written "
              "(the HTML report is)", file=sys.stderr)
    else:
        from postgres_word2vec_tpu_torch.evaluation.plots import (
            plot_time_precision)
        plot_time_precision(records, plot_path)
    # the interactive twin (the reference's plotly-offline HTML,
    # evaluation_utils.py:240-344), a self-contained SVG report
    html_report.write_html_report(
        str(Path(plot_path).with_suffix(".html")),
        [html_report.figure_from_records(records)],
        title="kNN-join time / precision trade-off",
        subtitle=f"k={k}, {n_targets} targets — one curve per "
                 "method; hover for the per-point config")


def main(config_path: str,
         device: torch.device | str | None = None) -> list[dict]:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    k = cfg.get_value_or("k", 5)
    queries = sample_words(eng, cfg.get_value_or("query_sample", 100),
                           cfg.get_value_or("seed", 0))
    targets = sample_words(eng, cfg.get_value_or("target_sample", 10_000),
                           cfg.get_value_or("seed", 0) + 1)
    if cfg.get_value_or("statistics_domain", False):
        # per-cell frequency statistics over the target domain: the
        # reference's create_statistics + set_statistics_table set-up
        # (freddy--0.0.1.sql:150-186) its figure ran with
        eng.create_statistics("targets", targets)

    records = time_precision_sweep(
        eng, queries, k, targets,
        alphas=tuple(cfg.get_value_or("alphas", [50, 100, 150, 200])),
        pvfs=tuple(cfg.get_value_or("pvfs", [3, 5, 10, 15])),
        methods=tuple(cfg.get_value_or("methods", [0, 1, 2])))

    # the PQ in-set baseline curve (pq_search_in_batch)
    exact = get_exact_results(eng, queries, k, targets)
    t0 = time.perf_counter()
    rows = eng.knn_in_pq_batch(queries, k, targets)
    records.append({"method": "baseline_pq_in_batch",
                    "time_s": time.perf_counter() - t0,
                    "precision": calculate_precision(rows, exact)})
    plot_path = cfg.get_value_or("plot_path", "")
    if plot_path:
        _plot(records, plot_path, k, len(targets))
    print(json.dumps(records, indent=2))
    return records


if __name__ == "__main__":
    config_cli(main, __doc__)
