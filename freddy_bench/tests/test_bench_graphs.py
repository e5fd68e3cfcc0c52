"""The reader of ``join_graph_share``: the share of a join cell's
statements whose first budget round replayed its captured graphs, from the
program's ``join_graph_rounds`` counter; nothing outside a /knn_join cell
or from a program without the counter."""

import json
import types
from pathlib import Path

import pytest

from freddy_bench import manifest

REPO = Path(__file__).resolve().parents[2]


def ctx_of(tracker: dict, endpoint: str = "/knn_join"):
    return types.SimpleNamespace(workload={"endpoint": endpoint},
                                 counters={"tracker": tracker})


def test_graph_share_is_the_share_of_statements_in_percent():
    read = manifest.metric_reader("join_graph_share")
    assert read(ctx_of({"join_graph_rounds": [1.0, 0.0, 1.0, 1.0]})) == \
        pytest.approx(75.0)
    assert read(ctx_of({"join_graph_rounds": [1.0] * 9})) == 100.0
    assert read(ctx_of({"join_graph_rounds": [0.0]})) == 0.0
    assert read(ctx_of({})) is None                 # a program without it
    assert read(ctx_of({"join_graph_rounds": [1.0]}, "/knn")) is None


def test_both_join_cells_report_it():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in ("ivpq_join_100k_c4", "ivpq_short_join_100k_c4"):
        names = {m["name"] for m in manifest.cell_metrics(bench, cell, True)}
        assert "join_graph_share" in names, cell
