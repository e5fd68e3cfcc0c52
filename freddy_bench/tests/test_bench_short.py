"""The short-codes join's parts of the benchmark: the readers of its two
counters, its roofline work beside the long codes', and its reference,
which imports nothing of the program."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from freddy_bench import manifest

REPO = Path(__file__).resolve().parents[2]


def ctx_of(tracker: dict, endpoint: str = "/knn_join"):
    return types.SimpleNamespace(workload={"endpoint": endpoint},
                                 counters={"tracker": tracker})


def test_short_share_is_the_share_of_statements_in_percent():
    read = manifest.metric_reader("join_short_share")
    assert read(ctx_of({"join_short_codes": [1.0, 1.0, 0.0, 1.0]})) == \
        pytest.approx(75.0)
    assert read(ctx_of({"join_short_codes": [0.0]})) == 0.0
    assert read(ctx_of({})) is None                 # a program without it
    assert read(ctx_of({"join_short_codes": [1.0]}, "/knn")) is None


def test_slots_per_query_is_the_windows_mean():
    read = manifest.metric_reader("join_slots_per_query")
    assert read(ctx_of({"join_scan_slots": [131072.0, 4096.0]})) == \
        pytest.approx(67584.0)
    assert read(ctx_of({})) is None
    assert read(ctx_of({"join_scan_slots": [1.0]}, "/knn")) is None


def _work(operation: str, alpha: int, statements: int = 3):
    cell = "ivpq_short_join_100k_c4"
    wl = manifest.load_json("workloads", cell)
    wl["setup"] = [{"path": "/config", "body": {"set_alpha": alpha,
                                                 "set_pvf": 20}}]
    ctx = types.SimpleNamespace(workload=wl,
                                config=manifest.load_json("configs",
                                                          wl["config"]),
                                latencies=[0.1] * statements)
    return manifest.work_function(operation)(ctx)


def test_short_codes_work_differs_from_the_long_by_the_pair_table():
    """Per query the fused pair table, (m/2)·ks² floats and adds; per
    scanned row 15 two-byte codes (the 30 bytes of the long form) and 15
    adds (for 30)."""
    b_s, o_s, kind = _work("ivpq_join_short", 10000)
    b_l, o_l, _ = _work("ivpq_join", 10000)
    nq, rows = 3 * 1024, 3 * 1024 * 10000 * 5
    assert kind == "fp32"
    assert b_s - b_l == nq * 15 * 32 * 32 * 4
    assert o_s - o_l == pytest.approx(nq * 15 * 32 * 32 - rows * 15)


def test_the_short_cell_sits_beside_the_long_one():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    short = manifest.load_json("configs", "gnews3m_ivpq_short")
    long_ = manifest.load_json("configs", "gnews3m_ivpq_join")
    assert short["build"] == long_["build"]
    assert (short["rows"], short["dim"]) == (long_["rows"], long_["dim"])
    wl = manifest.load_json("workloads", "ivpq_short_join_100k_c4")
    body = wl["setup"][0]["body"]
    assert body["set_long_codes_threshold"] == 0
    assert body["set_alpha"] == wl["targets"]["size"] // (2 * wl["body"]["k"])
    names = {m["name"] for m in
             manifest.cell_metrics(bench, "ivpq_short_join_100k_c4", True)}
    assert {"join_short_share", "join_slots_per_query",
            "kernel_roofline.join"} <= names
    assert "join_short_share" not in {
        m["name"] for m in manifest.cell_metrics(bench, "ivpq_join_100k_c4",
                                                 True)}


def test_the_join_reference_imports_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c",
         "import freddy_bench.reference.ivpq_join, sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "postgres_word2vec_tpu",
                      "postgres_word2vec_tpu_torch"}
