"""The port's evaluation harness, reports, measurement helpers, profiling
and configuration against the JAX package (CPU).

The harness runs on the JAX evaluation tests' engine (tests/
test_evaluation.py:9-17), built by the JAX package, saved and loaded in
the port: precision, retrieved counts, predicted counts and confidence
fractions are equal (precisions and fractions exactly, the harness's
float64 means within 1e-9); timings are not compared. The HTML report
writes the same figure JSON as JAX's for the same records."""

import json

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu import VectorStore as JStore
from postgres_word2vec_tpu.evaluation import harness as jharness
from postgres_word2vec_tpu.evaluation import html_report as jhtml
from postgres_word2vec_tpu.evaluation.benchutil import (
    host_exact_topk as jhost_exact_topk)

from postgres_word2vec_tpu_torch import Freddy
from postgres_word2vec_tpu_torch.evaluation import benchutil, harness
from postgres_word2vec_tpu_torch.evaluation import html_report, plots
from postgres_word2vec_tpu_torch.utils import config, profiling

QUERIES = ["w1", "w2", "w3", "w4"]
TARGETS = [f"w{i}" for i in range(300)]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(600, 24)).astype(np.float32)
    jeng = JFreddy.build(JStore.from_arrays([f"w{i}" for i in range(600)],
                                            vecs),
                         seed=0, pq_m=6, pq_k=16, ivfadc_m=6, ivfadc_k=16,
                         k_coarse=12, ivpq_m=6, ivpq_k=8, ivpq_k_coarse=4,
                         train_size=None, iters=6)
    path = tmp_path_factory.mktemp("harness")
    jeng.save(path)
    return jeng, Freddy.load(path, device="cpu")


def _rows(rows):
    return [(q, w) for q, w, _ in rows]


def test_calculate_precision_matches_jax():
    exact = [("a", "x", 1.0), ("a", "y", 0.9), ("b", "x", 0.8),
             ("b", "z", 0.7)]
    approx = [("a", "x", 1.0), ("a", "q", 0.5), ("b", "x", 0.8)]
    for a, e in ((approx, exact), (exact, exact), ([], exact), (exact, [])):
        assert harness.calculate_precision(a, e) == \
            jharness.calculate_precision(a, e)


def test_exact_results_and_measurements_match_jax(engines):
    jeng, eng = engines
    got = harness.get_exact_results(eng, QUERIES, 5, TARGETS)
    want = jharness.get_exact_results(jeng, QUERIES, 5, TARGETS)
    assert _rows(got) == _rows(want)
    m, jm = (h.measurement(e, QUERIES[:2], 3) for h, e in
             ((harness, eng), (jharness, jeng)))
    assert m["times"].keys() == jm["times"].keys()
    for w in QUERIES[:2]:
        assert [r[0] for r in m["results"][w]] == \
            [r[0] for r in jm["results"][w]]
    b, jb = (h.batch_measurement(e, QUERIES, 3, TARGETS) for h, e in
             ((harness, eng), (jharness, jeng)))
    assert b.keys() == jb.keys() and _rows(b["results"]) == \
        _rows(jb["results"])
    t, jt = (h.create_track_statistics(e, "knn_in_ivpq_batch", QUERIES, 3,
                                       TARGETS)
             for h, e in ((harness, eng), (jharness, jeng)))
    assert t.keys() == jt.keys()
    assert t["retrieved"] == jt["retrieved"]
    assert t["target_count"] == jt["target_count"]


def test_time_precision_sweep_matches_jax(engines):
    jeng, eng = engines
    kw = dict(alphas=(10, 100), pvfs=(3, 5), methods=(0, 1, 2), repeats=1)
    got = harness.time_precision_sweep(eng, QUERIES, 5, TARGETS, **kw)
    want = jharness.time_precision_sweep(jeng, QUERIES, 5, TARGETS, **kw)
    keys = ("method", "alpha", "pvf", "precision")
    assert [{k: r[k] for k in keys} for r in got] == \
        [{k: r[k] for k in keys} for r in want]
    assert all(r.keys() == w.keys() for r, w in zip(got, want))
    assert (eng.params.alpha, eng.params.pvf, eng.params.method) == (
        jeng.params.alpha, jeng.params.pvf, jeng.params.method)


def test_confidence_and_target_count_eval_match_jax(engines):
    jeng, eng = engines
    for e in (jeng, eng):
        e.set_alpha(10)
    try:
        got = harness.confidence_eval(eng, QUERIES, 3, TARGETS,
                                      confidences=(0.05, 0.5, 0.95))
        want = jharness.confidence_eval(jeng, QUERIES, 3, TARGETS,
                                        confidences=(0.05, 0.5, 0.95))
        assert [(r["confidence"], r["fraction_met"]) for r in got] == \
            [(r["confidence"], r["fraction_met"]) for r in want]
        np.testing.assert_allclose([r["mean_retrieved"] for r in got],
                                   [r["mean_retrieved"] for r in want],
                                   rtol=1e-9)
        got = harness.target_count_eval(eng, QUERIES, 3, TARGETS)
        want = jharness.target_count_eval(jeng, QUERIES, 3, TARGETS)
    finally:
        for e in (jeng, eng):
            e.set_alpha(3)
    assert got["retrieved"] == want["retrieved"]
    np.testing.assert_allclose(got["predicted"], want["predicted"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["mean_abs_rel_divergence"],
                               want["mean_abs_rel_divergence"], rtol=1e-5)


def test_html_report_writes_the_jax_figure_json(tmp_path):
    records = [{"method": m, "alpha": a, "pvf": p, "time_s": 0.01 * (a + p),
                "per_query_ms": 1.0, "precision": 0.5 + 0.001 * a + m / 10}
               for m in (0, 1, 2) for a in (50, 100) for p in (3, 5)]
    records.append({"method": "baseline_pq_in_batch", "time_s": 0.2,
                    "precision": 0.4})
    fig, jfig = (h.figure_from_records(records) for h in (html_report,
                                                          jhtml))
    assert fig.to_json() == jfig.to_json()
    out = html_report.write_html_report(tmp_path / "r.html", [fig],
                                        title="t <x>", subtitle="s")
    jout = jhtml.write_html_report(tmp_path / "j.html", [jfig],
                                   title="t <x>", subtitle="s")
    assert out.read_text() == jout.read_text()


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    recs = [{"method": 0, "alpha": 50, "time_s": 0.1, "precision": 0.5},
            {"method": 1, "alpha": 50, "time_s": 0.2, "precision": 0.9}]
    for path in (plots.plot_time_precision(recs, tmp_path / "tp.png"),
                 plots.plot_stage_breakdown(
                     [{"queries": 10, "inner_s": 0.1,
                       "interface_overhead_s": 0.05}], tmp_path / "sb.png"),
                 plots.plot_measurement_bars({"a": 0.1, "b": 0.2},
                                             tmp_path / "mb.png")):
        assert path.read_bytes()[:4] == b"\x89PNG"


def test_benchutil_host_topk_and_timers_match_jax():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(517, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    chunks = [table[:256], torch.from_numpy(table[256:512]), table[512:]]
    d, ids = benchutil.host_exact_topk(q, chunks, 10)
    jd, jids = jhost_exact_topk(q, [np.asarray(c) for c in chunks], 10)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-6)
    x = torch.ones(64, 64)
    assert benchutil.timeit_piped(lambda: x @ x, iters=3) > 0
    benchutil.materialize((x, [x]))
    benchutil.log_mem("cpu")          # nothing to report without a card


def test_profiling_on_the_cpu(tmp_path):
    assert profiling.device_memory_stats() == {}
    with profiling.device_trace(tmp_path / "tr") as d:
        with profiling.annotate("span"):
            torch.ones(8, 8).sum()
    trace = json.loads((tmp_path / "tr" / profiling.TRACE_FILE).read_text())
    assert d == str(tmp_path / "tr")
    assert any(e.get("name") == "span" for e in trace["traceEvents"])


def test_serving_busy_share_averages_nvidia_smi_samples():
    """A serving window's busy share: the mean of ``nvidia-smi``'s
    utilization samples (percent, one a line) as a share; no sample is an
    error, never a share of 0."""
    from postgres_word2vec_tpu_torch.evaluation import serving_bench

    assert serving_bench.utilization_share("87\n90\n 0\n") == (
        pytest.approx(0.59))
    with pytest.raises(RuntimeError, match="no utilization sample"):
        serving_bench.utilization_share("\n")


def test_configuration_and_logger_round_trip(tmp_path):
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps({"a": 1, "b": [2, 3]}))
    cfg = config.Configuration(cfg_path)
    assert cfg.get_value("b") == [2, 3] and cfg.has_key("a")
    assert not cfg.has_key("z") and cfg.get_value_or("z", 7) == 7
    with pytest.raises(KeyError):
        cfg.get_value("z")
    log = config.Logger(log_to_file=True, path=tmp_path / "l.log")
    log.log(config.WARNING, "first")
    log.log(config.INFO, "second")
    log.close()
    lines = (tmp_path / "l.log").read_text().splitlines()
    assert [ln.split(" ", 2)[2] for ln in lines] == ["WARNING: first",
                                                     "INFO: second"]
