"""The manifest and the harness's lookup by name, on the CPU."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from freddy_bench import manifest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")


def test_names_and_units_use_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert _line(w["why"]) and w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_every_moves_is_reported_by_the_cells_listed():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            reported = {e["name"] for e in
                        manifest.cell_metrics(BENCH, cell, trace=False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.cell_metrics(BENCH, w["name"],
                                                         False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(BENCH, w["name"], True)


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_parts_are_found_by_name():
    for c in BENCH["configs"]:
        cfg = manifest.load_json("configs", c["name"])
        assert (REPO / c["file"]).is_file()
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        wl = manifest.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert callable(manifest.work_function(wl["operation"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_a_new_file_is_picked_up_without_an_edit(tmp_path, monkeypatch):
    root = tmp_path / "freddy_bench"
    shutil.copytree(manifest.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "gnews3m_ivfadc.json").read_text())
    cfg["name"] = "new_config"
    (root / "configs" / "new_config.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "exact_knn_c32.json").read_text())
    wl["config"] = "new_config"
    (root / "workloads" / "new_cell.json").write_text(json.dumps(wl))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    monkeypatch.setattr(manifest, "ROOT", root)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new_cell", "config": "new_config",
                               "traffic": "new_cell", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device (H100)", "moves": "setup_s",
                               "workloads": ["new_cell"]})
    assert manifest.load_json("configs", "new_config")["name"] == \
        "new_config"
    assert manifest.load_json("workloads", "new_cell")["config"] == \
        "new_config"
    assert manifest.metric_reader("new_metric")(None) == 42.0
    per_layer = {m["name"] for m in
                 manifest.cell_metrics(bench, "new_cell", True)}
    assert per_layer == {"new_metric"}


def test_a_name_cannot_leave_its_folder():
    with pytest.raises(ValueError):
        manifest.load_json("configs", "../BENCHMARK")


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_reference_import_no_jax():
    top = _loaded_after(
        "import freddy_bench.run, freddy_bench.harness, freddy_bench.check,"
        " freddy_bench.trace, freddy_bench.control, freddy_bench.roofline\n"
        "import freddy_bench.reference.knn, freddy_bench.reference.ivfadc,"
        " freddy_bench.reference.lowp\n"
        "from freddy_bench import manifest\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[manifest.metric_reader(m['name']) for m in"
        " b['end_to_end'] + b['per_layer']]\n"
        "[manifest.work_function(manifest.load_json('workloads',"
        " w['name'])['operation']) for w in b['workloads']]\n")
    assert not top & {"jax", "jaxlib", "flax", "postgres_word2vec_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    top = _loaded_after(
        "import freddy_bench.reference.knn, freddy_bench.reference.ivfadc,"
        " freddy_bench.reference.lowp, freddy_bench.check,"
        " freddy_bench.traffic.synth")
    assert not top & {"jax", "jaxlib", "flax", "postgres_word2vec_tpu",
                      "postgres_word2vec_tpu_torch"}
