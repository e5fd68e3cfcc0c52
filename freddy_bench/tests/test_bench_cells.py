"""Each cell's whole run at a toy size on the CPU, in a process of its
own: the command's last line; the control, which the comparison must
reject; and the timed path broken underneath, which must read
``correct: false``. Only the harness's look for a card is skipped."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FILES = sorted(p.stem for p in (REPO / "freddy_bench" / "workloads")
               .glob("*.json"))
SEED = 2 ** 31 + 4321
#: cells whose files are here but which BENCHMARK.json leaves out (their
#: runs spread too far); the tests add the entries a later PR would add
LEFT_OUT = [f for f in FILES if f not in CELLS]
#: the /knn cells' metrics, which BENCHMARK.json leaves out with them
KNN_METRICS = {
    "end_to_end": [{"name": "knn_qps", "unit": "queries/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": "x", "better": "lower", "source": s,
                   "layer": "x", "moves": "knn_qps"}
                  for n, s in (("knn_p95_ms", "host_clock"),
                               ("fe_batch_mean.knn", "program_counter"),
                               ("runner_host_ms.knn", "program_span"),
                               ("search_ms.knn", "program_span"),
                               ("kernel_roofline.knn", "device_trace"),
                               ("device_idle.knn", "device_trace"))]}


def _endpoint(cell: str) -> str:
    return json.loads((REPO / "freddy_bench" / "workloads" / f"{cell}.json")
                      .read_text())["endpoint"]


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """A directory whose BENCHMARK.json names every cell file here: the
    committed manifest plus the left-out cells' entries (and the /knn
    cells' metrics), each added to the metrics of its endpoint."""
    d = tmp_path_factory.mktemp("bench")
    b = json.loads(json.dumps(BENCH))
    knn = [f for f in LEFT_OUT if _endpoint(f) == "/knn"]
    for kind, ms in KNN_METRICS.items():
        b[kind] += [dict(m, workloads=list(knn)) for m in ms]
    for f in LEFT_OUT:
        wl = json.loads((REPO / "freddy_bench" / "workloads" / f"{f}.json")
                        .read_text())
        b["workloads"].append({"name": f, "config": wl["config"],
                               "traffic": f, "chips": 1, "why": wl["why"]})
        for m in b["end_to_end"] + b["per_layer"]:
            ws = m.get("workloads", [f])
            if f not in ws and _endpoint(ws[0]) == wl["endpoint"]:
                ws.append(f)
    (d / "BENCHMARK.json").write_text(json.dumps(b))
    return d


def _overrides(cell: str) -> dict:
    """The cell's shapes, shrunk so a CPU run takes seconds."""
    wl = json.loads((REPO / "freddy_bench" / "workloads" / f"{cell}.json")
                    .read_text())
    ov = {"config": {"rows": 16384},
          "workload": {"clients": 2, "warm_seconds": 0.3, "sample_p": 0.5}}
    if wl["config"] == "gnews3m_ivfadc":
        ov["config"]["build"] = dict(
            with_pq=False, with_ivfadc=True, with_ivpq=False, ivfadc_m=12,
            ivfadc_k=32, k_coarse=64, train_size=8192, iters=3)
    else:
        ov["config"]["build"] = dict(
            with_pq=False, with_ivfadc=False, with_ivpq=True, ivpq_m=30,
            ivpq_k=16, ivpq_k_coarse=8, train_size=8192, iters=3)
        ov["workload"]["query_words"] = 64
        t = dict(wl["targets"])
        if t["size"] != "all":
            t["size"] = 2000
        ov["workload"]["targets"] = t
    return ov


def _run(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_every_cell_has_its_file():
    assert set(CELLS) <= set(FILES)
    assert LEFT_OUT == ["exact_knn_c32", "ivfadc_pv_knn_c32",
                        "ivpq_join_3m_c4"]


@pytest.mark.parametrize("cell", FILES)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_a_well_formed_last_line(cell, trace, bench_dir):
    p = _run(
        "import sys\nfrom freddy_bench import harness\n"
        f"sys.exit(harness.main(['--workload', {cell!r}, '--seed',"
        f" '{SEED}', '--seconds', '1', '--trace', '{trace}'],"
        f" device='cpu', overrides={_overrides(cell)!r}))", bench_dir)
    assert p.returncode == 0, p.stderr[-3000:]
    r = _last_json(p.stdout)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    bench = json.loads((bench_dir / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    if trace:
        # no card here: the device metrics find nothing to read
        layer = {m["name"]: m for m in bench["per_layer"]}
        got = set(r["metrics"])
        assert got and all(layer[m]["source"] != "device_trace"
                           for m in got)
    else:
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 for v in r["metrics"].values())
    lines = p.stderr.strip().splitlines()
    assert lines[-1].startswith("check ")


@pytest.mark.parametrize("cell", FILES)
def test_the_control_fails_the_cells_limits(cell, bench_dir):
    p = _run(
        "import json\nfrom freddy_bench import check, harness, manifest\n"
        f"r = harness.run({cell!r}, {SEED}, 1.0, False, device='cpu',"
        f" overrides={_overrides(cell)!r}, control=True)\n"
        f"lim = check.limits_of(manifest.load_json('workloads', {cell!r})"
        "['check'])\n"
        "print(json.dumps({'program': check.judge(r['numbers'], lim)[0],"
        " 'control': check.judge(r['control'], lim)[0],"
        " 'numbers': r['numbers'], 'ctl': r['control']}))", bench_dir)
    assert p.returncode == 0, p.stderr[-3000:]
    r = _last_json(p.stdout)
    assert r["program"] is True, r
    assert r["control"] is False, r


#: faults planted in the timed path, where the answer is produced
FAULTS = {
    # half of a batch left out: its rows answered with the other half's
    "half_batch": """
def fault(d, i):
    h = d.shape[0] // 2
    if h:
        d, i = d.clone(), i.clone()
        d[h:2 * h], i[h:2 * h] = d[:h].clone(), i[:h].clone()
    return d, i
""",
    # one answer altered: each query's best row replaced by another row
    "altered": """
def fault(d, i):
    i = i.clone()
    i[:, 0] = (i[:, 0] + 1) % N
    return d, i
""",
}


def _patch(cell: str) -> str:
    wl = json.loads((REPO / "freddy_bench" / "workloads" / f"{cell}.json")
                    .read_text())
    if wl["endpoint"] == "/knn":
        return ("from postgres_word2vec_tpu_torch.api import Freddy\n"
                "orig = Freddy.knn_matrix\n"
                "def broken(self, q, k):\n"
                "    return fault(*orig(self, q, k))\n"
                "Freddy.knn_matrix = broken\n")
    return ("from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex\n"
            "orig = IVPQIndex.search_join\n"
            "def broken(self, *a, **kw):\n"
            "    d, i, *rest = orig(self, *a, **kw)\n"
            "    return (*fault(d, i), *rest)\n"
            "IVPQIndex.search_join = broken\n")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", FILES)
def test_a_broken_timed_path_reads_incorrect(cell, fault, bench_dir):
    p = _run(
        "import json\nfrom freddy_bench import harness\n"
        "N = 16384\n" + FAULTS[fault] + _patch(cell) +
        f"r = harness.run({cell!r}, {SEED}, 1.0, False, device='cpu',"
        f" overrides={_overrides(cell)!r})\n"
        "print(json.dumps(r))", bench_dir)
    assert p.returncode == 0, p.stderr[-3000:]
    r = _last_json(p.stdout)
    assert r["correct"] is False, r["checks"]

