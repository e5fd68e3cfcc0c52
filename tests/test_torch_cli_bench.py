"""The port's benchmark driver (``postgres_word2vec_tpu_torch.cli.bench``)
and its table renderer (``cli.evaluation.gen_readme_table``) against the
repository's ``bench.py`` and ``evaluation/gen_readme_table.py``, on the
CPU.

``bench.py`` runs from a copy in the test's temporary directory, so that
its detail file (written beside the script) lands there; the tracked
``BENCH_LOCAL_latest.json`` is hashed before and after. Both drivers run
at SMALL with 12,288 rows (the SMALL join needs 500 + 10,000) of width 60
(divisible by m 12, 30 and 60), k-means at 3 iterations; both generators
return the same numpy rows and the port loads the indexes the JAX script
built (``same_data``, ``SameIndexes``); both ``timeit``s make one call and
report a fixed time (its spread recorded), so every per-query time
derived from one is equal and the headline rule, which picks by time,
sees the same times. Then:

- the detail records have the same rows and keys; every value but the
  measured times (``TIMES``) and the ``note`` strings agrees, floats to
  1e-5 (recalls, multiples of 1/1280, are then equal), but the recalls
  of the int8-LUT dense scan rows (``TIES``), whose ids are held equal up
  to ties; the one line has the same keys and the same ``metric`` row;
- on the CPU the JAX script skips ``exact_fused`` (it runs only where
  ``supports_pallas``) and its Pallas int8 scans have no compiled CPU
  form: the test runs them in interpret mode, and holds the port's
  ``exact_fused`` row (K1's plain version on the CPU) to the Pallas
  ``fused_exact_top_k`` in interpret mode on the same rows;
- SMALL never reaches the 1M / 3M joins, so the port's large-target rows
  are held, at one target count below N and one equal to N, to the JAX
  ``exact_top_k`` / ``exact_top_k_in`` and ``search_join`` on the same
  index.
"""

import functools
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.evaluation import benchutil as jbenchutil
from postgres_word2vec_tpu.models import exact as jexact
from postgres_word2vec_tpu.models.ivfadc import IVFADCIndex as JIVFADC
from postgres_word2vec_tpu.models.ivpq import IVPQIndex as JIVPQ
from postgres_word2vec_tpu.models.ivpq import (
    build_statistics as jbuild_statistics)
from postgres_word2vec_tpu.models.pq import PQIndex as JPQ
from postgres_word2vec_tpu.ops import pallas_kernels as pk
from postgres_word2vec_tpu_torch.cli import bench
from postgres_word2vec_tpu_torch.cli.evaluation import gen_readme_table
from postgres_word2vec_tpu_torch.evaluation import benchutil
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from test_torch_parity_util import (REPO, SameIndexes,  # noqa: F401
                                    assert_same_top_k, jax_script, rows,
                                    same_data)

N, D, ITERS = 12_288, 60, 3
TOL = 1e-5
#: the fixed time both packages' timeit report, seconds
T = 0.5
#: fields measured with the host's clock (and the method guard's ratio of
#: two of them, with its verdict)
TIMES = {"total_s", "trials_s", "qps", "build_s", "device_ms",
         "terms_per_s", "ratio", "ok"}
#: the one line's fields derived from those
LINE_TIMES = {"join_pv_a200_qps", "join_3M_qps", "join_exact_3M_qps",
              "insert_tps"}
JAX_RECORD = REPO / "BENCH_LOCAL_latest.json"
#: the rows whose recalls differ by a tie: the int8-LUT dense scan's
#: distances are integer sums times one scale a query, so rows tie often,
#: and the JAX top-k keeps the lowest id of a tie where torch's keeps any
#: (the re-ranked pq_pv_20_int8 does not tie); their ids are held equal up
#: to ties instead
TIES = ("pq_scan_int8", "pq_scan_int8_b256")


def sha256(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def fixed_timeit(bu):
    """``bu.timeit`` as one call reporting :data:`T`, its one sample
    recorded for ``bu.last_timing``."""
    def timeit(fn, *args, **kw):
        out = fn(*args)
        bu._LAST_TIMING["seq"] += 1
        bu._LAST_TIMING["samples"] = (T,)
        return T, out
    return timeit


def jax_bench_copy(tmp_path, monkeypatch):
    """``bench.py`` imported from a copy in ``tmp_path``, at SMALL, N, D
    and ITERS."""
    copy = tmp_path / "bench.py"
    shutil.copy(REPO / "bench.py", copy)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("jax_bench_copy", copy)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SMALL, mod.N, mod.D = True, N, D
    mod.BUILD = dict(mod.BUILD, iters=ITERS)
    monkeypatch.setattr(mod, "timeit", fixed_timeit(jbenchutil))
    monkeypatch.setattr(mod, "timeit_piped", lambda fn, *a, **kw: T)
    return mod


def port_sizes(monkeypatch, n, d, iters):
    """The port's bench at SMALL with ``n`` rows of width ``d`` and
    k-means at ``iters``, as the JAX script's constants are set."""
    monkeypatch.setattr(bench, "N_SMALL", n)
    monkeypatch.setattr(bench, "D", d)
    monkeypatch.setattr(bench, "BUILD", dict(bench.BUILD, iters=iters))


def assert_same(got, want, path="$", skip=()):
    """Records equal in keys everywhere and in values but :data:`TIMES`,
    ``note`` and ``skip``; floats to TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in set(want) - TIMES - {"note"} - set(skip):
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=TOL, rel=TOL), path
    else:
        assert got == want, path


def recall(ids, gt) -> float:
    return jbenchutil.recall_at_k(np.asarray(ids), np.asarray(gt))


# --------------------------------------------------------- the whole bench
def test_bench_matches_jax(same_data, monkeypatch, capsys, tmp_path):
    before = sha256(JAX_RECORD)
    monkeypatch.delenv("PW2V_BENCH_STRICT", raising=False)
    # the Pallas int8 scans run on the CPU only in interpret mode
    for name in ("adc_top_k_pallas", "adc_top_k_binned_pallas"):
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name),
                                                        interpret=True))
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JPQ, iters=ITERS)            # the OPQ builds name their iters
    ix.jax(JIVFADC)
    ix.jax(JIVPQ)
    mod = jax_bench_copy(tmp_path, monkeypatch)
    capsys.readouterr()
    mod.main()
    jpq256 = ix.built[0]                # PQ 12×256, the int8 rows' index
    want_line = json.loads(capsys.readouterr().out)
    want = json.loads((tmp_path / "BENCH_LOCAL_latest.json").read_text())
    assert sha256(JAX_RECORD) == before

    ix.port(PQIndex)
    ix.port(IVFADCIndex)
    ix.port(IVPQIndex)
    port_sizes(monkeypatch, N, D, ITERS)
    monkeypatch.setattr(bench, "timeit", fixed_timeit(benchutil))
    monkeypatch.setattr(bench, "timeit_piped", lambda fn, *a, **kw: T)
    out = tmp_path / "port.json"
    got = bench.main(["--small", "--out", str(out), "--device", "cpu"])
    got_line = json.loads(capsys.readouterr().out)
    assert not ix.built                 # every JAX index was used
    assert json.loads(out.read_text()) == got
    assert sha256(JAX_RECORD) == before

    # the same rows, but the fused scan that the JAX script runs only on
    # a TPU
    assert set(got["configs"]) == set(want["configs"]) | {"exact_fused"}
    assert len(want["configs"]) == 36
    for name, row in want["configs"].items():
        assert_same(got["configs"][name], row, name,
                    skip={"recall", "recall5"} if name in TIES else ())
    assert got["n_vectors"] == want["n_vectors"] == N
    assert got["reference_bars"] == want["reference_bars"]
    assert got["dataset"].pop("draws").startswith(
        "postgres_word2vec_tpu_torch")
    assert got["dataset"] == want["dataset"]
    assert got["device"] == "cpu"
    # every row's work counted, and no kernel launched on the CPU
    assert set(got["launches"]) == set(got["configs"]) - {
        "join_method0_vs_method2"}
    assert all(counts == {} for counts in got["launches"].values())
    assert got["configs"]["insert_batch"]["probe_ok"] is True

    # the one line: same keys, the same headline row; the fixed time
    # makes the batch-1024 exact rows the fastest, exact_batch first
    assert set(got_line) == set(want_line)
    assert got_line["metric"] == want_line["metric"] == (
        "batch_knn_p50_per_query_ms[exact_batch]")
    for key in set(want_line) - LINE_TIMES:
        assert got_line[key] == pytest.approx(want_line[key], abs=TOL), key

    # the int8 rows' ids equal up to ties on the same index and queries
    V = jnp.asarray(rows(0, N, D, {"kind": "wordlike"}))
    jpq256.save(tmp_path / "pq256.npz")
    pq256 = PQIndex.load(tmp_path / "pq256.npz", device="cpu")
    qe = V[:bench.EVAL_Q]
    d_jax, i_jax = jpq256.search(qe, bench.K, impl="pallas_int8")
    d_port, i_port = pq256.search(torch.from_numpy(np.array(qe)), bench.K,
                                  impl="kernel_int8")
    assert_same_top_k(d_port, i_port, d_jax, i_jax, atol=TOL)
    assert not np.array_equal(np.asarray(i_jax), i_port.numpy())

    # exact_fused against the Pallas scan in interpret mode, same rows
    _, gt10 = jexact.exact_top_k(V[:bench.EVAL_Q], V, 10)
    tiled, norms, valid = pk.tile_table(V)
    fused = got["configs"]["exact_fused"]
    for k, key in ((10, "recall"), (5, "recall5")):
        _, ids = pk.fused_exact_top_k(V[:bench.EVAL_Q], tiled, norms, k,
                                      valid_n=valid, interpret=True)
        assert fused[key] == recall(ids, np.asarray(gt10)[:, :k])
    assert fused["batch"] == 1024
    assert fused["per_query_ms"] == pytest.approx(T / 1024 * 1e3)


# ------------------------------------------- the 1M / 3M rows, small sizes
def test_large_target_joins_match_jax(tmp_path):
    """The large-target section at 1,000 targets and at all 3,000 rows:
    the exact baseline's recall, and each ladder row's recall, scanned
    rows, rounds and final alpha, equal to the JAX package's on the same
    index."""
    n, d, nq = 3000, 60, 300
    V = rows(7, n, d, {})
    jivpq = JIVPQ.build(jax.random.PRNGKey(3), jnp.asarray(V),
                        m=30, k=32, k_coarse=48, coarse_positions=1,
                        train_size=None, iters=4)
    jivpq.save(tmp_path / "ivpq.npz")
    ivpq = IVPQIndex.load(tmp_path / "ivpq.npz", device="cpu")
    b = bench.Bench(torch.from_numpy(V), small=False)
    j = bench.Join(b, ivpq, nq, 1000)
    plan = ((1000, "1k", ((200, 20), (600, 20))),
            (None, "all", ((200, 20), (600, 50))))
    bench.large_target_section(j, plan)
    res = b.results

    Vj = jnp.asarray(V)
    qv = Vj[n - nq:]
    qe = qv[:bench.EVAL_Q]
    for nt, tag, ladder in plan:
        nt = n if nt is None else nt
        tgt = jnp.arange(nt, dtype=jnp.int32)
        _, gt = jexact.exact_top_k(qe, Vj[:nt], 5)
        if nt >= n:
            _, ie = jexact.exact_top_k(qe, Vj, 5)
        else:
            _, ie = jexact.exact_top_k_in(qe, Vj, tgt, jnp.ones(nt, bool), 5)
        row = res[f"join_exact_in_{tag}"]
        assert row["recall5"] == row["recall"] == recall(ie, gt)
        assert (row["queries"], row["targets"], row["k"]) == (nq, nt, 5)
        assert res[f"ivpq_join_prepare_{tag}"]["targets"] == nt
        stats = jbuild_statistics(jivpq.cell_of, tgt, jivpq.num_cells)
        ph = jivpq.prepare_join(tgt, vectors=Vj if nt >= n else Vj[:nt],
                                vecs_pregathered=True)
        for a, pvf in ladder:
            name = (f"ivpq_join_pv_a{a}_{tag}" if pvf == 20
                    else f"ivpq_join_pv_a{a}_pvf{pvf}_{tag}")
            _, i2, info = jivpq.search_join(
                qe, 5, prepared=ph, statistics=stats, alpha=a, method=2,
                confidence=0.8, pvf=pvf, query_chunk=512, return_info=True)
            row = res[name]
            assert row["recall5"] == row["recall"] == recall(i2, gt), name
            assert row["scanned_rows_mean"] == pytest.approx(
                float(np.asarray(info["retrieved"]).mean()), abs=TOL)
            assert row["rounds"] == int(np.asarray(info["rounds"]).max())
            assert row["final_alpha"] == int(
                np.asarray(info["final_alpha"]).max())
            assert {k: row[k] for k in ("alpha", "method", "confidence",
                                        "pvf", "prepared", "targets",
                                        "queries", "k")} == {
                "alpha": a, "method": 2, "confidence": 0.8, "pvf": pvf,
                "prepared": True, "targets": nt, "queries": nq, "k": 5}
            assert len(row["trials_s"]) == 3


# ------------------------------------------------------ failures and paths
@pytest.mark.parametrize("section", ["time_exact", "ground_truth",
                                     "exact_section", "pq256_section"])
def test_a_section_that_raises_fails_main(monkeypatch, tmp_path, section):
    def boom(*args, **kw):
        raise RuntimeError(f"{section} failed")

    port_sizes(monkeypatch, 2048, 24, 2)
    monkeypatch.setattr(bench, section, boom)
    out = tmp_path / "port.json"
    with pytest.raises(RuntimeError, match=f"{section} failed"):
        bench.main(["--small", "--out", str(out), "--device", "cpu"])
    assert not out.exists()


def test_a_section_that_raises_exits_non_zero(tmp_path):
    code = (
        "import sys\n"
        "from postgres_word2vec_tpu_torch.cli import bench\n"
        "def boom(*a, **kw):\n"
        "    raise RuntimeError('pq256 failed')\n"
        "bench.N_SMALL, bench.D = 2048, 24\n"
        "bench.pq256_section = boom\n"
        "bench.main(sys.argv[1:])\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--small", "--out",
         str(tmp_path / "port.json"), "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "pq256 failed" in proc.stderr
    assert proc.stdout == ""


def test_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--small", "--out", str(tmp_path / "port.json")])
    assert not (tmp_path / "port.json").exists()


def test_default_out_is_not_the_jax_record():
    args = bench._parser().parse_args([])
    assert args.out == str(REPO / "BENCH_LOCAL_torch_latest.json")
    assert args.out != str(JAX_RECORD)
    assert gen_readme_table.DEFAULT_OUT == bench.DEFAULT_OUT


def test_small_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("BENCH_SMALL", "1")
    assert bench._parser().parse_args([]).small
    monkeypatch.setenv("BENCH_SMALL", "0")
    assert not bench._parser().parse_args([]).small


def test_one_line_reproduces_the_jax_record():
    """The compact line computed from the committed JAX detail file is
    the line that run printed (BENCH_r05.json's ``parsed``), every key
    in place, the 3M rows included."""
    detail = json.loads(JAX_RECORD.read_text())
    line = bench.one_line(detail["configs"], detail["n_vectors"])
    assert line == json.loads((REPO / "BENCH_r05.json").read_text())[
        "parsed"]
    assert len(json.dumps(line)) < 2048


@pytest.mark.parametrize("case", ["fastest", "recall_floor", "batch_one",
                                  "fallback"])
def test_headline_rule(case):
    rows_ = {"exact_single": {"per_query_ms": 5.0, "recall": 1.0},
             "slow": {"per_query_ms": 0.5, "batch": 64, "recall": 0.9},
             "fast": {"per_query_ms": 0.1, "batch": 256, "recall": 0.5},
             "fast_bad": {"per_query_ms": 0.01, "batch": 256,
                          "recall": 0.3},
             "single": {"per_query_ms": 0.001, "recall": 1.0},
             "join": {"total_s": 0.001, "recall": 1.0}}
    want = {"fastest": "fast", "recall_floor": "fast",
            "batch_one": "fast", "fallback": "exact_single"}[case]
    if case == "fallback":
        rows_ = {k: v for k, v in rows_.items()
                 if k in ("exact_single", "fast_bad", "single", "join")}
    name, row = bench.headline(rows_)
    assert name == want and row is rows_[want]


def test_device_ms_reads_a_trace():
    x = torch.randn(256, 256)
    assert benchutil.device_ms(lambda: x @ x, 4) > 0.0
    with pytest.raises(RuntimeError, match="no device time"):
        benchutil.device_ms(lambda: None, 2)


# ---------------------------------------------------------- the README table
def run_jax_table(monkeypatch, capsys, path) -> list[str]:
    mod = jax_script("evaluation/gen_readme_table.py")
    monkeypatch.setattr(sys, "argv", ["gen_readme_table.py", str(path)])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def test_readme_table_matches_jax(monkeypatch, capsys):
    """The committed JAX record renders to the JAX script's lines but the
    header's device text."""
    want = run_jax_table(monkeypatch, capsys, JAX_RECORD)
    got = gen_readme_table.main([str(JAX_RECORD)])
    assert capsys.readouterr().out.splitlines() == got
    assert len(got) == len(want) == 23
    assert got[1:] == want[1:]
    assert "one TPU chip" in want[0]
    assert got[0] == want[0].replace("one TPU chip", "device not recorded")


@pytest.mark.parametrize("device,text,fused", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     "3M × 300-d, one NVIDIA H100 80GB HBM3 at 700.00 W",
     "Exact, fused scan kernel (batch 1024)"),
    ("cpu", "3M × 300-d, the CPU", "Exact, fused scan kernel (batch 1024)"),
])
def test_readme_table_names_the_device(tmp_path, capsys, device, text,
                                       fused):
    data = json.loads(JAX_RECORD.read_text())
    data["device"] = device
    path = tmp_path / "port.json"
    path.write_text(json.dumps(data))
    lines = gen_readme_table.main([str(path)])
    capsys.readouterr()
    assert text in lines[0] and "TPU" not in "\n".join(lines)
    assert any(line.startswith(f"| {fused} |") for line in lines)
    single = next(line for line in lines
                  if line.startswith("| IVFADC single query"))
    assert "ms wall)" in single and "tunnel" not in single
    assert lines[-1].startswith("(generated from port.json, dataset ")
