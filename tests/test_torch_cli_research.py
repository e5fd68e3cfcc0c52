"""The port's research drivers (``postgres_word2vec_tpu_torch.cli
.evaluation``: recall_ceiling, synth_calibrate, join_nq_sweep,
join_method_diag, scale_capacity, scale_join_10M, roofline) against the
repository's JAX scripts (``evaluation/*.py``), on the CPU; the card's
bound model (``evaluation/bounds.py``) and the card-side ground truth
(``benchutil.exact_topk_chunks``).

Each JAX script runs with its generator and its index ``build``s
monkeypatched: both packages draw the same numpy-seeded rows (a function
of the seed the driver asks for, the sizes and the generator parameters),
the JAX script builds its indexes (at a few thousand rows, d ≤ 60, some
with smaller codebooks than the script's), and the port's driver gets the
same indexes, saved by the JAX package and loaded by the port
(``utils/convert.*_from_numpy``). Then:

- the JSON records agree in every key and in every field but the times
  (``TIMES``) and the free-text ``note`` strings, which name each
  package's own scan; recalls are equal (a tie would have to be named
  here: none occurs on these rows), distances, norms and counts agree to
  1e-5 (``TOL``);
- ``reference_targets.source`` names the reference's README without the
  JAX record's host path;
- ``roofline`` and ``join_method_diag``: their JAX scripts fix sizes the
  CPU cannot run (512 MB and 16,384² probes, 307,200 rows), so the port's
  drivers take them as parameters; their records have the keys of
  ``reports/roofline_3M.json`` and of the JAX script's dict, and the joins
  the port runs equal the JAX ``search_join`` on the same index.

The JAX scripts' compilation-cache settings are ignored while they run,
so that no test leaves a cache behind.
"""

import json
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.evaluation import synth as jsynth
from postgres_word2vec_tpu.models.ivfadc import IVFADCIndex as JIVFADC
from postgres_word2vec_tpu.models.ivpq import IVPQIndex as JIVPQ
from postgres_word2vec_tpu.models import pq as jpq_mod
from postgres_word2vec_tpu.models.pq import PQIndex as JPQ
from postgres_word2vec_tpu_torch.cli.evaluation import (
    _research, join_method_diag, join_nq_sweep, recall_ceiling, roofline,
    scale_capacity, scale_join_10M, synth_calibrate)
from postgres_word2vec_tpu_torch.evaluation import benchutil, bounds, synth
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex, train_opq_rotation
from postgres_word2vec_tpu_torch.ops.kmeans import encode_subspaces
from test_torch_parity_util import (REPO, assert_same_top_k, clustered,
                                    jax_script)

TOL = 1e-5
#: fields that hold times, or rates and lists derived from them
TIMES = {"total_s", "trials_s", "qps", "prepare_join_s", "per_query_ms",
         "build_s", "secs", "wall_s", "gbps", "tflops", "tops"}
DRIVERS = (recall_ceiling, synth_calibrate, join_nq_sweep, join_method_diag,
           scale_capacity, scale_join_10M, roofline)


def rows(seed: int, n: int, d: int, params: dict) -> np.ndarray:
    """The rows both packages' generators return: clustered unit rows, a
    function of the seed, the sizes and the generator parameters."""
    tag = zlib.crc32(json.dumps(params, sort_keys=True).encode())
    rng = np.random.default_rng([seed, n, d, tag])
    return clustered(rng, n=n, d=d, centers=max(8, n // 64))


@pytest.fixture
def same_data(monkeypatch):
    """Patch both packages' word-like and mixture generators to
    :func:`rows`; ``force_d`` replaces the width the JAX script asks for
    (its sizes are fixed), and the JAX scripts' cache settings are
    dropped."""
    force = {}

    def jax_gen(kind):
        def gen(key, n, d=300, **params):
            seed = int(np.asarray(key)[-1])
            return jnp.asarray(rows(seed, n, force.get("d", d),
                                    {"kind": kind, **params}))
        return gen

    def port_gen(kind):
        def gen(generator, n, d=300, **params):
            out = rows(generator.initial_seed(), n, d,
                       {"kind": kind, **params})
            return torch.from_numpy(out).to(generator.device)
        return gen

    for mod, make in ((jsynth, jax_gen), (synth, port_gen)):
        monkeypatch.setattr(mod, "generate_wordlike", make("wordlike"))
        monkeypatch.setattr(mod, "generate_mixture", make("mixture"))
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if "cache" in name else update(name, value))
    return force


class SameIndexes:
    """The JAX script's ``build`` calls, with ``over`` replacing some of
    their arguments, recorded in order; the port's ``build`` calls then
    return those indexes, loaded by the port, in the same order."""

    def __init__(self, monkeypatch, tmp_path):
        self.mp, self.tmp, self.built = monkeypatch, tmp_path, []

    def jax(self, cls, name="build", **over):
        orig = getattr(cls, name)

        def build(*args, **kw):
            idx = orig(*args, **{**kw, **over})
            self.built.append(idx)
            return idx
        self.mp.setattr(cls, name, build)

    def port_index(self, loader):
        path = self.tmp / f"idx{len(self.built)}.npz"
        self.built.pop(0).save(path)
        return loader(path, device="cpu")

    def port(self, cls):
        self.mp.setattr(cls, "build", lambda *a, **kw: self.port_index(
            cls.load))


def run_jax(monkeypatch, capsys, script: str, args: list[str]):
    """Run a JAX script's ``main`` with ``args`` as its command line, its
    ``timeit`` (if it imports one) timing one call after the warm one →
    (its module, the JSON it printed)."""
    mod = jax_script(script)
    monkeypatch.setattr(sys, "argv", [script, *args])
    if hasattr(mod, "timeit"):
        timeit = mod.timeit
        monkeypatch.setattr(mod, "timeit", lambda fn, *a, **kw: timeit(
            fn, *a, **{**kw, "iters": 1}))
    capsys.readouterr()
    mod.main()
    return mod, json.loads(capsys.readouterr().out)


def run_port(capsys, driver, args: list[str]):
    capsys.readouterr()
    out = driver.main([*args, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    return out, printed


def assert_same(got, want, path="$"):
    """Records equal but for :data:`TIMES` and ``note``; floats to TOL."""
    if isinstance(want, dict):
        keys = set(want) - TIMES - {"note"}
        assert set(got) - TIMES - {"note"} == keys, (path, sorted(got),
                                                     sorted(want))
        assert set(got) == set(want), path
        for k in keys:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=TOL, rel=TOL), path
    else:
        assert got == want, path


# ------------------------------------------------------- recall_ceiling
@pytest.mark.parametrize("gen", ["v3", "v1"])
def test_recall_ceiling_matches_jax(same_data, monkeypatch, capsys,
                                    tmp_path, gen):
    """PQ (scan and PV) and IVFADC (w=3 and PV) recall@5/@10 on the same
    rows and indexes; ``--out`` written."""
    args = ["--gen", gen, "--n", "3000", "--d", "24", "--queries", "32",
            "--quality", "r1", "--pq-k", "16", "--k-coarse", "20",
            "--train-size", "2000"]
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JPQ)
    ix.jax(JIVFADC)
    _, want = run_jax(monkeypatch, capsys, "evaluation/recall_ceiling.py",
                      args)
    ix.port(PQIndex)
    ix.port(IVFADCIndex)
    out, got = run_port(capsys, recall_ceiling,
                        [*args, "--out", str(tmp_path / "rc.json")])
    assert got == out == json.loads((tmp_path / "rc.json").read_text())
    assert got["reference_targets"].pop("source") == (
        "reference README.md:118-123 (3M)")
    assert want["reference_targets"].pop("source").endswith(
        "README.md:118-123 (3M)")
    assert_same(got, want)
    assert got["quality_params"] == recall_ceiling.QUALITY["r1"]


# ------------------------------------------------------ synth_calibrate
def test_synth_calibrate_matches_jax(same_data, monkeypatch, capsys,
                                     tmp_path):
    """pq@5 and pq_pv@5 of each config on the same rows and codebooks (the
    JAX builds at k = 16, 2 restarts of 5 iterations over every row)."""
    args = ["--n", "3000", "--d", "24", "--queries", "32",
            "--configs", "v2,f15"]
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JPQ, k=16, restarts=2, iters=5, train_size=None)
    mod, want = run_jax(monkeypatch, capsys, "evaluation/synth_calibrate.py",
                        args)
    ix.port(PQIndex)
    out, got = run_port(capsys, synth_calibrate, args)
    assert got == out and [r["config"] for r in got] == ["v2", "f15"]
    assert_same(got, want)
    assert synth_calibrate.CONFIGS == mod.CONFIGS
    assert synth_calibrate.CONFIGS["f15"] == synth.V3_PARAMS


# -------------------------------------------------------- join_nq_sweep
def test_join_nq_sweep_matches_jax(same_data, monkeypatch, capsys,
                                   tmp_path):
    """Recall@5 of the float32 and bf16 exact scans and of the method-2
    probe at each alpha and nq, on the same rows and IVPQ index (the JAX
    build at 6×16 over 32 cells)."""
    args = ["--n", "3000", "--d", "24", "--nqs", "16,64", "--alphas",
            "20,60", "--eval-q", "32", "--trials", "1"]
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JIVPQ, m=6, k=16, k_coarse=32, train_size=2000, iters=3)
    run_jax(monkeypatch, capsys, "evaluation/join_nq_sweep.py",
            [*args, "--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    ix.port(IVPQIndex)
    out, printed = run_port(capsys, join_nq_sweep,
                            [*args, "--out", str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == out and printed == {"out": str(tmp_path / "port.json"),
                                      "nqs": [16, 64]}
    assert_same(got, want)
    assert got["sweep"]["64"]["exact_f32"]["recall5"] == 1.0
    assert len(got["sweep"]["16"]["ivpq_pv_a20"]["trials_s"]) == 1


# ----------------------------------------------------- join_method_diag
def test_join_method_diag_matches_jax(same_data, monkeypatch, capsys,
                                      tmp_path):
    """The JAX script at its small size (BENCH_SMALL: 307,200 rows, 500
    queries, 10,000 targets; the rows 16 wide, the index 4×16 over 32
    cells) and the port's driver at the same sizes: the same keys, and
    every join the port ran (each method, chunk and full) equal to the
    JAX join of the same method and queries."""
    same_data["d"] = 16
    monkeypatch.setenv("BENCH_SMALL", "1")
    joins = {"jax": {}, "port": {}}

    def record(cls, side):
        orig = cls.search_join

        def search_join(self, q, k, *args, **kw):
            d, i = orig(self, q, k, *args, **kw)
            joins[side][(kw["method"], int(q.shape[0]))] = (d, i)
            return d, i
        monkeypatch.setattr(cls, "search_join", search_join)

    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JIVPQ, m=4, k=16, k_coarse=32, train_size=5000, iters=3)
    record(JIVPQ, "jax")
    _, want = run_jax(monkeypatch, capsys, "evaluation/join_method_diag.py",
                      [])
    ix.port(IVPQIndex)
    record(IVPQIndex, "port")
    out, got = run_port(capsys, join_method_diag,
                        ["--n", "307200", "--d", "16", "--nq", "500",
                         "--nt", "10000"])
    assert got == out and list(got) == list(want)
    assert all(v > 0 for v in got.values())
    assert joins["port"].keys() == joins["jax"].keys() == {
        (0, 500), (2, 500)}
    for key, (d, i) in joins["port"].items():
        assert_same_top_k(d, i, *joins["jax"][key], atol=TOL)


# ------------------------------------------------------- scale_capacity
@pytest.mark.parametrize("regime", ["reference", "quality"])
def test_scale_capacity_matches_jax(same_data, monkeypatch, capsys,
                                    tmp_path, regime):
    """The chunked table (chunks of 1,200 rows from seeds 1000 + i), the
    bin collisions of the ground truth, the exact batch's and the PQ
    scan's and PV sweep's recalls on the same codes (the reference regime
    built by the JAX package at 12×16; the quality regime by the JAX
    script's own OPQ × 4-bit build, at 12×16 for d = 24 and 2 OPQ rounds
    of 2 k-means iterations), with ``--impl xla``, the JAX name of the
    plain scan, given to both."""
    args = ["--n", "3000", "--d", "24", "--chunk", "1200", "--eval-q",
            "32", "--impl", "xla", "--pq", regime]
    ix = SameIndexes(monkeypatch, tmp_path)
    if regime == "reference":
        args += ["--pvf", "5,20"]
        ix.jax(JPQ, k=16, iters=5)
    else:
        args += ["--pvf", "20", "--skip-exact"]
        ix.jax(jax_script("evaluation/scale_capacity.py"),
               "_build_quality_from_host", m=12)
        train = jpq_mod.train_opq_rotation
        monkeypatch.setattr(jpq_mod, "train_opq_rotation", lambda *a, **kw:
                            train(*a, **{**kw, "opq_iters": 2,
                                         "kmeans_iters": 2}))
    _, want = run_jax(monkeypatch, capsys, "evaluation/scale_capacity.py",
                      [*args, "--out", str(tmp_path / "jax.json")])
    monkeypatch.setattr(scale_capacity, "build_pq",
                        lambda *a: ix.port_index(PQIndex.load))
    out, got = run_port(capsys, scale_capacity,
                        [*args, "--out", str(tmp_path / "port.json")])
    assert got == out == json.loads((tmp_path / "port.json").read_text())
    assert_same(got, want)
    assert got["bin_collision"]["colliding_gt10_pairs"] > 0


def test_scale_capacity_quality_build():
    """The quality regime's own build: OPQ 60×16 (10 rounds of 6 k-means
    iterations, seed 7) trained on the first chunk's rows, every row
    encoded in the rotated basis, counts that sum to the rows."""
    table = torch.from_numpy(rows(3, 2000, 60, {})).to(torch.bfloat16)
    pq = scale_capacity.build_pq(table, "quality", 1500)
    rot, cb = train_opq_rotation(torch.Generator().manual_seed(7),
                                 table[:1500].float(), 60, 16, opq_iters=10,
                                 kmeans_iters=6)
    for got, want in ((pq.rotation, rot),
                      (pq.codebook.centroids, cb.centroids),
                      (pq.codes, encode_subspaces(table.float(), cb.centroids,
                                                  rotation=rot))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pq.codes.shape == (2000, 60) and pq.codes.dtype == torch.uint8
    assert (pq.codebook.counts.sum(dim=1) == 2000).all()


# ------------------------------------------------------- scale_join_10M
def test_scale_join_matches_jax(same_data, monkeypatch, capsys, tmp_path):
    """The bf16 exact baseline's recall and, at each alpha, the budget
    join's recall, scanned rows and rounds on the same rows and IVPQ index
    (the JAX build at 6×16 over 32 cells)."""
    args = ["--n", "3000", "--d", "24", "--chunk", "1200", "--nq", "200",
            "--eval-q", "32", "--alphas", "20,60", "--k-coarse", "32"]
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JIVPQ, m=6, k=16, train_size=2000, iters=3)
    _, want = run_jax(monkeypatch, capsys, "evaluation/scale_join_10M.py",
                      [*args, "--out", str(tmp_path / "jax.json")])
    ix.port(IVPQIndex)
    out, got = run_port(capsys, scale_join_10M,
                        [*args, "--out", str(tmp_path / "port.json")])
    assert got == out == json.loads((tmp_path / "port.json").read_text())
    assert_same(got, want)
    assert got["ivpq_join_pv_a60"]["scanned_rows_mean"] > (
        got["ivpq_join_pv_a20"]["scanned_rows_mean"])


# -------------------------------------------------------------- roofline
def test_roofline_kernels_match_jax(same_data, monkeypatch, tmp_path):
    """Each scan's bytes and operations at the same size (the JAX
    ``measure_kernels`` at n = 3000, d = 24, its PQ at 12×16), the exact
    scans' counts equal, ``pq_adc_scan``'s one-hot ``flops`` equal."""
    mod = jax_script("evaluation/roofline.py")
    timeit = mod.timeit
    monkeypatch.setattr(mod, "timeit", lambda fn, *a: timeit(fn, *a,
                                                             iters=1))
    ix = SameIndexes(monkeypatch, tmp_path)
    ix.jax(JPQ, k=16, iters=3)
    want = mod.measure_kernels(3000, 24)
    ix.port(PQIndex)
    got = roofline.measure_kernels(3000, 24, torch.device("cpu"))
    assert got.keys() == want.keys()
    for name in ("exact_bf16_scan", "exact_int8_scan"):
        assert got[name].keys() == want[name].keys()
        assert (got[name]["bytes"], got[name]["flops"]) == (
            want[name]["bytes"], want[name]["flops"])
    # both count the one-hot formulation over their code table's columns,
    # the JAX package's padded to a multiple of its 2,048-row block
    pq = got["pq_adc_scan"]
    assert pq["flops"] == 2 * 64 * 3000 * 256 * 12
    assert want["pq_adc_scan"]["flops"] == 2 * 64 * 4096 * 256 * 12
    assert pq["bytes"] == 3000 * 12 + 64 * 12 * 256 * 4 + 64 * 3000 * 4
    assert pq["adds"] == 64 * 3000 * 12 and pq["lookup_bytes"] == (
        4 * pq["adds"])


def test_roofline_record_has_the_jax_keys(monkeypatch, capsys):
    """The port's whole record at small probe sizes has every key of the
    committed ``reports/roofline_3M.json``; the PQ scan's share comes from
    the bound model."""
    build = PQIndex.build
    monkeypatch.setattr(PQIndex, "build", lambda gen, v, **kw: build(
        gen, v, **{**kw, "k": 16, "iters": 2}))
    committed = json.loads((REPO / "reports" / "roofline_3M.json")
                           .read_text())
    out, got = run_port(capsys, roofline, [
        "--n", "2000", "--d", "24", "--stream-mib", "1", "--table-mib", "1",
        "--mm", "64"])
    assert got == out and got["device"] == "cpu"

    def has_keys(have, want, path="$"):
        if isinstance(want, dict):
            assert set(want) <= set(have), (path, sorted(set(want)
                                                         - set(have)))
            for k in want:
                has_keys(have[k], want[k], f"{path}.{k}")
    has_keys(got, committed)
    pq = got["kernels"]["pq_adc_scan"]
    ms, _, term = bounds.bound(pq["bytes"], pq["adds"], "fp32",
                               shared=pq["lookup_bytes"],
                               shared_rate=float("inf"))
    assert (pq["bound_ms"], pq["bound_term"]) == (ms, term)
    assert pq["pct_of_bound"] == round(100 * ms / 1e3 / pq["wall_s"], 1)


# ------------------------------------------------- bound model, ground truth
def test_bound_against_a_hand_computation():
    """K1's and K2's bounds at chip_smoke's phase-5 shapes, by hand: K1
    2·1024·3,072,000·300 bf16 operations at 989 TFLOP/s; K2's LUT lookups,
    4 bytes each of 256·3,072,000·12, at 128 B a clock on 132 SMs at
    1,980 MHz (33.45 TB/s)."""
    n = 3_072_000
    ms, by, term = bounds.bound(0.0, 2 * 1024 * n * 300, "bf16")
    assert (by, term) == ("operations", "operations")
    assert ms == pytest.approx(1.9084, abs=1e-4)
    rate = bounds.smem_bytes_per_s(1980.0, 132)
    assert rate == 128 * 132 * 1980e6
    adds = 256 * n * 12
    nbytes = 256 * 12 * 256 * 4 + 12 * n + 256 * n * 4
    ms, by, term = bounds.bound(nbytes, adds, "fp32", shared=4 * adds,
                                shared_rate=rate)
    assert (by, term) == ("bytes", "shared")
    assert ms == pytest.approx(4 * adds / rate * 1e3) == pytest.approx(
        1.128, abs=1e-3)
    ms, by, term = bounds.bound(nbytes, adds, "fp32")
    assert term == "hbm" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert bounds.bound(0, 1979e9, "int8")[0] == pytest.approx(1.0)


def test_card_ground_truth_equals_host_exact_topk():
    """``exact_topk_chunks`` over a bf16 table's row chunks equals
    ``host_exact_topk`` over the same bf16-rounded rows up to ties."""
    table = torch.from_numpy(rows(5, 5000, 60, {})).to(torch.bfloat16)
    q = table[:40].float()
    got_d, got_i = benchutil.exact_topk_chunks(q, table.split(1300), 10)
    want_d, want_i = benchutil.host_exact_topk(
        q.numpy(), [c.float().numpy() for c in table.split(1700)], 10)
    assert got_i.dtype == torch.int64 and got_d.shape == (40, 10)
    assert_same_top_k(got_d, got_i, want_d, want_i, atol=TOL)
    assert (got_i[:, 0] == torch.arange(40)).all()


def test_wordlike_table_draws_each_chunk_from_its_seed():
    """Chunk i of the table is ``generate_wordlike`` of seed 1000 + i, cast
    to bf16; the norms are the float32 rows' before the cast."""
    table, norms = _research.wordlike_table(700, 16, 300,
                                            torch.device("cpu"))
    parts = [synth.generate_wordlike(torch.Generator().manual_seed(1000 + i),
                                     r, 16)
             for i, r in enumerate((300, 300, 100))]
    want = torch.cat(parts)
    assert table.dtype == torch.bfloat16
    torch.testing.assert_close(table, want.to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(norms, (want * want).sum(1), rtol=0, atol=0)


# ------------------------------------------------------ errors, defaults
@pytest.mark.parametrize("name", ["pallas_fast", "binned", ""])
def test_an_unknown_impl_raises(name):
    with pytest.raises(ValueError, match="--impl must be one of"):
        scale_capacity.main(["--impl", name, "--n", "100"], device="cpu")


@pytest.mark.parametrize("jax_name,port_name", [
    ("pallas_binned", "kernel_binned"), ("pallas", "kernel"),
    ("xla", "plain"), ("kernel", "kernel"), ("plain", "plain")])
def test_the_jax_impl_names_map_to_the_ports(jax_name, port_name):
    assert _research.scan_impl(jax_name) == port_name


@pytest.mark.parametrize("driver", DRIVERS,
                         ids=lambda d: d.__name__.rsplit(".", 1)[-1])
def test_a_driver_without_a_card_raises(monkeypatch, driver):
    """Without a card and without ``--device`` every driver raises before
    any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main([])


@pytest.mark.parametrize("driver,record", [
    (join_nq_sweep, "join_nq_sweep_3M"), (scale_capacity, "scale_10M"),
    (scale_join_10M, "scale_join_10M")],
    ids=["join_nq_sweep", "scale_capacity", "scale_join_10M"])
def test_a_default_out_never_overwrites_a_jax_record(driver, record):
    out = Path(driver._parser().get_default("out"))
    assert out == REPO / "reports" / f"{record}_torch.json"
    assert not out.exists()
