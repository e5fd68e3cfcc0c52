"""The port's kernel sweeps (``postgres_word2vec_tpu_torch.cli.evaluation``:
budget_kernel_sweep, adc_kernel_probe, exact_block_sweep) against the
repository's JAX scripts (``evaluation/*.py``) and the JAX package's
kernels in interpret mode, on the CPU, where the wrappers run their plain
versions.

- budget_kernel_sweep: at B 8, P 4, block_t 32, 6 tiles, m 4, k 8 the
  record has the JAX script's keys (its ``--interpret`` run at the same
  arguments), the same ``mean_run`` and every ``_match`` true on both
  sides; the draws are the JAX script's (at the defaults ``mean_run``
  equals ``reports/budget_kernel_sweep.json``'s), and the port's plain K6
  on them is held to JAX's plain twin ``ops/adc.budget_adc_xla`` within
  1e-5.
- adc_kernel_probe: the dense and binned top-k the probe times, at N
  4,096 in both regimes, against ``adc_top_k_pallas`` and
  ``adc_top_k_binned_pallas`` (interpret mode): ids equal up to ties
  within the bound of the TPU kernels' bf16 LUTs (``m·max(lut)·2⁻⁸``, the
  binned one also 2⁻¹⁷ relative for its argmin packed into the min's low
  bits; the port's LUTs stay float32), and the dense one equal up to ties
  to the JAX package's float32 ``adc.adc_top_k`` within the float32
  rounding of an m-term sum, ``m·2⁻²⁴·max|d|`` (1.4e-5 at 12×256,
  1.3e-4 at 60×16, where the sums reach ~37: the packages add the
  subspaces in different orders); the record's keys are the JAX
  script's; ``--sweep`` raises on the CPU.
- exact_block_sweep: one seeded bf16 table (N 16,384, d 300, B 8) at
  block_n 2048 and 4096 against ``fused_exact_top_k`` (interpret mode):
  ids equal up to ties, distances within 1e-3 (K1's tolerance); a size
  the wrapper refuses is recorded as failed and the sweep goes on.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.ops import adc as jadc
from postgres_word2vec_tpu.ops import pallas_kernels as pk
from postgres_word2vec_tpu_torch.cli.evaluation import (
    adc_kernel_probe, budget_kernel_sweep, exact_block_sweep)
from postgres_word2vec_tpu_torch.ops import kernels
from test_torch_parity_util import (REPO, assert_same_top_k, jax_script, np_,
                                    to_jax, to_torch)

BUDGET_ARGS = ["--b", "8", "--p", "4", "--block-t", "32", "--n-tiles", "6",
               "--m", "4", "--k", "8"]


@pytest.fixture(scope="module")
def budget_records(tmp_path_factory):
    """(the JAX script's ``--interpret`` record, the port's record, the
    port's return value) at :data:`BUDGET_ARGS`; the JAX script's
    compilation-cache settings are dropped and its ``timeit_piped`` times
    one call."""
    tmp = tmp_path_factory.mktemp("budget_sweep")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "cache"))
        update = jax.config.update
        mp.setattr(jax.config, "update", lambda name, value: None
                   if "cache" in name else update(name, value))
        mod = jax_script("evaluation/budget_kernel_sweep.py")
        piped = mod.timeit_piped
        mp.setattr(mod, "timeit_piped",
                   lambda fn, *a, **kw: piped(fn, *a, **{**kw, "iters": 1}))
        mp.setattr(sys, "argv", ["budget_kernel_sweep.py", *BUDGET_ARGS,
                                 "--interpret", "--out",
                                 str(tmp / "jax.json")])
        mod.main()
    ret = budget_kernel_sweep.main([*BUDGET_ARGS, "--out",
                                    str(tmp / "port.json")], device="cpu")
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()), ret)


def test_budget_sweep_has_the_jax_keys(budget_records):
    want, got, ret = budget_records
    assert set(got) == set(want)
    assert ret == got
    for key in ("b", "p", "block_t", "n_tiles", "m", "k", "zipf"):
        assert got[key] == want[key], key


def test_budget_sweep_mean_run_and_matches_agree(budget_records):
    want, got, _ = budget_records
    assert got["mean_run"] == want["mean_run"]
    matches = [k for k in want if k.endswith("_match")]
    assert len(matches) == 6
    assert all(want[k] for k in matches)
    assert all(got[k] is True for k in matches)
    # the group counts are the JAX record's (the per-query count, B·P,
    # too: on the CPU nothing launches)
    for k in want:
        if k.endswith("_programs"):
            assert got[k] == want[k], k


def test_budget_sweep_mean_run_at_the_defaults_is_the_jax_records():
    record = json.loads((REPO / "reports" /
                         "budget_kernel_sweep.json").read_text())
    _, _, _, tiles = budget_kernel_sweep.draws(1024, 16, 256, 400, 30, 32,
                                               1.1)
    assert 1024 * 16 / len(np.unique(tiles)) == record["mean_run"]


def test_budget_sweep_plain_k6_matches_jax_plain_twin():
    luts, codes, rowterm, tiles = budget_kernel_sweep.draws(8, 4, 32, 6, 4,
                                                            8, 1.1)
    got = np_(kernels.budget_adc(to_torch(luts), to_torch(codes),
                                 to_torch(rowterm), to_torch(tiles),
                                 block_t=32))
    want = np.asarray(jadc.budget_adc_xla(
        to_jax(luts), to_jax(codes.T), to_jax(rowterm), to_jax(tiles),
        block_t=32))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


# ----------------------------------------------------------- ADC probe
N_PROBE = 4096


def _probe_cases():
    return list(adc_kernel_probe.cases(N_PROBE, np.random.default_rng(0)))


@pytest.mark.parametrize("case", range(4),
                         ids=["m12k256_B64", "m12k256_B256", "m60k16_B64",
                              "m60k16_B256"])
def test_probe_dense_matches_jax(case):
    m, k, b, luts, codes_t = _probe_cases()[case]
    lt, ct = to_torch(luts), to_torch(codes_t)
    got = adc_kernel_probe.dense(lt, ct, N_PROBE)
    want = pk.adc_top_k_pallas(to_jax(luts), to_jax(codes_t), 10,
                               valid_n=N_PROBE, interpret=True)
    bound = m * luts.max() * 2.0 ** -8
    assert_same_top_k(*got, *want, atol=bound)
    exact = jadc.adc_top_k(to_jax(luts), to_jax(codes_t.T), 10)
    # the two packages sum the m subspaces in different orders: within
    # the float32 rounding of an m-term sum
    atol = m * 2.0 ** -24 * float(np.asarray(exact[0]).max())
    assert_same_top_k(*got, *exact, atol=atol)


@pytest.mark.parametrize("case", [0, 2], ids=["m12k256_B64", "m60k16_B64"])
def test_probe_binned_matches_jax(case):
    m, k, b, luts, codes_t = _probe_cases()[case]
    assert N_PROBE % 2048 == 0
    got = adc_kernel_probe.binned(to_torch(luts), to_torch(codes_t),
                                  N_PROBE)
    want = pk.adc_top_k_binned_pallas(to_jax(luts), to_jax(codes_t), 10,
                                      valid_n=N_PROBE, interpret=True)
    bound = m * luts.max() * 2.0 ** -8
    d_ref = np.asarray(want[0])
    assert_same_top_k(*got, *want,
                      atol=bound + 2.0 ** -17 * float(np.abs(d_ref).max()))


def test_probe_record_has_the_jax_keys(monkeypatch, capsys):
    """The JAX script at its small size with its kernels stubbed out
    (timing needs no values) → its keys; the port's probe at N 4,096.
    The JAX script's compilation-cache settings are dropped."""
    monkeypatch.setenv("BENCH_SMALL", "1")
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if "cache" in name else update(name, value))
    mod = jax_script("evaluation/adc_kernel_probe.py")

    def stub(luts, codes_t, k, **kw):
        return (jnp.zeros((luts.shape[0], k)),
                jnp.zeros((luts.shape[0], k), jnp.int32))

    monkeypatch.setattr(pk, "adc_top_k_pallas", stub)
    monkeypatch.setattr(pk, "adc_top_k_binned_pallas", stub)
    monkeypatch.setattr(sys, "argv", ["adc_kernel_probe.py"])
    capsys.readouterr()
    mod.main()
    want = json.loads(capsys.readouterr().out)
    got = adc_kernel_probe.probe(N_PROBE, torch.device("cpu"))
    assert set(got) == set(want)
    for key, row in want.items():
        assert set(got[key]) == set(row), key
        assert got[key]["speedup"] > 0


def test_probe_sweep_refuses_the_cpu(capsys):
    with pytest.raises(ValueError, match="only on the card"):
        adc_kernel_probe.main(["--sweep", "--device", "cpu"])
    assert capsys.readouterr().out == ""


# ---------------------------------------------------- exact block sweep
@pytest.fixture(scope="module")
def exact_case():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(16_384, 300)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    table = torch.from_numpy(v).to(torch.bfloat16)
    queries = table[:8].float()
    record, found = exact_block_sweep.sweep(table, queries,
                                            [2048, 1000, 4096])
    return table, queries, record, found


@pytest.mark.parametrize("bn", [2048, 4096])
def test_exact_sweep_matches_jax_fused_top_k(exact_case, bn):
    table, queries, record, found = exact_case
    jtable = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    tiled, norms, valid = pk.tile_table(jtable, block_n=bn)
    want = pk.fused_exact_top_k(to_jax(queries.numpy()), tiled, norms, 10,
                                valid_n=valid, interpret=True)
    assert_same_top_k(*found[bn], *want, atol=1e-3)
    assert set(record[f"bn{bn}"]) == {"scan_s", "per_query_ms", "eff_gbps",
                                      "overlap_vs_first"}
    # every query is a row of the table: its own nearest
    assert (np_(found[bn][1])[:, 0] == np.arange(8)).all()


def test_exact_sweep_records_a_refused_size_and_goes_on(exact_case):
    _, _, record, found = exact_case
    assert record["bn1000"]["failed"] is True
    assert "multiple of 128" in record["bn1000"]["error"]
    assert list(record) == ["n", "d", "b", "bn2048", "bn1000", "bn4096"]
    assert set(found) == {2048, 4096}
    assert record["bn2048"]["overlap_vs_first"] == 1.0
    assert record["n"] == 16_384 and record["d"] == 300 and record["b"] == 8


def test_exact_sweep_main_writes_its_record(tmp_path, capsys):
    out = tmp_path / "exact.json"
    capsys.readouterr()
    ret = exact_block_sweep.main(["--n", "4096", "--d", "64", "--b", "4",
                                  "--blocks", "1024,2048", "--out",
                                  str(out)], device="cpu")
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == ret
    assert printed["best"] in ("bn1024", "bn2048")
    assert printed["per_query_ms"] == ret[printed["best"]]["per_query_ms"]


# ------------------------------------------------------ errors, defaults
@pytest.mark.parametrize("driver", [budget_kernel_sweep, adc_kernel_probe,
                                    exact_block_sweep],
                         ids=lambda d: d.__name__.rsplit(".", 1)[-1])
def test_a_sweep_without_a_card_raises(monkeypatch, driver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main([])


@pytest.mark.parametrize("driver,record", [
    (budget_kernel_sweep, "budget_kernel_sweep"),
    (exact_block_sweep, "exact_block_sweep")],
    ids=["budget_kernel_sweep", "exact_block_sweep"])
def test_a_default_out_never_overwrites_a_jax_record(driver, record):
    out = driver._parser().get_default("out")
    assert out == str(REPO / "reports" / f"{record}_torch.json")
    assert (REPO / "reports" / f"{record}.json").exists()
