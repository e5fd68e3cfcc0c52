"""The port's evaluation drivers (``postgres_word2vec_tpu_torch.cli
.evaluation``) against the repository's JAX drivers (``evaluation/*.py``),
on the CPU, and the port's ``synth.generate_mixture``.

Both packages run each driver on the same config, whose store and three
indexes are JAX-built artifacts, so both engines hold the same codes: the
printed JSON must agree in every field but the times (precision,
distances and cosines to 1e-6; float32 counts, such as the predicted
target counts, to a relative 1e-6). Sizes are tiny (n = 1,500,
d = 24); the JAX artifacts are built once for the module."""

import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.evaluation import synth as jsynth
from postgres_word2vec_tpu.models.ivfadc import IVFADCIndex as JIVFADC
from postgres_word2vec_tpu.models.ivpq import IVPQIndex as JIVPQ
from postgres_word2vec_tpu.models.pq import PQIndex as JPQ
from postgres_word2vec_tpu.store import VectorStore as JStore
from postgres_word2vec_tpu_torch.cli import _common
from postgres_word2vec_tpu_torch.cli.evaluation import (
    confidence_eval, flexible_pq_eval, step_wise_time_measurement,
    target_counts, time_measurement, time_precision_eval, vec_distr)
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.utils.config import Configuration
from test_torch_parity_util import jax_script

N, D = 1500, 24
TOL = 1e-6
#: a key naming a time, dropped before two drivers' records are compared
TIME_KEY = re.compile(r"(_s|_ms|_time)$")


def printed(capsys, fn, *args, **kw):
    """Run ``fn`` and parse the JSON it printed."""
    capsys.readouterr()
    fn(*args, **kw)
    return json.loads(capsys.readouterr().out)


def untimed(obj):
    """``obj`` without the fields that hold times."""
    if isinstance(obj, dict):
        return {k: untimed(v) for k, v in obj.items()
                if not TIME_KEY.search(k)}
    if isinstance(obj, list):
        return [untimed(v) for v in obj]
    return obj


def assert_same(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=TOL, rel=TOL), path
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """A store and JAX-built PQ, IVFADC and IVPQ artifacts of it."""
    tmp = tmp_path_factory.mktemp("cli_eval")
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    store = JStore.from_arrays([f"word{i}" for i in range(N)], vecs)
    store.save(tmp / "store.npz")
    v = store.vectors_norm
    key = jax.random.PRNGKey(0)
    JPQ.build(key, v, m=6, k=16, train_size=None, iters=5).save(
        tmp / "pq.npz")
    JIVFADC.build(key, v, m=6, k=16, k_coarse=20, train_size=None,
                  iters=5).save(tmp / "ivfadc.npz")
    JIVPQ.build(key, v, m=6, k=16, k_coarse=6, train_size=None,
                iters=5).save(tmp / "ivpq.npz")
    return tmp


def config(art, name: str, **keys) -> str:
    body = {"store_path": str(art / "store.npz"),
            "pq_index": str(art / "pq.npz"),
            "ivfadc_index": str(art / "ivfadc.npz"),
            "ivpq_index": str(art / "ivpq.npz"), "k": 5, **keys}
    path = art / f"{name}.json"
    path.write_text(json.dumps(body))
    return str(path)


def both(capsys, script: str, port_main, cfg: str):
    want = printed(capsys, jax_script(script).main, cfg)
    got = printed(capsys, port_main, cfg, device="cpu")
    return got, want


@pytest.mark.parametrize("method", ["default", "defaultpv", "sizedependend",
                                    "postverification", "batch",
                                    "batch-precision"])
def test_time_measurement_matches_jax(art, capsys, method):
    cfg = config(art, f"tm_{method}", query_sample=6, method=method,
                 resolution=3, basis=40)
    got, want = both(capsys, "evaluation/time_measurement.py",
                     time_measurement.main, cfg)
    assert_same(untimed(got), untimed(want))
    assert got.keys() == want.keys()


def test_time_precision_eval_matches_jax(art, capsys):
    """Every record's precision, method, alpha and pvf, with statistics
    over the target domain; both write the PNG and the HTML report."""
    cfg = config(art, "tpe", query_sample=12, target_sample=600,
                 alphas=[20, 60], pvfs=[3, 10], methods=[0, 1, 2],
                 statistics_domain=True,
                 plot_path=str(art / "jax_plot" / "tp.png"))
    (art / "jax_plot").mkdir()
    want = printed(capsys, jax_script("evaluation/time_precision_eval.py")
                   .main, cfg)
    body = json.loads(Path(cfg).read_text())
    body["plot_path"] = str(art / "port_plot" / "tp.png")
    Path(cfg).write_text(json.dumps(body))
    (art / "port_plot").mkdir()
    got = printed(capsys, time_precision_eval.main, cfg, device="cpu")
    assert len(got) == 2 + 2 + 4 + 1
    assert_same(untimed(got), untimed(want))
    for d in ("jax_plot", "port_plot"):
        assert (art / d / "tp.png").stat().st_size > 1000
        assert (art / d / "tp.html").stat().st_size > 1000


def test_time_precision_eval_without_matplotlib(art, capsys, monkeypatch):
    """Where matplotlib does not import, the driver says so on stderr,
    writes the HTML report and no PNG, and prints its records."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = config(art, "tpe_nompl", query_sample=4, target_sample=300,
                 alphas=[20], pvfs=[3], methods=[2],
                 plot_path=str(art / "nompl" / "tp.png"))
    (art / "nompl").mkdir()
    capsys.readouterr()
    recs = time_precision_eval.main(cfg, device="cpu")
    captured = capsys.readouterr()
    assert "matplotlib is not installed" in captured.err
    assert json.loads(captured.out) == recs and len(recs) == 2
    assert not (art / "nompl" / "tp.png").exists()
    assert (art / "nompl" / "tp.html").stat().st_size > 1000


def test_step_wise_matches_jax(art, capsys):
    """The same records but the times: methods, query and target counts,
    stage names and retrieved counts; warm then TRACK; ``out`` written."""
    cfg = config(art, "sw", query_steps=[4, 9], target_sample=500,
                 out=str(art / "sw_port.json"))
    want = printed(capsys, jax_script(
        "evaluation/step_wise_time_measurement.py").main, cfg)
    got = printed(capsys, step_wise_time_measurement.main, cfg,
                  device="cpu")
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert [sorted(r["stages"]) for r in got] == [
        sorted(r["stages"]) for r in want]
    assert_same(untimed(got), untimed(want))
    assert json.loads((art / "sw_port.json").read_text()) == got
    for r in got:
        assert {"precomputation_time", "data_retrieval_time",
                "computation_time", "total_time"} <= r["stages"].keys()
        assert r["inner_s"] <= r["wall_s"] and r["compile_s"] >= 0.0


@pytest.mark.parametrize("driver,script", [
    (confidence_eval, "evaluation/confidence_eval.py"),
    (target_counts, "evaluation/target_counts.py")])
def test_model_validation_matches_jax(art, capsys, driver, script):
    cfg = config(art, driver.__name__.split(".")[-1], alpha=8,
                 query_sample=10, target_sample=700,
                 confidences=[0.05, 0.5, 0.95])
    got, want = both(capsys, script, driver.main, cfg)
    assert_same(untimed(got), untimed(want))


def test_flexible_pq_eval_matches_jax(art, capsys):
    cfg = config(art, "flex", query_sample=8, target_steps=[200, 500],
                 num_iters=2)
    got, want = both(capsys, "evaluation/flexible_pq_eval.py",
                     flexible_pq_eval.main, cfg)
    assert_same(untimed(got), untimed(want))
    assert [len(r["long_codes"]["times_s"]) for r in got] == [2, 2]


def test_vec_distr_matches_jax(art, capsys):
    cfg = config(art, "vd", query_sample=20)
    got, want = both(capsys, "evaluation/vec_distr.py", vec_distr.main, cfg)
    assert_same(got, want)


def test_engine_from_a_gaussian_config_matches_jax(tmp_path):
    """Without a store the Gaussian branch draws the JAX package's
    vectors, and both sample the same words."""
    cfg = tmp_path / "syn.json"
    cfg.write_text(json.dumps({
        "synthetic": {"n": 600, "d": 16, "seed": 4},
        "build": {"pq_m": 4, "pq_k": 8, "ivfadc_m": 4, "ivfadc_k": 8,
                  "k_coarse": 6, "ivpq_m": 4, "ivpq_k": 8,
                  "ivpq_k_coarse": 3, "train_size": None, "iters": 3}}))
    jc = jax_script("evaluation/time_measurement.py")
    jeng = jc.engine_from_config(jc.Configuration(str(cfg)))
    eng = _common.engine_from_config(Configuration(cfg), "cpu")
    np.testing.assert_array_equal(eng.store.vectors.numpy(),
                                  np.asarray(jeng.store.vectors))
    assert eng.store.words == jeng.store.words
    assert _common.sample_words(eng, 50, 3, 7) == jc.sample_words(
        jeng, 50, 3, 7)
    assert eng.pq.m == 4 and eng.ivfadc.num_cells == 6
    assert eng.ivpq.num_cells == 9 and eng.store.device.type == "cpu"


def test_engine_from_a_wordlike_config():
    """The ``wordlike`` branch draws on the engine's device from a seeded
    ``torch.Generator``: the same seed gives the same rows, unit norms."""
    cfg = Configuration.__new__(Configuration)
    cfg._values = {"synthetic": {"generator": "wordlike", "n": 800, "d": 16,
                                 "seed": 2},
                   "build": {"with_pq": False, "with_ivfadc": False,
                             "ivpq_m": 4, "ivpq_k": 8, "ivpq_k_coarse": 8,
                             "ivpq_coarse_positions": 1,
                             "train_size": None, "iters": 3}}
    eng = _common.engine_from_config(cfg, "cpu")
    want = synth.generate_wordlike(torch.Generator().manual_seed(2), 800, 16)
    torch.testing.assert_close(eng.store.vectors_norm, want, rtol=0, atol=0)
    assert eng.pq is None and eng.ivfadc is None
    assert eng.ivpq.num_cells == 8


# ------------------------------------------------------- generate_mixture
def _median_top1(v: np.ndarray, eval_q: int) -> float:
    s = v[:eval_q] @ v.T
    s[np.arange(eval_q), np.arange(eval_q)] = -2.0
    return float(np.median(s.max(axis=1)))


def test_generate_mixture_matches_the_jax_geometry():
    """Shape, unit norms, the planted rows stand out from the mixture, and
    the median top-1 cosine of the first ``eval_q`` rows is within 0.02
    of the JAX generator's at the same n, d (different draws)."""
    n, d, eval_q = 2000, 32, 100
    v = synth.generate_mixture(torch.Generator().manual_seed(0), n, d,
                               eval_q=eval_q).numpy()
    j = np.asarray(jsynth.generate_mixture(jax.random.PRNGKey(0), n, d,
                                           eval_q=eval_q))
    assert v.shape == (n, d) and v.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, rtol=1e-5)
    top1 = _median_top1(v, eval_q)
    assert abs(top1 - _median_top1(j, eval_q)) <= 0.02
    # a planted neighbour is far closer than the rest of the mixture
    sims = v[:eval_q] @ v[eval_q:].T
    assert top1 > np.median(sims) + 0.4
    # 16 planted rows each: each query's 16th best sits above the bulk
    sixteenth = np.sort(sims, axis=1)[:, -16]
    assert np.median(sixteenth) > np.percentile(sims, 99)


def test_generate_mixture_is_seeded_and_keeps_v2_params():
    a = synth.generate_mixture(torch.Generator().manual_seed(5), 600, 16,
                               eval_q=8)
    b = synth.generate_mixture(torch.Generator().manual_seed(5), 600, 16,
                               eval_q=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert synth.V2_PARAMS == jsynth.V2_PARAMS
    v2 = synth.generate_wordlike(torch.Generator().manual_seed(1), 512, 16,
                                 n_topics=8, **synth.V2_PARAMS)
    np.testing.assert_allclose(torch.linalg.vector_norm(v2, dim=-1).numpy(),
                               1.0, rtol=1e-5)
