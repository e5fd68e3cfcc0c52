"""The port's exact and PQ models and its engine against the JAX package
(CPU). Each slice as a whole: a JAX engine built and saved here loads in
the port; its exact, PQ and PQ-PV kNN families return the same words (up
to ties) with similarities within 1e-5, and its IVFADC families, batch
façade and IVPQ joins (methods 0, 1, 2, prepared targets, statistics)
within 1e-4 (the IVFADC decomposition and the join's ADC add float32
terms in another order)."""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu.models import exact as jexact
from postgres_word2vec_tpu.models import pq as jpq

from postgres_word2vec_tpu_torch import ExactIndex, Freddy, PQIndex
from postgres_word2vec_tpu_torch import VectorStore
from postgres_word2vec_tpu_torch.api import NOT_PORTED
from postgres_word2vec_tpu_torch.models import exact
from postgres_word2vec_tpu_torch.utils.convert import pq_from_numpy

from test_torch_parity_util import (PQ_ENGINE, PROBE_ENGINE,
                                    assert_same_top_k, np_, save_jax_engine,
                                    to_jax, to_torch)
from test_torch_parity_util import clustered as _clustered

N, D = 4096, 48


@pytest.fixture(scope="module")
def saved_jax_engine(tmp_path_factory):
    """A JAX engine (OPQ PQ family only) built on CPU and saved."""
    return save_jax_engine(tmp_path_factory.mktemp("engine"), **PQ_ENGINE)


# ------------------------------------------------------------------ exact

@pytest.mark.parametrize("chunk", [512, 1 << 20])
def test_exact_top_k_matches_jax(rng, chunk):
    v = _clustered(rng, n=3000)
    q = v[:7]
    got = exact.exact_top_k(to_torch(q), to_torch(v), 10, chunk_size=chunk)
    want = jexact.exact_top_k(to_jax(q), to_jax(v), 10, chunk_size=chunk)
    assert_same_top_k(*got, *want, atol=1e-5)


def test_exact_top_k_in_matches_jax(rng):
    v = _clustered(rng, n=500)
    q = v[:3]
    tids = np.array([5, 9, 40, 7, 300, 2], np.int32)
    mask = np.array([1, 1, 1, 0, 1, 1], bool)
    got = exact.exact_top_k_in(to_torch(q), to_torch(v), to_torch(tids),
                               to_torch(mask), 8)
    want = jexact.exact_top_k_in(to_jax(q), to_jax(v), to_jax(tids),
                                 to_jax(mask), 8)
    assert_same_top_k(*got, *want, atol=1e-5)
    assert (np_(got[1])[:, 5:] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_index_matches_jax(rng, dtype):
    v = _clustered(rng, n=3000)
    q = v[10:16]
    got = ExactIndex(to_torch(v), dtype).search(to_torch(q), 10)
    want = jexact.ExactIndex(to_jax(v), dtype).search(to_jax(q), 10)
    assert_same_top_k(*got, *want, atol=1e-4)


def test_exact_index_fused_runs_the_fused_path(rng):
    v = _clustered(rng, n=9000)
    q = to_torch(v[:8])
    fused = ExactIndex(to_torch(v), "bfloat16", approx=True, fused=True)
    d, i = fused.search(q, 10)
    d_ref, i_ref = ExactIndex(to_torch(v), "float32").search(q, 10)
    assert (i[:, 0] == torch.arange(8)).all()
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(i, i_ref))
    assert hits / i.numel() >= 0.9
    with pytest.raises(ValueError, match="bfloat16"):
        ExactIndex(to_torch(v), "float32", fused=True)


# --------------------------------------------------------------------- PQ

def _jax_pq(eng_path):
    with np.load(eng_path / "pq.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, jpq.PQIndex.load(eng_path / "pq.npz")


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_pq_search_matches_jax(saved_jax_engine, impl):
    eng, path = saved_jax_engine
    arrays, jindex = _jax_pq(path)
    index = pq_from_numpy(arrays, device="cpu")
    assert index.codes.dtype == torch.uint8 and index.rotation is not None
    q = np.asarray(eng.store.vectors_norm[:9])
    got = index.search(to_torch(q), 10, impl=impl)
    want = jindex.search(to_jax(q), 10)
    assert_same_top_k(*got, *want, atol=1e-5)


def test_pq_binned_search_keeps_the_global_min(saved_jax_engine):
    eng, path = saved_jax_engine
    arrays, jindex = _jax_pq(path)
    index = pq_from_numpy(arrays, device="cpu")
    q = to_torch(np.asarray(eng.store.vectors_norm[:9]))
    d_b, i_b = index.search(q, 10, impl="kernel_binned")
    d_e, _ = index.search(q, 10, impl="plain")
    torch.testing.assert_close(d_b[:, 0], d_e[:, 0])
    assert torch.all(d_b >= d_e - 1e-6)          # survivors never beat exact


@pytest.mark.parametrize("shortlist", ["exact", "approx"])
def test_pq_search_pv_matches_jax(saved_jax_engine, shortlist):
    eng, path = saved_jax_engine
    arrays, jindex = _jax_pq(path)
    index = pq_from_numpy(arrays, device="cpu")
    v = np.asarray(eng.store.vectors_norm)
    q = v[100:108]
    got = index.search_pv(to_torch(q), 5, 20, to_torch(v), impl="kernel",
                          shortlist=shortlist)
    want = jindex.search_pv(to_jax(q), 5, 20, to_jax(v), impl="xla",
                            shortlist="exact")
    if shortlist == "exact":
        assert_same_top_k(*got, *want, atol=1e-5)
    else:                                         # bin survivors, then exact
        assert (np_(got[1])[:, 0] == np.arange(100, 108)).all()


def test_pq_save_load_round_trips_with_jax(saved_jax_engine, tmp_path):
    _, path = saved_jax_engine
    arrays, _ = _jax_pq(path)
    index = PQIndex.load(path / "pq.npz", device="cpu")
    index.save(tmp_path / "port.npz")
    back = jpq.PQIndex.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(back.codes), arrays["codes"])
    np.testing.assert_array_equal(np.asarray(back.rotation),
                                  arrays["rotation"])
    assert np.asarray(back.codes).dtype == np.uint8


def test_pq_build_in_the_port(rng):
    v = to_torch(_clustered(rng, n=3000))
    g = torch.Generator().manual_seed(0)
    index = PQIndex.build(g, v, m=12, k=16, train_size=2000, iters=6,
                          init="kmeans++", opq_iters=2)
    assert index.codes.shape == (3000, 12) and index.codes.dtype == torch.uint8
    assert int(index.codebook.counts.sum()) == 3000 * 12
    q = v[:32]
    _, gt = ExactIndex(v).search(q, 5)
    _, ids = index.search_pv(q, 5, 20, v)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.numel() >= 0.9
    # anisotropic refinement builds too (ported; JAX parity in
    # tests/test_torch_aniso.py)
    aniso = PQIndex.build(g, v, m=12, k=16, train_size=2000, iters=6,
                          aniso_eta=2.0)
    assert aniso.codes.shape == (3000, 12)
    assert int(aniso.codebook.counts.sum()) == 3000 * 12


# ------------------------------------------------------------- the slice

@pytest.mark.parametrize("family", ["k_nearest_neighbour",
                                    "k_nearest_neighbour_pq",
                                    "k_nearest_neighbour_pq_pv"])
def test_jax_engine_loads_in_the_port(saved_jax_engine, family):
    eng, path = saved_jax_engine
    port = Freddy.load(path, device="cpu")
    eng.set_knn_function(family)
    port.set_knn_function(family)
    try:
        _same_knn(eng, port)
    finally:
        eng.set_knn_function("k_nearest_neighbour")


def _same_knn(eng, port, atol=1e-5):
    for word in ("w0", "w17", "w999", "w4095"):
        want = eng.knn(word, 10)
        got = port.knn(word, 10)
        assert len(got) == len(want) == 10
        sw = np.array([s for _, s in want], np.float32)
        sg = np.array([s for _, s in got], np.float32)
        np.testing.assert_allclose(sg, sw, atol=atol, rtol=0)
        ids_w = np.array([eng.store.get_id(w) for w, _ in want])[None]
        ids_g = np.array([port.store.get_id(w) for w, _ in got])[None]
        assert_same_top_k(-sg[None], ids_g, -sw[None], ids_w, atol=atol)
    # the batched façade of the same family agrees too
    q = port.store.vectors_for(["w3", "w4"])
    d, i = port.knn_matrix(q, 5)
    dj, ij = eng.knn_matrix(to_jax(np_(q)), 5)
    assert_same_top_k(d, i, dj, ij, atol=atol)


def test_knn_batch_exact_matches_jax(saved_jax_engine):
    eng, path = saved_jax_engine
    port = Freddy.load(path, device="cpu")
    words = ["w1", "w2", "w3"]
    got, want = port.knn_batch_exact(words, 4), eng.knn_batch_exact(words, 4)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               atol=1e-5)


def test_vector_queries_match_jax(saved_jax_engine, rng):
    eng, path = saved_jax_engine
    port = Freddy.load(path, device="cpu")
    assert port.dispatch["knn"] == eng.dispatch["knn"]
    vec = rng.normal(size=D).astype(np.float32)
    got, want = port.knn(vec, 5), eng.knn(vec, 5)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5)


def test_engine_save_load_round_trip(saved_jax_engine, tmp_path):
    _, path = saved_jax_engine
    port = Freddy.load(path, device="cpu")
    port.set_pvf(7)
    port.set_pv_shortlist("exact")
    port.set_knn_function("k_nearest_neighbour_pq_pv")
    port.save(tmp_path / "e")
    back = Freddy.load(tmp_path / "e", device="cpu")
    assert back.params.pvf == 7 and back.params.pv_shortlist == "exact"
    assert back.dispatch["knn"] == "k_nearest_neighbour_pq_pv"
    assert back.knn("w5", 5) == port.knn("w5", 5)
    # and the JAX engine reads the port's directory
    jeng = JFreddy.load(tmp_path / "e")
    assert [w for w, _ in jeng.knn("w5", 5)] == [w for w, _ in
                                                 port.knn("w5", 5)]


def test_port_build_runs_the_slice(rng):
    words = [f"w{i}" for i in range(2048)]
    store = VectorStore.from_arrays(words, _clustered(rng, n=2048),
                                    device="cpu")
    eng = Freddy.build(store, with_ivfadc=False, with_ivpq=False, pq_m=12,
                       pq_k=16, train_size=None, iters=4, opq_iters=2)
    assert eng.knn("w3", 3)[0][0] == "w3"
    eng.set_knn_function("k_nearest_neighbour_pq_pv")
    assert eng.knn("w3", 3)[0][0] == "w3"
    assert eng.tracker.get_results()["total_time"]


# ---------------------------------------------------- what is not ported

def test_every_jax_engine_method_exists_or_raises(saved_jax_engine):
    import inspect
    _, path = saved_jax_engine
    port = Freddy.load(path, device="cpu")
    public = [n for n, v in inspect.getmembers(JFreddy)
              if not n.startswith("_") and callable(v)]
    for name in public:
        assert hasattr(port, name), name
    assert set(NOT_PORTED) == {"enable_sharding"}
    for name in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(port, name)()


def test_unported_families_raise(saved_jax_engine):
    """What the slices so far left out raises and names its ROADMAP item:
    the mesh. Anisotropic refinement, which raised until it was ported,
    now builds."""
    _, path = saved_jax_engine
    store = Freddy.load(path, device="cpu").store
    with pytest.raises(NotImplementedError, match="sharding"):
        Freddy.build(store, mesh=object())
    eng = Freddy.build(store, with_ivfadc=False, with_ivpq=False,
                       aniso_eta=2.0, train_size=None, iters=3)
    assert eng.pq.codes.shape[0] == store.size


def test_jax_engine_with_int8_luts_loads_on_a_cuda_engine(saved_jax_engine,
                                                          tmp_path,
                                                          monkeypatch):
    """An engine the JAX package saved with ``pq_lut_dtype="int8"`` loads
    on a CUDA engine (the device is patched, the tensors stay on the CPU)
    and routes PQ to the int8 kernels; on the CPU the knob is ignored, as
    the JAX engine ignores it off the TPU."""
    eng, _ = saved_jax_engine
    eng.set_pq_lut_dtype("int8")
    try:
        eng.save(tmp_path)
    finally:
        eng.set_pq_lut_dtype("bf16")
    cpu = Freddy.load(tmp_path, device="cpu")
    assert cpu.params.pq_lut_dtype == "int8" and cpu._pq_impl() is None
    monkeypatch.setattr(VectorStore, "device",
                        property(lambda self: torch.device("cuda")))
    port = Freddy.load(tmp_path, device="cpu")
    assert port.params.pq_lut_dtype == "int8"
    assert port._pq_impl() == "kernel_int8"
    with pytest.raises(ValueError, match="pq_lut_dtype"):
        port.set_pq_lut_dtype("fp8")


def test_jax_engine_with_int8_exact_loads(saved_jax_engine, tmp_path):
    """An engine the JAX package saved with ``exact_dtype="int8"`` loads
    in the port and its exact family answers as the JAX engine's does."""
    eng, _ = saved_jax_engine
    JFreddy(eng.store, pq=eng.pq, exact_dtype="int8").save(tmp_path)
    jeng = JFreddy.load(tmp_path)
    port = Freddy.load(tmp_path, device="cpu")
    assert port.exact.compute_dtype == "int8"
    _same_knn(jeng, port)


# ------------------------------------------------- slice 2: the probe path

@pytest.fixture(scope="module")
def saved_probe_engine(tmp_path_factory):
    """A JAX engine with IVFADC (24 cells) and IVPQ (2 × 8 coarse
    centroids) and an active statistics table, built on CPU and saved."""
    return save_jax_engine(tmp_path_factory.mktemp("probe_engine"),
                           **PROBE_ENGINE)


def _rows_as_top_k(rows, store, names, k):
    """``(query, word, sim)`` rows → (−sim, id) matrices, padded."""
    sims = {n: [] for n in names}
    ids = {n: [] for n in names}
    for q, w, s in rows:
        sims[q].append(-s)
        ids[q].append(store.get_id(w))
    d = np.array([(sims[n] + [np.inf] * k)[:k] for n in names], np.float32)
    i = np.array([(ids[n] + [-1] * k)[:k] for n in names])
    return d, i


def _same_join(got, want, port, eng, names, k, atol=1e-4):
    assert len(got) == len(want)
    assert_same_top_k(*_rows_as_top_k(got, port.store, names, k),
                      *_rows_as_top_k(want, eng.store, names, k), atol=atol)


def test_probe_engine_loads_in_the_port(saved_probe_engine):
    eng, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    assert port.pq is None and port.ivfadc.num_cells == 24
    assert port.ivpq.num_cells == 64 and port.params.statistics_table == "dom"
    np.testing.assert_allclose(np_(port.statistics["dom"]),
                               np.asarray(eng.statistics["dom"]), rtol=1e-6)
    assert port.dispatch == eng.dispatch


@pytest.mark.parametrize("family", ["k_nearest_neighbour_ivfadc",
                                    "k_nearest_neighbour_ivfadc_pv"])
def test_ivfadc_families_match_jax(saved_probe_engine, family):
    eng, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    for e in (eng, port):
        e.set_knn_function(family)
        e.set_w(2)
        e.set_pvf(5)
    try:
        _same_knn(eng, port, atol=1e-4)
    finally:
        eng.set_knn_function("k_nearest_neighbour")
        eng.set_w(3)
        eng.set_pvf(20)


def test_knn_batch_matches_jax(saved_probe_engine):
    eng, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    words = [f"w{i}" for i in range(0, 400, 37)]
    assert port.dispatch["knn_batch"] == "k_nearest_neighbour_ivfadc_batch"
    _same_join(port.knn_batch(words, 6), eng.knn_batch(words, 6), port, eng,
               words, 6)


@pytest.mark.parametrize("method", [0, 1, 2])
def test_join_facades_match_jax(saved_probe_engine, method):
    """``knn_in_ivpq_batch`` on a named prepared target set with the
    active statistics, through the generic ``knn_join`` façade, and the
    single-query ``knn_in_ivpq``."""
    eng, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    words = [f"w{i}" for i in range(1, 300, 23)]
    targets = [f"w{i}" for i in range(0, N, 3)]
    for e in (eng, port):
        e.prepare_targets(targets, name="t")
        e.set_alpha(20)
        e.set_method_flag(method)
        e.set_pvf(4)
        e.set_knn_join_function("knn_in_ivpq_batch")
    try:
        _same_join(port.knn_join(words, 5, "t"), eng.knn_join(words, 5, "t"),
                   port, eng, words, 5)
        _same_join(port.knn_in_ivpq_batch(words, 5, targets),
                   eng.knn_in_ivpq_batch(words, 5, targets), port, eng,
                   words, 5)
        got = port.knn_in_ivpq("w3", 5, "t")
        want = eng.knn_in_ivpq("w3", 5, "t")
        assert [w for w, _ in got][:1] == [w for w, _ in want][:1] == ["w3"]
        results = port.tracker.get_results()
        assert results["retrieved"] and results["computation_time"]
    finally:
        eng.set_knn_join_function("knn_search_in_batch")
        eng.set_method_flag(0)
        eng.set_alpha(3)
        eng.set_pvf(20)


def test_exact_join_matches_jax(saved_probe_engine):
    eng, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    words = ["w5", "w6", "w700"]
    targets = list(range(0, N, 5))
    assert port.dispatch["knn_join"] == "knn_search_in_batch"
    _same_join(port.knn_join(words, 4, targets),
               eng.knn_join(words, 4, targets), port, eng, words, 4,
               atol=1e-5)


def test_probe_engine_save_load_round_trip(saved_probe_engine, tmp_path):
    _, path = saved_probe_engine
    port = Freddy.load(path, device="cpu")
    port.set_alpha(9)
    port.set_confidence_value(0.6)
    port.set_long_codes_threshold(123.0)
    port.set_use_targetlist(False)
    port.create_statistics("small", ["w1", "w2", "nope"])
    port.save(tmp_path / "e")
    back = Freddy.load(tmp_path / "e", device="cpu")
    assert (back.params.alpha, back.params.confidence,
            back.params.long_codes_threshold, back.params.use_targetlist) == (
                9, 0.6, 123.0, False)
    assert back.params.statistics_table == "small"
    assert set(back.statistics) == {"dom", "small"}
    assert torch.equal(back.ivfadc.codes_sorted, port.ivfadc.codes_sorted)
    jeng = JFreddy.load(tmp_path / "e")          # the JAX engine reads it
    np.testing.assert_array_equal(np.asarray(jeng.ivpq.codes),
                                  np_(port.ivpq.codes))
    with pytest.raises(KeyError):
        back.set_statistics_table("missing")
