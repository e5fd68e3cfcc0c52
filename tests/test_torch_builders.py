"""The port's streaming builders (``models/builders.py``) against the JAX
package's (CPU): the same codebook carried across gives the same codes
batch by batch (the same float32 encode, so equal codes), a checkpoint
written by either package resumes in the other, and the finalized indexes
search alike (distances within 1e-5, ids equal up to ties)."""

import jax
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.models import builders as jb
from postgres_word2vec_tpu.models.pq import PQCodebook as JCodebook

from postgres_word2vec_tpu_torch.models import builders as tb
from postgres_word2vec_tpu_torch.models.pq import PQCodebook

from test_torch_parity_util import (assert_same_top_k, clustered, np_,
                                    to_jax, to_torch)

N, D, M, K = 1200, 24, 6, 16


@pytest.fixture(scope="module")
def data():
    return clustered(np.random.default_rng(31), n=N, d=D, centers=24)


@pytest.fixture(scope="module")
def jax_pq(data):
    return jb.PQIndexCreator.from_training(jax.random.PRNGKey(0), data, m=M,
                                           k=K, iters=6)


@pytest.fixture(scope="module")
def jax_ivf(data):
    return jb.IVFADCIndexCreator.from_training(jax.random.PRNGKey(1), data,
                                               m=M, k=K, k_coarse=10,
                                               iters=6)


def _port_pq(jcreator):
    cb = jcreator.codebook
    return tb.PQIndexCreator(PQCodebook(to_torch(cb.centroids),
                                        to_torch(cb.counts)))


def _port_ivf(jcreator):
    cb = jcreator.codebook
    return tb.IVFADCIndexCreator(
        to_torch(jcreator.coarse_centroids),
        PQCodebook(to_torch(cb.centroids), to_torch(cb.counts)))


def _fresh(creator, package):
    """An empty builder of ``package`` ("jax"/"torch") with ``creator``'s
    trained quantizers."""
    cb = creator.codebook
    if package == "jax":
        jcb = JCodebook(to_jax(np_(cb.centroids)), to_jax(np_(cb.counts)))
        if isinstance(creator, (jb.PQIndexCreator, tb.PQIndexCreator)):
            return jb.PQIndexCreator(jcb)
        return jb.IVFADCIndexCreator(to_jax(np_(creator.coarse_centroids)),
                                     jcb)
    tcb = PQCodebook(to_torch(np_(cb.centroids)), to_torch(np_(cb.counts)))
    if isinstance(creator, (jb.PQIndexCreator, tb.PQIndexCreator)):
        return tb.PQIndexCreator(tcb)
    return tb.IVFADCIndexCreator(to_torch(np_(creator.coarse_centroids)),
                                 tcb)


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_vector_feeder_matches_jax(data, source):
    src = data if source == "numpy" else torch.from_numpy(data)
    got = list(tb.VectorFeeder(src, batch_size=500))
    want = list(jb.VectorFeeder(data, batch_size=500))
    assert [off for _, off in got] == [off for _, off in want]
    for (g, _), (w, _) in zip(got, want):
        assert isinstance(g, torch.Tensor) == (source == "tensor")
        np.testing.assert_array_equal(np_(g), w)


def test_pq_index_batch_codes_equal_jax(data, jax_pq):
    port = _port_pq(jax_pq)
    jfresh = _fresh(jax_pq, "jax")
    for batch, _ in jb.VectorFeeder(data, batch_size=256):
        got = port.index_batch(batch)
        want = jfresh.index_batch(batch)
        assert np_(got).dtype == np.uint8
        np.testing.assert_array_equal(np_(got), want)
    assert port.rows_done == N
    got, want = port.finalize(), jfresh.finalize()
    np.testing.assert_array_equal(np_(got.codes), np_(want.codes))
    np.testing.assert_array_equal(np_(got.codebook.counts),
                                  np_(want.codebook.counts))


def test_ivfadc_index_batch_codes_equal_jax(data, jax_ivf):
    port = _port_ivf(jax_ivf)
    jfresh = _fresh(jax_ivf, "jax")
    for batch, _ in jb.VectorFeeder(data, batch_size=300):
        codes, assign = port.index_batch(batch)
        jcodes, jassign = jfresh.index_batch(batch)
        np.testing.assert_array_equal(np_(assign), np_(jassign))
        np.testing.assert_array_equal(np_(codes), np_(jcodes))


@pytest.mark.parametrize("kind", ["pq", "ivfadc"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_resumes_in_the_other_package(tmp_path, data, jax_pq,
                                                 jax_ivf, kind, writer,
                                                 reader):
    trained = jax_pq if kind == "pq" else jax_ivf
    first = _fresh(trained, writer)
    feeder = jb.VectorFeeder(data, batch_size=400)
    b, _ = feeder.next_batch()
    first.index_batch(b)
    first.checkpoint(tmp_path / "ckpt.npz")
    cls = {("pq", "jax"): jb.PQIndexCreator,
           ("pq", "torch"): tb.PQIndexCreator,
           ("ivfadc", "jax"): jb.IVFADCIndexCreator,
           ("ivfadc", "torch"): tb.IVFADCIndexCreator}[kind, reader]
    resumed = (cls.resume(tmp_path / "ckpt.npz", device="cpu")
               if reader == "torch" else cls.resume(tmp_path / "ckpt.npz"))
    assert resumed.rows_done == 400
    while feeder.has_next():
        b, _ = feeder.next_batch()
        resumed.index_batch(b)
    whole = _fresh(trained, "jax")
    whole.index_batch(data)
    got, want = resumed.finalize(), whole.finalize()
    assert got.size == N
    if kind == "pq":
        np.testing.assert_array_equal(np_(got.codes), np_(want.codes))
    else:
        np.testing.assert_array_equal(np_(got.codes_sorted),
                                      np_(want.codes_sorted))
        np.testing.assert_array_equal(np_(got.row_ids), np_(want.row_ids))


def test_finalized_indexes_search_like_jax(data, jax_pq, jax_ivf):
    q = data[:16]
    port_pq, jx_pq = _port_pq(jax_pq), _fresh(jax_pq, "jax")
    port_ivf, jx_ivf = _port_ivf(jax_ivf), _fresh(jax_ivf, "jax")
    for c in (port_pq, jx_pq, port_ivf, jx_ivf):
        for batch, _ in jb.VectorFeeder(data, batch_size=500):
            c.index_batch(batch)
    d, i = port_pq.finalize().search(to_torch(q), 5)
    jd, ji = jx_pq.finalize().search(to_jax(q), 5)
    assert_same_top_k(d, i, jd, ji, atol=1e-5)
    d, i = port_ivf.finalize().search_adaptive(to_torch(q), 5, w=3)
    jd, ji = jx_ivf.finalize().search_adaptive(to_jax(q), 5, w=3)
    assert_same_top_k(d, i, jd, ji, atol=1e-5)


def test_from_training_and_resume_devices(tmp_path, data):
    gen = torch.Generator().manual_seed(0)
    pq = tb.PQIndexCreator.from_training(gen, data, m=M, k=K, iters=3,
                                         device="cpu")
    ivf = tb.IVFADCIndexCreator.from_training(gen, torch.from_numpy(data),
                                              m=M, k=K, k_coarse=8, iters=3)
    for c in (pq, ivf):
        assert c.device.type == "cpu"
        c.index_batch(data[:100])
        c.checkpoint(tmp_path / "c.npz")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                type(c).resume(tmp_path / "c.npz")
    assert pq.finalize().size == 100 and ivf.finalize().size == 100
