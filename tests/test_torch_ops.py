"""The port's plain ops against their JAX twins on the same numpy inputs
(CPU): vector ops, top-k helpers, LUTs, ADC, post-verify, k-means, the
store and the synthetic generator."""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.evaluation import synth as jsynth
from postgres_word2vec_tpu.ops import adc as jadc
from postgres_word2vec_tpu.ops import kmeans as jkmeans
from postgres_word2vec_tpu.ops import lut as jlut
from postgres_word2vec_tpu.ops import topk as jtopk
from postgres_word2vec_tpu.ops import vector_ops as jvo
from postgres_word2vec_tpu.store import VectorStore as JStore
from postgres_word2vec_tpu.store import _load_text_embeddings_py
from postgres_word2vec_tpu.models import pq as jpq

from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.models import pq
from postgres_word2vec_tpu_torch.ops import adc, kmeans, lut, topk
from postgres_word2vec_tpu_torch.ops import vector_ops as vo
from postgres_word2vec_tpu_torch.store import VectorStore

from test_torch_parity_util import assert_same_top_k, np_, to_jax, to_torch


def _codebook_case(rng, B=5, m=12, k=256, dsub=4, n=3000):
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    q = rng.normal(size=(B, m * dsub)).astype(np.float32)
    dtype = np.uint8 if k <= 256 else np.int16
    codes = rng.integers(0, k, size=(n, m)).astype(dtype)
    return cb, q, codes


# ------------------------------------------------------------ vector ops

def test_vec_normalize_matches_jax(rng):
    x = rng.normal(size=(7, 48)).astype(np.float32)
    x[3] = 0.0                                  # the eps guard
    np.testing.assert_allclose(np_(vo.vec_normalize(to_torch(x))),
                               np_(jvo.vec_normalize(to_jax(x))),
                               rtol=1e-6, atol=1e-7)


def test_sim_sqdist_maps_match_jax(rng):
    d = rng.uniform(0, 4, size=20).astype(np.float32)
    np.testing.assert_allclose(np_(vo.sim_from_sqdist(to_torch(d))),
                               np_(jvo.sim_from_sqdist(to_jax(d))),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(vo.sqdist_from_sim(
        vo.sim_from_sqdist(to_torch(d)))), d, atol=1e-6)


def test_row_sqnorms_chunks(rng):
    x = rng.normal(size=(1001, 30)).astype(np.float32)
    np.testing.assert_allclose(np_(vo.row_sqnorms(to_torch(x),
                                                  chunk_rows=256)),
                               (x * x).sum(1), rtol=1e-5)


# ------------------------------------------------------------------ top-k

@pytest.mark.parametrize("ties", [False, True])
def test_top_k_smallest_matches_jax(rng, ties):
    d = rng.normal(size=(6, 500)).astype(np.float32)
    if ties:
        d = np.round(d, 1)                      # many exact ties
    got = topk.top_k_smallest(to_torch(d), 17)
    want = jtopk.top_k_smallest(to_jax(d), 17)
    assert_same_top_k(*got, *want, atol=0.0)
    assert got[1].dtype == torch.int64


def test_top_k_largest_matches_jax(rng):
    s = rng.normal(size=(4, 300)).astype(np.float32)
    got = topk.top_k_largest(to_torch(s), 9)
    want = jtopk.top_k_largest(to_jax(s), 9)
    assert_same_top_k(-got[0], got[1], -want[0], want[1], atol=0.0)


def test_merge_top_k_matches_jax(rng):
    va = np.sort(rng.normal(size=(3, 8)).astype(np.float32), 1)
    vb = np.sort(rng.normal(size=(3, 5)).astype(np.float32), 1)
    ia = rng.integers(0, 100, size=(3, 8))
    ib = rng.integers(100, 200, size=(3, 5))
    got = topk.merge_top_k_smallest(to_torch(va), to_torch(ia),
                                    to_torch(vb), to_torch(ib), 6)
    want = jtopk.merge_top_k_smallest(to_jax(va), to_jax(ia.astype(np.int32)),
                                      to_jax(vb), to_jax(ib.astype(np.int32)),
                                      6)
    assert_same_top_k(*got, *want, atol=0.0)


def test_chunked_top_k_matches_jax(rng):
    d = rng.normal(size=(4, 1000)).astype(np.float32)
    dt, dj = to_torch(d), to_jax(d)
    got = topk.chunked_top_k_smallest(lambda s: dt[:, s:s + 128], 1000, 128,
                                      11)
    want = jtopk.top_k_smallest(dj, 11)
    assert_same_top_k(*got, *want, atol=0.0)
    # fewer items than k: +inf / -1 padding
    v, i = topk.chunked_top_k_smallest(lambda s: dt[:, s:s + 4][:, :3], 3,
                                       4, 5)
    assert torch.isinf(v[:, 3:]).all() and (i[:, 3:] == -1).all()


# --------------------------------------------------------------- LUT + ADC

@pytest.mark.parametrize("k", [16, 256])
def test_build_luts_matches_jax(rng, k):
    cb, q, _ = _codebook_case(rng, k=k, n=1)
    np.testing.assert_allclose(np_(lut.build_luts(to_torch(q), to_torch(cb))),
                               np_(jlut.build_luts(to_jax(q), to_jax(cb))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [16, 256, 1024])
def test_adc_distances_matches_jax(rng, k):
    cb, q, codes = _codebook_case(rng, k=k)
    luts = np_(jlut.build_luts(to_jax(q), to_jax(cb)))
    got = adc.adc_distances(to_torch(luts), to_torch(codes))
    want = jadc.adc_distances(to_jax(luts), to_jax(codes))
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-4, rtol=0)


def test_adc_top_k_matches_jax(rng):
    cb, q, codes = _codebook_case(rng, k=16, n=5000)
    luts = np_(jlut.build_luts(to_jax(q), to_jax(cb)))
    got = adc.adc_top_k(to_torch(luts), to_torch(codes), 10,
                        chunk_size=1024)
    want = jadc.adc_top_k(to_jax(luts), to_jax(codes), 10, chunk_size=1024)
    assert_same_top_k(*got, *want, atol=1e-4)


def test_post_verify_matches_jax(rng):
    n, d, B, C = 400, 24, 6, 30
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cid = rng.integers(0, n, size=(B, C)).astype(np.int32)
    cd = rng.uniform(0, 1, size=(B, C)).astype(np.float32)
    cid[0, :5] = -1                             # invalid candidates
    cd[1, :4] = np.inf
    cid[2, :] = -1                              # fewer than k valid
    got = adc.post_verify(to_torch(q), to_torch(cid), to_torch(cd),
                          to_torch(vecs), 8)
    want = jadc.post_verify(to_jax(q), to_jax(cid), to_jax(cd),
                            to_jax(vecs), 8)
    assert_same_top_k(*got, *want, atol=1e-4)
    assert (np_(got[1])[2] == -1).all()


# ---------------------------------------------------------------- k-means

def _blobs(rng, m=3, n=600, dsub=5, centers=6):
    c = rng.normal(size=(m, centers, dsub)) * 4
    a = rng.integers(0, centers, size=(m, n))
    x = np.take_along_axis(c, a[:, :, None], axis=1) + rng.normal(
        size=(m, n, dsub))
    return x.astype(np.float32)


def test_split_subspaces_matches_jax(rng):
    x = rng.normal(size=(10, 12)).astype(np.float32)
    np.testing.assert_array_equal(np_(kmeans.split_subspaces(to_torch(x), 4)),
                                  np_(jkmeans.split_subspaces(to_jax(x), 4)))


def test_assign_matches_jax(rng):
    x = rng.normal(size=(700, 6)).astype(np.float32)
    c = rng.normal(size=(9, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(kmeans.assign(to_torch(x), to_torch(c), chunk_size=256)),
        np_(jkmeans.assign(to_jax(x), to_jax(c), chunk_size=256)))
    a, d = kmeans.assign_with_dist(to_torch(x), to_torch(c), chunk_size=256)
    ja, jd = jkmeans.assign_with_dist(to_jax(x), to_jax(c), chunk_size=256)
    np.testing.assert_array_equal(np_(a), np_(ja))
    np.testing.assert_allclose(np_(d), np_(jd), rtol=1e-5, atol=1e-5)


def test_lloyd_step_matches_jax_with_empty_cluster(rng):
    """One repaired Lloyd step from the same numpy centroids, batched over
    subspaces in the port and vmapped in JAX. Centroid 0 of each subspace
    sits far away, so it is empty and must reseed onto the worst-fit
    point."""
    x = _blobs(rng)
    c0 = x[:, :8].copy()
    c0[:, 0] = 100.0
    got = kmeans._lloyd_step_repair(to_torch(x), to_torch(c0))
    for j in range(x.shape[0]):
        want = jkmeans._lloyd_step_repair(to_jax(x[j]), to_jax(c0[j]))
        np.testing.assert_allclose(np_(got[0][j]), np_(want[0]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(np_(got[1][j]), np_(want[1]))
        np.testing.assert_allclose(float(got[2][j]), float(want[2]),
                                   rtol=1e-5)
    assert (np_(got[1])[:, 0] == 0).all()       # was empty before reseed


@pytest.mark.parametrize("k", [16, 256])
def test_encode_subspaces_matches_jax(rng, k):
    """Chunked encode, with an OPQ rotation, from the same codebook: the
    same codes, in the same storage dtype."""
    n, m, dsub = 1500, 6, 4
    x = rng.normal(size=(n, m * dsub)).astype(np.float32)
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.normal(size=(m * dsub, m * dsub)))
    rot = rot.astype(np.float32)
    got = kmeans.encode_subspaces(to_torch(x), to_torch(cb), chunk_size=512,
                                  rotation=to_torch(rot))
    want = np_(jkmeans.encode_subspaces(to_jax(x), to_jax(cb), chunk_size=512,
                                        rotation=to_jax(rot)))
    assert np_(got).dtype == want.dtype
    np.testing.assert_array_equal(np_(got), want)


def test_recount_and_reconstruct_match_jax(rng):
    m, k, dsub = 4, 16, 3
    cb = rng.normal(size=(m, k, dsub)).astype(np.float32)
    codes = rng.integers(0, k, size=(200, m)).astype(np.uint8)
    counts = np.zeros((m, k), np.int32)
    got = pq.recount(pq.PQCodebook(to_torch(cb), to_torch(counts)),
                     to_torch(codes))
    want = jpq.recount(jpq.PQCodebook(to_jax(cb), to_jax(counts)),
                       to_jax(codes))
    np.testing.assert_array_equal(np_(got.counts), np_(want.counts))
    np.testing.assert_array_equal(
        np_(pq.reconstruct(to_torch(codes), to_torch(cb))),
        np_(jpq.reconstruct(to_jax(codes), to_jax(cb))))


def test_kmeans_plus_plus_draws_distinct_rows():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 300, 4, generator=g)
    c = kmeans.kmeans_plus_plus_init(g, x, 12)
    assert c.shape == (2, 12, 4)
    for j in range(2):
        d = (c[j][:, None] - x[j][None]).abs().sum(-1)
        assert torch.all(d.min(dim=1).values == 0)       # rows of x
        assert len({tuple(r.tolist()) for r in c[j]}) == 12


@pytest.mark.parametrize("init", ["sample", "kmeans++"])
def test_kmeans_subspaces_fits_blobs(rng, init):
    x = _blobs(rng)
    g = torch.Generator().manual_seed(0)
    res = kmeans.kmeans_subspaces(g, to_torch(x), 6, iters=10, init=init,
                                  restarts=2)
    assert res.centroids.shape == (3, 6, 5)
    assert res.counts.sum(dim=1).tolist() == [600] * 3
    # unit-variance noise around the centers: mean distance ≈ √5
    assert torch.all(res.distortion < 3.0)


def test_opq_rotation_is_orthogonal(rng):
    x = rng.normal(size=(500, 12)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    rot, cb = pq.train_opq_rotation(g, to_torch(x), 4, 8, opq_iters=3,
                                    kmeans_iters=3)
    np.testing.assert_allclose(np_(rot @ rot.t()), np.eye(12), atol=1e-4)
    assert cb.centroids.shape == (4, 8, 3) and int(cb.counts.sum()) == 2000


# ------------------------------------------------------------------ store

def test_store_reads_and_writes_the_jax_format(rng, tmp_path):
    words = [f"w{i}" for i in range(50)]
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    JStore.from_arrays(words, vecs).save(tmp_path / "jax.npz")
    st = VectorStore.load(tmp_path / "jax.npz", device="cpu")
    assert st.words == words and st.get_id("w7") == 7 and "w7" in st
    np.testing.assert_allclose(np_(st.vectors_for(["w3", "w9"])),
                               np_(jvo.vec_normalize(to_jax(vecs[[3, 9]]))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np_(st.vector_for("w2", normalized=False)),
                               vecs[2])
    st.save(tmp_path / "port.npz")
    back = JStore.load(tmp_path / "port.npz")
    assert back.words == words
    np.testing.assert_array_equal(np.asarray(back.vectors), vecs)
    assert st.get_ids(["w1", "nope"], strict=False) == [1]
    with pytest.raises(ValueError):
        VectorStore.from_arrays(["a", "a"], vecs[:2], device="cpu")


def test_store_text_parser_matches_jax(rng, tmp_path):
    vecs = rng.normal(size=(6, 4)).astype(np.float32)
    path = tmp_path / "v.txt"
    lines = ["6 4"] + [f"t{i} " + " ".join(f"{v:.6f}" for v in row)
                       for i, row in enumerate(vecs)]
    path.write_text("\n".join(lines) + "\n")
    st = VectorStore.from_text_file(path, max_words=5, device="cpu")
    words, want = _load_text_embeddings_py(path, 5)
    assert st.words == words
    np.testing.assert_array_equal(np_(st.vectors), want)


# -------------------------------------------------------------- generator

def test_generator_uses_the_v3_parameters():
    assert synth.V3_PARAMS == jsynth.V3_PARAMS
    import inspect
    sig = inspect.signature(synth.generate_wordlike).parameters
    for name, value in jsynth.V3_PARAMS.items():
        assert sig[name].default == value


def test_generate_wordlike_is_seeded_and_unit_norm():
    a = synth.generate_wordlike(torch.Generator().manual_seed(1), 3000, 24,
                                chunk_size=1000)
    b = synth.generate_wordlike(torch.Generator().manual_seed(1), 3000, 24,
                                chunk_size=1000)
    assert a.shape == (3000, 24) and a.dtype == torch.float32
    assert torch.equal(a, b)
    torch.testing.assert_close(a.norm(dim=1), torch.ones(3000))


def _nn_profile(v):
    s = v @ v.T
    np.fill_diagonal(s, -np.inf)
    top = -np.sort(-s, axis=1)[:, :10]
    return top[:, 0].mean(), top[:, 9].mean(), s[np.isfinite(s)].mean()


def test_generate_wordlike_geometry_matches_jax():
    """Same geometry as the JAX generator (numbers differ by RNG): mean
    1st- and 10th-neighbour similarity and mean pairwise similarity."""
    import jax
    n, d = 4096, 48
    port = np_(synth.generate_wordlike(torch.Generator().manual_seed(0), n,
                                       d, n_topics=64))
    ref = np.asarray(jsynth.generate_wordlike(jax.random.PRNGKey(0), n, d,
                                              n_topics=64))
    for a, b in zip(_nn_profile(port), _nn_profile(ref)):
        assert abs(a - b) < 0.05, (a, b)


# ------------------------------------------- slice 2: probe-path ops

def test_pairwise_sqdist_matches_jax(rng):
    x = rng.normal(size=(40, 48)).astype(np.float32)
    c = rng.normal(size=(9, 48)).astype(np.float32)
    np.testing.assert_allclose(
        np_(kmeans.pairwise_sqdist(to_torch(x), to_torch(c))),
        np.asarray(jkmeans.pairwise_sqdist(to_jax(x), to_jax(c))),
        atol=1e-4)


def test_flat_kmeans_lloyd_matches_jax(rng):
    """One repaired Lloyd step from the same start gives the same flat
    centroids and counts; restarts keep the lowest distortion."""
    x = rng.normal(size=(800, 16)).astype(np.float32)
    c0 = x[:12].copy()
    c0[3] = 50.0                                 # an empty cluster to repair
    got = kmeans._lloyd_step_repair(to_torch(x), to_torch(c0))
    want = jkmeans._lloyd_step_repair(to_jax(x), to_jax(c0))
    np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    one = kmeans.kmeans(torch.Generator().manual_seed(3), to_torch(x), 12, 4)
    best = kmeans.kmeans(torch.Generator().manual_seed(3), to_torch(x), 12, 4,
                         restarts=3, init="kmeans++")
    assert one.centroids.shape == (12, 16) and int(one.counts.sum()) == 800
    assert float(best.distortion) <= float(kmeans.kmeans(
        torch.Generator().manual_seed(3), to_torch(x), 12, 4,
        init="kmeans++").distortion)


def test_encode_residual_subspaces_matches_jax(rng):
    x = rng.normal(size=(500, 48)).astype(np.float32)
    coarse = rng.normal(size=(7, 48)).astype(np.float32)
    assign = rng.integers(0, 7, 500).astype(np.int32)
    cb = rng.normal(size=(12, 16, 4)).astype(np.float32)
    got = kmeans.encode_residual_subspaces(to_torch(x), to_torch(coarse),
                                           to_torch(assign), to_torch(cb),
                                           chunk_size=128)
    want = jkmeans.encode_residual_subspaces(to_jax(x), to_jax(coarse),
                                             to_jax(assign), to_jax(cb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_double_luts_and_fused_codes_match_jax(rng):
    luts = rng.random(size=(3, 30, 32)).astype(np.float32)
    codes = rng.integers(0, 32, size=(50, 30)).astype(np.uint8)
    np.testing.assert_allclose(
        np_(lut.build_double_luts(to_torch(luts))),
        np.asarray(jlut.build_double_luts(to_jax(luts))), rtol=1e-6)
    fused = lut.fuse_codes(to_torch(codes), 32)
    assert fused.dtype == torch.int16               # pair codes reach 1023
    np.testing.assert_array_equal(np_(fused),
                                  np.asarray(jlut.fuse_codes(to_jax(codes),
                                                             32)))
    assert lut.fuse_codes(to_torch(codes), 256).dtype == torch.int32
    with pytest.raises(ValueError, match="even m"):
        lut.build_double_luts(to_torch(luts[:, :3]))


def test_adc_distances_per_query_matches_jax(rng):
    luts = rng.random(size=(4, 12, 16)).astype(np.float32)
    codes = rng.integers(0, 16, size=(4, 70, 12)).astype(np.uint8)
    np.testing.assert_allclose(
        np_(adc.adc_distances_per_query(to_torch(luts), to_torch(codes))),
        np.asarray(jadc.adc_distances_per_query(to_jax(luts),
                                                to_jax(codes))), atol=1e-5)


def _budget_table(rng, m=6, k=16, block_t=32, nt=5):
    na = (nt + 1) * block_t
    codes = rng.integers(0, k, size=(na, m)).astype(np.uint8)
    rowterm = rng.normal(size=na).astype(np.float32)
    rowterm[2 * block_t + 20:3 * block_t] = np.inf  # pad rows
    rowterm[nt * block_t:] = np.inf                 # the inf tile
    tiles = rng.integers(0, nt + 1, size=(7, 4)).astype(np.int32)
    return codes, rowterm, tiles


def _same_with_inf(got, want, atol):
    got, want = np_(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


def test_budget_adc_xla_matches_jax(rng):
    codes, rowterm, tiles = _budget_table(rng)
    luts = rng.random(size=(7, 6, 16)).astype(np.float32)
    got = adc.budget_adc_xla(to_torch(luts), to_torch(codes),
                             to_torch(rowterm), to_torch(tiles), block_t=32)
    want = jadc.budget_adc_xla(to_jax(luts), to_jax(codes), to_jax(rowterm),
                               to_jax(tiles), block_t=32)
    _same_with_inf(got, want, 1e-5)
    # the transposed code table the kernels read gives the same sums
    t_view = adc.budget_adc_xla(to_torch(luts), to_torch(codes.T).t(),
                                to_torch(rowterm), to_torch(tiles),
                                block_t=32)
    assert torch.equal(torch.isfinite(t_view), torch.isfinite(got))


def test_budget_exact_xla_matches_jax(rng):
    _, rownorm, tiles = _budget_table(rng)
    vecs = rng.normal(size=(rownorm.shape[0], 24)).astype(np.float32)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    got = adc.budget_exact_xla(to_torch(q), to_torch(vecs), to_torch(rownorm),
                               to_torch(tiles), block_t=32)
    want = jadc.budget_exact_xla(to_jax(q), to_jax(vecs), to_jax(rownorm),
                                 to_jax(tiles), block_t=32)
    _same_with_inf(got, want, 1e-4)


def test_adc_top_k_in_matches_jax(rng):
    cb, q, codes = _codebook_case(rng, B=4, k=16, n=600)
    luts = np_(lut.build_luts(to_torch(q), to_torch(cb)))
    tids = rng.choice(600, size=40, replace=False).astype(np.int32)
    mask = np.ones(40, bool)
    mask[[3, 9]] = False
    for k in (5, 45):                                # k beyond the set pads
        got = adc.adc_top_k_in(to_torch(luts), to_torch(codes),
                               to_torch(tids), to_torch(mask), k)
        want = jadc.adc_top_k_in(to_jax(luts), to_jax(codes), to_jax(tids),
                                 to_jax(mask), k)
        assert_same_top_k(*got, *want, atol=1e-5)
    assert (np_(got[1])[:, 38:] == -1).all()


def test_no_tf32_restores_the_callers_flag(rng):
    """The float32 paths switch TF32 off only while they run: a caller's
    own setting survives every call (the join runs post_verify per
    round)."""
    from postgres_word2vec_tpu_torch.ops import kernels

    v = to_torch(rng.normal(size=(300, 48)).astype(np.float32))
    q, ids = v[:3], torch.tensor([[0, 5, 9]] * 3)
    table, norms, _ = kernels.tile_table(v, block_n=256)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            adc.post_verify(q, ids, torch.zeros(3, 3), v, 2)
            kernels.fused_exact_scan_plain(
                kernels.pad_queries(q, table.shape[1]), table, norms,
                block_n=256)
            lut.build_luts(q, torch.zeros(12, 4, 4))
            kmeans.pairwise_sqdist(q, v[:5])
            assert torch.backends.cuda.matmul.allow_tf32 is flag
            with vo.no_tf32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
