"""The port's int8 configuration against the JAX package (CPU): the int8
LUT quantization, the plain versions of K3 / K5 / K8 against the JAX
package's Pallas kernels run in interpret mode, the PQ int8 search modes,
the join's int8 budget round, and the int8 exact index.

Tolerances:
- quantized LUTs and int8 row tables: equal (same float32 inputs, the same
  true divisions, rounding half to even on both sides);
- K3 dense: atol 1e-6 on distances of at most 4 (exact int32 sums and
  one float32 multiply on both sides; the JAX program, under these tests'
  8-device CPU configuration, rounds that multiply one ulp away in places,
  where the port's equals the exactly rounded product);
- K5 binned: mins and ids equal away from the ragged last tile (the JAX
  kernel scans its padding rows there; the port masks them);
- K8 grouped: atol 1e-5 on the finite entries (the int32 sums are exact;
  the JAX program may contract ``sum·scale + rowterm`` into one rounding,
  the port rounds twice), with the same +inf entries;
- exact int8: distances within 1e-4 (float32 norms and rescale summed in
  another order), ids up to ties;
- the int8 join: held to the port's own float join, since the JAX budget
  round reaches its Pallas kernel only on a TPU (its ``interpret`` flag is
  not exposed): the same query's top-1 and a top-5 overlap of at least 0.9.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from postgres_word2vec_tpu.models import exact as jexact
from postgres_word2vec_tpu.models import pq as jpq
from postgres_word2vec_tpu.ops import lut as jlut
from postgres_word2vec_tpu.ops import pallas_kernels as pk

from postgres_word2vec_tpu_torch.models import exact
from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import kernels
from postgres_word2vec_tpu_torch.utils.convert import pq_from_numpy

from test_torch_parity_util import assert_same_top_k, np_, to_jax, to_torch


def _luts(rng, B, m, k, d=None):
    """LUTs of unit-norm queries against a codebook of the same scale, so
    distances are O(1) as in the engine (at most 4). Queries are
    m·(48 // m) wide unless ``d`` is given (48 at m = 12)."""
    d = m * max(1, 48 // m) if d is None else d
    cb = (rng.normal(size=(m, k, d // m)) / np.sqrt(d)).astype(np.float32)
    q = rng.normal(size=(B, d))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return np_(jlut.build_luts(to_jax(q), to_jax(cb)))


def _codes(rng, n, m, k):
    return rng.integers(0, k, size=(n, m)).astype(
        np.uint8 if k <= 256 else np.int16)


def _clustered(rng, n, d=48, centers=64):
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.6 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("k", [16, 256, 1024])
def test_quantize_luts_int8_matches_jax(rng, k):
    luts = _luts(rng, 9, 12, k)
    q, s = kernels.quantize_luts_int8(to_torch(luts))
    jq, js = pk._quantize_luts_int8(to_jax(luts))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(np_(q), np.asarray(jq))
    np.testing.assert_array_equal(np_(s), np.asarray(js))


# -------------------------------------------------------------- K3 and K5

# (B, k, n): uint8 codes at k = 16, 32 and 256, int16 codes at k = 1024;
# ragged B (not a multiple of 8) and ragged N (not a multiple of 2048).
SCAN_CASES = [(5, 16, 4096), (3, 32, 2049), (9, 256, 6000), (4, 1024, 2047)]
# K3 sums m biased bytes per 16-bit lane, so the dense scan is also held to
# JAX at the port's larger m: the join's 30×32 codebook and 60×16.
DENSE_CASES = ([pytest.param(12, *c, id="-".join(map(str, c)))
                for c in SCAN_CASES]
               + [pytest.param(30, 3, 32, 2049, id="m30-3-32-2049"),
                  pytest.param(60, 5, 16, 4096, id="m60-5-16-4096")])


@pytest.mark.parametrize("m,B,k,n", DENSE_CASES)
def test_plain_adc_scan_int8_matches_pallas_interpret(rng, m, B, k, n):
    luts, codes = _luts(rng, B, m, k), _codes(rng, n, m, k)
    got = kernels.adc_scan(to_torch(luts), to_torch(codes.T).contiguous(),
                           lut_dtype="int8")
    pad = (-n) % 2048                     # the JAX kernel takes whole tiles
    want = pk.adc_scan_pallas(to_jax(luts),
                              to_jax(np.pad(codes, ((0, pad), (0, 0))).T),
                              block_n=2048, lut_dtype="int8",
                              interpret=True)
    np.testing.assert_allclose(np_(got), np.asarray(want)[:, :n], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("B,k,n", SCAN_CASES)
def test_plain_adc_scan_binned_int8_matches_pallas_interpret(rng, B, k, n):
    m = 12
    luts, codes = _luts(rng, B, m, k), _codes(rng, n, m, k)
    mins, ids = kernels.adc_scan_binned(to_torch(luts),
                                        to_torch(codes.T).contiguous(),
                                        lut_dtype="int8")
    pad = (-n) % 2048
    jm, ji = pk.adc_scan_binned_pallas(
        to_jax(luts), to_jax(np.pad(codes, ((0, pad), (0, 0))).T),
        block_n=2048, bins=128, lut_dtype="int8", interpret=True)
    whole = (n // 2048) * 128             # bins of the whole tiles
    np.testing.assert_array_equal(np_(mins)[:, :whole],
                                  np.asarray(jm)[:, :whole])
    np.testing.assert_array_equal(np_(ids)[:, :whole],
                                  np.asarray(ji)[:, :whole])
    # the ragged tile: masked rows never win; empty bins are +inf, id −1
    tail_m, tail_i = np_(mins)[:, whole:], np_(ids)[:, whole:]
    assert ((tail_i == -1) == np.isinf(tail_m)).all()
    assert (tail_i < n).all()
    dense = np_(kernels.adc_scan(to_torch(luts),
                                 to_torch(codes.T).contiguous(),
                                 lut_dtype="int8"))
    fin = tail_i >= 0
    np.testing.assert_array_equal(
        np.take_along_axis(dense, np.maximum(tail_i, 0), 1)[fin],
        tail_m[fin])


def test_int8_top_k_wrappers_match_jax(rng):
    luts, codes = _luts(rng, 6, 12, 256), _codes(rng, 4096, 12, 256)
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    got = kernels.adc_top_k(lt, ct, 10, valid_n=4000, lut_dtype="int8")
    want = pk.adc_top_k_pallas(to_jax(luts), to_jax(codes.T), 10,
                               valid_n=4000, approx=False, lut_dtype="int8",
                               interpret=True)
    assert_same_top_k(*got, *want, atol=1e-6)
    got = kernels.adc_top_k_binned(lt, ct, 10, valid_n=4000,
                                   lut_dtype="int8")
    want = pk.adc_top_k_binned_pallas(to_jax(luts), to_jax(codes.T), 10,
                                      valid_n=4000, approx=False,
                                      lut_dtype="int8", interpret=True)
    assert_same_top_k(*got, *want, atol=1e-6)


def test_int8_wrappers_take_the_plain_path_on_cpu(rng):
    luts, codes = _luts(rng, 3, 12, 16), _codes(rng, 2049, 12, 16)
    lt, ct = to_torch(luts), to_torch(codes.T).contiguous()
    q, s = kernels.quantize_luts_int8(lt)
    kernels.reset_launch_counts()
    assert torch.equal(kernels.adc_scan_int8(q, s, ct),
                       kernels.adc_scan_plain(q, ct, scale=s))
    got = kernels.adc_scan_binned_int8(q, s, ct)
    want = kernels.adc_scan_binned_plain(q, ct, scale=s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    with pytest.raises(ValueError, match="lut_dtype"):
        kernels.adc_scan(lt, ct, lut_dtype="fp8")


# --------------------------------------------------------------------- K8

def _budget_case(rng, B=12, m=6, k=32, block_t=128, nt=5, P=4, d=30):
    """Unit-norm queries and codebook (so distances are O(1), as in the
    engine); tile ids with an inf-tile slot and pad rows inside a tile."""
    cb = rng.normal(size=(m, k, d // m)).astype(np.float32) * 0.2
    q = _clustered(rng, B, d=d)
    na = (nt + 1) * block_t
    codes = rng.integers(0, k, size=(na, m)).astype(np.uint8)
    rowterm = rng.normal(size=(na,)).astype(np.float32)
    rowterm[2 * block_t + 100:3 * block_t] = np.inf
    rowterm[nt * block_t:] = np.inf
    luts = np_(jlut.build_luts(to_jax(q), to_jax(cb)))
    tiles = rng.integers(0, nt, size=(B, P)).astype(np.int32)
    tiles[3, 2] = nt
    tiles[7, :] = 0
    return luts, codes, rowterm, tiles, block_t


@pytest.mark.parametrize("rows", [8, 32])
def test_plain_budget_adc_grouped_int8_matches_pallas_interpret(rng, rows):
    luts, codes, rowterm, tiles, bt = _budget_case(rng, B=40, P=6)
    got = kernels.budget_adc_grouped(
        to_torch(luts), to_torch(codes.T).contiguous(), to_torch(rowterm),
        to_torch(tiles), block_t=bt, rows=rows, lut_dtype="int8")
    want = np.asarray(pk.budget_adc_grouped_pallas(
        to_jax(luts), to_jax(codes.T), to_jax(rowterm), to_jax(tiles),
        block_t=bt, rows=rows, lut_dtype="int8", interpret=True))
    got = np_(got)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5


def test_budget_adc_auto_int8_routes_as_jax(rng):
    """Grouped probes take the int8 LUTs (K8's plain version here); a
    sparse probe selects the per-query kernel, which has no int8 twin:
    JAX and the port both warn and keep float LUTs."""
    luts, codes, rowterm, tiles, bt = _budget_case(rng, B=64, P=8)
    args = (to_torch(luts), to_torch(codes.T).contiguous(),
            to_torch(rowterm), to_torch(tiles))
    q, s = kernels.quantize_luts_int8(args[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = kernels.budget_adc_auto(*args, block_t=bt, lut_dtype="int8")
    assert torch.equal(got, kernels.budget_adc_plain(
        q, *args[1:], block_t=bt, scale=s))
    sparse = (args[0][:2], args[1], args[2], args[3][:2, :1])
    with pytest.warns(UserWarning, match="no int8 variant"):
        pk.budget_adc_auto(to_jax(luts[:2]), to_jax(codes.T),
                           to_jax(rowterm), to_jax(tiles[:2, :1]),
                           block_t=bt, lut_dtype="int8", interpret=True)
    with pytest.warns(UserWarning, match="no int8 variant"):
        out = kernels.budget_adc_auto(*sparse, block_t=bt, lut_dtype="int8")
    assert torch.equal(out, kernels.budget_adc_plain(*sparse, block_t=bt))


# ---------------------------------------------------------------- exact

def test_quantize_rows_int8_matches_jax(rng):
    v = rng.normal(size=(700, 300)).astype(np.float32)
    v[3] = 0.0                                    # a zero row: scale 0
    q, s = exact.quantize_rows_int8(to_torch(v), chunk_rows=256)
    jq, js = jexact.quantize_rows_int8(to_jax(v))
    np.testing.assert_array_equal(np_(q), np.asarray(jq))
    np.testing.assert_array_equal(np_(s), np.asarray(js))


@pytest.mark.parametrize("chunk", [512, 1 << 20])
def test_exact_top_k_int8_matches_jax(rng, chunk):
    v = _clustered(rng, 3000)
    q = v[:7] + 0.05 * rng.normal(size=(7, 48)).astype(np.float32)
    tq, ts = exact.quantize_rows_int8(to_torch(v))
    norms = to_torch((v * v).sum(1))
    got = exact.exact_top_k_int8(to_torch(q), tq, ts, norms, 10,
                                 chunk_size=chunk)
    jq, js = jexact.quantize_rows_int8(to_jax(v))
    want = jexact.exact_top_k_int8(to_jax(q), jq, js, to_jax(np_(norms)),
                                   10, chunk_size=chunk, approx=False)
    assert_same_top_k(*got, *want, atol=1e-4)


def test_exact_index_int8_matches_jax(rng):
    v = _clustered(rng, 3000, d=300)
    q = v[10:16]
    idx = ExactIndex(to_torch(v), "int8")
    jidx = jexact.ExactIndex(to_jax(v), "int8")
    assert idx._table.shape == (3000, 304)        # width padded to 8
    assert_same_top_k(*idx.search(to_torch(q), 10),
                      *jidx.search(to_jax(q), 10), atol=1e-4)
    tids = np.array([5, 9, 40, 7, 300, 2, 11, 12], np.int32)
    got = idx.search_in(to_torch(q), 4, to_torch(tids))
    want = jidx.search_in(to_jax(q), 4, to_jax(tids))
    assert_same_top_k(*got, *want, atol=1e-5)     # float32 on both sides


# ------------------------------------------------------------------- PQ

@pytest.fixture(scope="module")
def pq_pair():
    """A JAX OPQ index and the port's copy of it, and their table."""
    rng = np.random.default_rng(21)
    v = _clustered(rng, 4096)
    jidx = jpq.PQIndex.build(jax.random.PRNGKey(3), to_jax(v), m=12, k=16,
                             train_size=None, iters=4, opq_iters=2)
    arrays = {"centroids": np.asarray(jidx.codebook.centroids),
              "counts": np.asarray(jidx.codebook.counts),
              "codes": np.asarray(jidx.codes),
              "rotation": np.asarray(jidx.rotation)}
    return v, jidx, pq_from_numpy(arrays, device="cpu")


def _jax_pq_int8(jidx, q, k, binned):
    """The JAX package's int8 kernel on its own LUTs, in interpret mode."""
    luts = jlut.build_luts(jidx._rotate(to_jax(q)), jidx.codebook.centroids)
    ct = jidx.transposed_codes()
    fn = pk.adc_top_k_binned_pallas if binned else pk.adc_top_k_pallas
    return fn(luts, ct, k, valid_n=jidx.size, block_n=2048, approx=False,
              lut_dtype="int8", interpret=True)


@pytest.mark.parametrize("impl,binned", [("kernel_int8", False),
                                         ("kernel_binned_int8", True)])
def test_pq_int8_search_matches_jax(pq_pair, impl, binned):
    v, jidx, idx = pq_pair
    q = v[:9]
    got = idx.search(to_torch(q), 10, impl=impl)
    assert_same_top_k(*got, *_jax_pq_int8(jidx, q, 10, binned), atol=1e-5)


def test_pq_int8_search_pv_matches_jax(pq_pair):
    """The approx shortlist (k·pvf ≥ 100) runs K5's plain version; the same
    shortlist from the JAX int8 binned kernel, re-ranked exactly, gives the
    same words."""
    v, jidx, idx = pq_pair
    q = v[100:108]
    got = idx.search_pv(to_torch(q), 5, 20, to_torch(v), impl="kernel_int8")
    cd, ci = _jax_pq_int8(jidx, q, 100, True)
    from postgres_word2vec_tpu.ops import adc as jadc
    want = jadc.post_verify(to_jax(q), ci, cd, to_jax(v), 5)
    assert_same_top_k(*got, *want, atol=1e-5)
    assert (np_(got[1])[:, 0] == np.arange(100, 108)).all()


def test_pq_int8_dense_past_the_bar_degrades_to_binned(pq_pair,
                                                       monkeypatch):
    """"kernel_int8" is a LUT dtype preference, not an exactness demand:
    past the dense bar it warns and keeps int8 on the binned kernel (JAX
    tests/test_pq.py:278-290); an explicit "kernel" still raises."""
    _, _, idx = pq_pair
    monkeypatch.setattr(PQIndex, "_DENSE_SCAN_BYTES", 1)
    with pytest.warns(UserWarning, match="binned"):
        mode, _, _ = idx._search_plan(64, approx=False, impl="kernel_int8")
    assert mode == "binned_i8"
    with pytest.raises(ValueError, match="kernel_binned"):
        idx._search_plan(64, approx=False, impl="kernel")
    assert idx._search_plan(64, approx=True, impl="kernel_int8")[0] == \
        "binned_i8"
    monkeypatch.undo()
    assert idx._search_plan(64, approx=False, impl="kernel_int8")[0] == \
        "dense_i8"
    with pytest.raises(ValueError, match="impl"):
        idx.search(torch.zeros(1, 48), 5, impl="pallas_int8")


# ----------------------------------------------------------------- join

@pytest.mark.parametrize("method", [0, 2])
def test_join_int8_budget_round_agrees_with_float(method):
    rng = np.random.default_rng(31)
    x = to_torch(_clustered(rng, 3000))
    g = torch.Generator().manual_seed(0)
    idx = IVPQIndex.build(g, x, m=12, k=16, k_coarse=16, coarse_positions=1,
                          train_size=None, iters=4)
    tids = torch.arange(0, 3000, 2)
    q = x[:256:4]
    kw = dict(vectors=x, alpha=40, method=method, impl="budget")
    d8, i8 = idx.search_join(q, 5, tids, lut_dtype="int8", **kw)
    df, i_f = idx.search_join(q, 5, tids, **kw)
    assert (i8[:, 0] == i_f[:, 0]).all()
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 5
                       for a, b in zip(i8, i_f)])
    assert overlap >= 0.9
    if method == 2:                               # exact re-rank on both
        torch.testing.assert_close(d8[:, 0], df[:, 0])
    # the dense round ignores the knob, as in the JAX package
    dd8 = idx.search_join(q, 5, tids, vectors=x, alpha=40, method=method,
                          impl="dense", lut_dtype="int8")
    ddf = idx.search_join(q, 5, tids, vectors=x, alpha=40, method=method,
                          impl="dense")
    assert all(torch.equal(a, b) for a, b in zip(dd8, ddf))
