"""The port's driver entry points (``postgres_word2vec_tpu_torch
.graft_entry``) against the repository's ``__graft_entry__.py``, on the
CPU: the forward step's shapes, the forward step over the JAX-built tiny
index (carried across by ``utils/convert.ivpq_from_numpy``) held to the
JAX ``forward`` — ids equal up to ties, values within 1e-5, ``retrieved``
equal — and the mesh dry run on CPU entries."""

import sys

import jax
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu_torch import graft_entry
from postgres_word2vec_tpu_torch.utils import convert
from test_torch_parity_util import REPO, assert_same_top_k, np_

sys.path.insert(0, str(REPO))

import __graft_entry__ as jgraft  # noqa: E402

TOL = 1e-5


def test_entry_runs_on_the_cpu_with_the_jax_shapes():
    fn, args = graft_entry.entry(device="cpu")
    vals, ids, retrieved = fn(*args)
    assert vals.shape == (16, 5)
    assert ids.shape == (16, 5)
    assert retrieved.shape == (16,)
    assert vals.device.type == "cpu"
    # every query finds itself: it is a row of the index, and its own
    # target when even
    ids_h = np_(ids)
    assert all(ids_h[i, 0] == i for i in range(0, 16, 2))


@pytest.fixture(scope="module")
def jax_index():
    """The JAX ``_tiny_index`` and its rows as numpy arrays."""
    idx, vecs = jgraft._tiny_index()
    arrays = {"coarse_centroids": idx.coarse.centroids,
              "cell_counts": idx.coarse.cell_counts,
              "centroids": idx.codebook.centroids,
              "counts": idx.codebook.counts,
              "codes": idx.codes, "cell_of": idx.cell_of}
    return {k: np.array(v) for k, v in arrays.items()}, np.array(vecs)


@pytest.mark.parametrize("confidence,rows", [(0.8, slice(0, 16)),
                                             (0.3, slice(100, 132))],
                         ids=["example", "confidence0.3"])
def test_forward_step_matches_jax_forward(jax_index, confidence, rows):
    arrays, vecs = jax_index
    fn = graft_entry.forward_step(
        convert.ivpq_from_numpy(arrays, device="cpu"),
        torch.from_numpy(vecs))
    vals, ids, retrieved = fn(torch.from_numpy(vecs[rows]), confidence)
    jfn, (jq, jc) = jgraft.entry()
    assert jq.shape == (16, 32) and float(jc) == pytest.approx(0.8)
    want = jax.jit(jfn)(vecs[rows], np.float32(confidence))
    assert_same_top_k(vals, ids, want[0], want[1], atol=TOL)
    np.testing.assert_array_equal(np_(retrieved), np.asarray(want[2]))


def test_entry_uses_the_jax_example_arguments():
    """``(vecs[:16], 0.8)``: the same seeded rows as the JAX entry's."""
    _, (q, conf) = graft_entry.entry(device="cpu")
    _, (jq, jconf) = jgraft.entry()
    np.testing.assert_array_equal(np_(q), np.asarray(jq))
    assert conf == pytest.approx(float(jconf))


@pytest.mark.parametrize("n_devices", [4, 8, 3, 1])
def test_dryrun_multichip_runs_on_cpu_entries(n_devices, capsys):
    graft_entry.dryrun_multichip(n_devices, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip ok: mesh=")
    q = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    assert f"'rows': {n_devices // q}, 'q': {q}" in out
    assert ("not multi-GPU scaling" in out) == (n_devices > 1)


def test_main_runs_the_forward_step_and_the_dry_run(capsys):
    graft_entry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry forward: [(16, 5), (16, 5), (16,)]" in out
    assert "dryrun_multichip ok: mesh={'rows': 4, 'q': 2}" in out


@pytest.mark.parametrize("call", [
    lambda: graft_entry.entry(),
    lambda: graft_entry.dryrun_multichip(4)], ids=["entry", "dryrun"])
def test_without_a_card_it_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
