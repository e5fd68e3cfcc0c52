"""Where the port's entry points put their tensors (CPU).

Every entry point that builds or loads state runs on the card unless the
caller names another device: without a card and without ``device`` it
raises a ``RuntimeError`` that says to pass ``device="cpu"``, with
``device="cpu"`` it builds on the CPU, and by default it asks
``resolve_device`` for the card. A torch tensor handed to
``VectorStore.from_arrays`` keeps its own device. The saved engine is the
JAX package's, as the port's users load it."""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu import VectorStore as JStore
from postgres_word2vec_tpu.utils import migrate as jmigrate

from postgres_word2vec_tpu_torch import Freddy, PQIndex, VectorStore
from postgres_word2vec_tpu_torch import api, store as store_mod
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.utils import convert, device as device_mod
from postgres_word2vec_tpu_torch.utils import migrate
from postgres_word2vec_tpu_torch.utils.device import resolve_device

N, D = 512, 16
WORDS = [f"w{i}" for i in range(N)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A small JAX engine with every index family, saved, plus the same
    store as word2vec text and binary files and, without its OPQ PQ index
    (a dump cannot hold a rotation), as a FREDDY dump."""
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    eng = JFreddy.build(JStore.from_arrays(WORDS, vecs), seed=0, pq_m=4,
                        pq_k=16, ivfadc_m=4, ivfadc_k=16, k_coarse=8,
                        ivpq_m=4, ivpq_k=16, ivpq_k_coarse=4,
                        train_size=None, iters=3, opq_iters=1)
    path = tmp_path_factory.mktemp("device_engine")
    eng.save(path)
    text = path / "vectors.txt"
    text.write_text(f"{N} {D}\n" + "".join(
        w + " " + " ".join(f"{x:.6f}" for x in row) + "\n"
        for w, row in zip(WORDS, vecs)))
    (path / "vectors.bin").write_bytes(f"{N} {D}\n".encode() + b"".join(
        w.encode() + b" " + row.tobytes() + b"\n"
        for w, row in zip(WORDS, vecs)))
    jmigrate.export_engine(JFreddy(eng.store, ivfadc=eng.ivfadc,
                                   ivpq=eng.ivpq), path / "dump")
    return path, vecs


def _arrays(path, name):
    with np.load(path / f"{name}.npz", allow_pickle=False) as f:
        return {n: f[n] for n in f.files}


# name -> (call(path, vecs, **kw), the tensor whose device is checked)
ENTRY_POINTS = {
    "from_arrays_numpy": (
        lambda p, v, **kw: VectorStore.from_arrays(WORDS, v, **kw),
        lambda s: s.vectors),
    "from_arrays_list": (
        lambda p, v, **kw: VectorStore.from_arrays(WORDS[:3],
                                                   v[:3].tolist(), **kw),
        lambda s: s.vectors_norm),
    "from_text_file": (
        lambda p, v, **kw: VectorStore.from_text_file(p / "vectors.txt",
                                                      **kw),
        lambda s: s.vectors),
    "from_binary_file": (
        lambda p, v, **kw: VectorStore.from_binary_file(p / "vectors.bin",
                                                        **kw),
        lambda s: s.vectors),
    "VectorStore.load": (
        lambda p, v, **kw: VectorStore.load(p / "store.npz", **kw),
        lambda s: s.vectors),
    "store_from_numpy": (
        lambda p, v, **kw: convert.store_from_numpy(WORDS, v, **kw),
        lambda s: s.vectors),
    "pq_from_numpy": (
        lambda p, v, **kw: convert.pq_from_numpy(_arrays(p, "pq"), **kw),
        lambda i: i.codes),
    "ivfadc_from_numpy": (
        lambda p, v, **kw: convert.ivfadc_from_numpy(_arrays(p, "ivfadc"),
                                                     **kw),
        lambda i: i.codes_sorted),
    "ivpq_from_numpy": (
        lambda p, v, **kw: convert.ivpq_from_numpy(_arrays(p, "ivpq"), **kw),
        lambda i: i.codes),
    "PQIndex.load": (
        lambda p, v, **kw: PQIndex.load(p / "pq.npz", **kw),
        lambda i: i.codebook.centroids),
    "IVFADCIndex.load": (
        lambda p, v, **kw: IVFADCIndex.load(p / "ivfadc.npz", **kw),
        lambda i: i.cell_offsets),
    "IVPQIndex.load": (
        lambda p, v, **kw: IVPQIndex.load(p / "ivpq.npz", **kw),
        lambda i: i.cell_of),
    "Freddy.load": (
        lambda p, v, **kw: Freddy.load(p, **kw),
        lambda e: e.ivpq.codes),
    "migrate.import_engine": (
        lambda p, v, **kw: migrate.import_engine(p / "dump", **kw),
        lambda e: e.ivfadc.codes_sorted),
}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_a_card(saved, monkeypatch, name):
    call, _ = ENTRY_POINTS[name]
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        call(*saved)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_builds_on_the_cpu_when_asked(saved, monkeypatch, name):
    call, tensor_of = ENTRY_POINTS[name]
    _no_card(monkeypatch)
    assert tensor_of(call(*saved, device="cpu")).device.type == "cpu"


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_asks_for_the_card_by_default(saved, monkeypatch, name):
    """With a card reported, the first device an entry point resolves
    without ``device`` is ``cuda``. The spy then hands out the CPU, so the
    build finishes here without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []

    def spy(device):
        asked.append(device_mod.resolve_device(device))
        return torch.device("cpu")

    for mod in (store_mod, convert, api, migrate):
        monkeypatch.setattr(mod, "resolve_device", spy)
    call, tensor_of = ENTRY_POINTS[name]
    assert tensor_of(call(*saved)).device.type == "cpu"
    assert asked and asked[0] == torch.device("cuda")


@pytest.mark.parametrize("card", [False, True])
def test_a_cpu_tensor_stays_on_the_cpu(saved, monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    s = VectorStore.from_arrays(WORDS, torch.from_numpy(saved[1]))
    assert s.vectors.device.type == "cpu"
    assert s.vectors_norm.device.type == "cpu"


def test_freddy_load_on_the_cpu_answers(saved):
    """An engine loaded with ``device="cpu"`` answers a query."""
    eng = Freddy.load(saved[0], device="cpu")
    res = eng.knn("w3", 4)
    assert len(res) == 4 and res[0][0] == "w3"
    assert eng.statistics == {} or all(
        t.device.type == "cpu" for t in eng.statistics.values())
