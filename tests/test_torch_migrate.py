"""The port's FREDDY dump migration (``utils/migrate.py``) and its copy of
the blob codec (``utils/codec.py``) against the JAX package (CPU), as
tests/test_migrate.py holds the JAX one: the COPY codec, and round trips
both ways — a dump the JAX package exports imports in the port, and a dump
the port exports imports in the JAX package — with every quantizer and
statistics table verbatim and the same search results.

Tolerances: tables and codes equal; kNN similarities within 1e-5 (the
port's and the JAX package's float32 scans sum in another order).
"""

import numpy as np
import pytest
import torch

from postgres_word2vec_tpu.utils import codec as jcodec
from postgres_word2vec_tpu.utils import migrate as jmigrate

from postgres_word2vec_tpu_torch import Freddy
from postgres_word2vec_tpu_torch.utils import codec, migrate

from test_torch_parity_util import FULL_ENGINE, np_, save_jax_engine


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine (PQ without OPQ, IVFADC, IVPQ, two statistics tables)
    and the port engine loaded from its saved directory."""
    jeng, path = save_jax_engine(
        tmp_path_factory.mktemp("engine"),
        statistics=("stat_google_vecs_norm_word",
                    [f"w{i}" for i in range(0, 3000, 2)]), **FULL_ENGINE)
    jeng.create_statistics("my domain", [f"w{i}" for i in range(500)])
    jeng.save(path)
    return jeng, Freddy.load(path, device="cpu")


@pytest.fixture(scope="module")
def jax_to_port(engines, tmp_path_factory):
    jeng, _ = engines
    dump = tmp_path_factory.mktemp("jax_dump")
    jmigrate.export_engine(jeng, dump)
    return jeng, migrate.import_engine(dump, device="cpu"), dump


@pytest.fixture(scope="module")
def port_to_jax(engines, tmp_path_factory):
    _, port = engines
    dump = tmp_path_factory.mktemp("port_dump")
    migrate.export_engine(port, dump)
    return port, jmigrate.import_engine(dump), dump


# ------------------------------------------------------------ the codecs

@pytest.mark.parametrize("line", ["1\thello\\tworld\t\\N\t\\\\x0102",
                                  "\\101BC", "\\8\t\\9x", "\\118",
                                  "a\\\\b\t\\n\t"])
def test_parse_copy_line_matches_jax(line):
    assert migrate.parse_copy_line(line) == jmigrate.parse_copy_line(line)


@pytest.mark.parametrize("seed", range(4))
def test_parse_copy_line_matches_jax_on_random_lines(seed):
    """The port tokenizes by regex where the JAX parser loops over
    characters: random lines of escapes, tabs, digits and N agree."""
    rng = np.random.default_rng(seed)
    alphabet = ["\\", "\\", "\t", "\t", "N", "n", "x", "0", "1", "3", "7",
                "8", "9", "a", "t", "r", "\n", " "]
    for _ in range(2000):
        line = "".join(rng.choice(alphabet, rng.integers(0, 16)))
        assert migrate.parse_copy_line(line) == jmigrate.parse_copy_line(
            line), repr(line)


@pytest.mark.parametrize("value", ["plain", "tab\there", "back\\slash",
                                   None, b"\x00\x01\xff", 7, 2.5])
def test_format_copy_field_matches_jax(value):
    assert migrate.format_copy_field(value) == jmigrate.format_copy_field(
        value)


@pytest.mark.parametrize("kind", ["float4", "int4", "int2"])
def test_codec_matches_jax(rng, kind):
    a = (rng.normal(size=(4, 6)) * 100).astype(np.float32)
    blobs = codec.encode_vector_column(a, kind)
    assert blobs == jcodec.encode_vector_column(a, kind)
    np.testing.assert_array_equal(codec.decode_vector_column(blobs, kind),
                                  jcodec.decode_vector_column(blobs, kind))


# -------------------------------------------------- JAX dump → the port

def test_jax_dump_imports_verbatim(jax_to_port):
    jeng, port, _ = jax_to_port
    assert port.store.words == jeng.store.words
    assert port.store.device.type == "cpu"
    np.testing.assert_array_equal(np_(port.store.vectors),
                                  np.asarray(jeng.store.vectors))
    np.testing.assert_array_equal(np_(port.store.vectors_norm),
                                  np.asarray(jeng.store.vectors_norm))
    np.testing.assert_array_equal(np_(port.pq.codes), np.asarray(jeng.pq.codes))
    np.testing.assert_array_equal(np_(port.pq.codebook.centroids),
                                  np.asarray(jeng.pq.codebook.centroids))
    for name in ("cell_offsets", "codes_sorted", "row_ids", "assignments"):
        np.testing.assert_array_equal(np_(getattr(port.ivfadc, name)),
                                      np.asarray(getattr(jeng.ivfadc, name)))
    np.testing.assert_array_equal(np_(port.ivpq.codes),
                                  np.asarray(jeng.ivpq.codes))
    np.testing.assert_array_equal(np_(port.ivpq.cell_of),
                                  np.asarray(jeng.ivpq.cell_of))
    np.testing.assert_array_equal(np_(port.ivpq.coarse.cell_counts),
                                  np.asarray(jeng.ivpq.coarse.cell_counts))
    assert set(port.statistics) == set(jeng.statistics)
    for name, stats in jeng.statistics.items():
        np.testing.assert_allclose(np_(port.statistics[name]),
                                   np.asarray(stats), rtol=1e-6)


@pytest.mark.parametrize("family", ["k_nearest_neighbour",
                                    "k_nearest_neighbour_pq",
                                    "k_nearest_neighbour_ivfadc"])
def test_jax_dump_searches_like_jax(jax_to_port, family):
    jeng, port, _ = jax_to_port
    port.set_knn_function(family)
    jeng.set_knn_function(family)
    try:
        for word in ("w0", "w1234"):
            got, want = port.knn(word, 5), jeng.knn(word, 5)
            assert [w for w, _ in got][:1] == [w for w, _ in want][:1]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], atol=1e-5)
    finally:
        jeng.set_knn_function("k_nearest_neighbour")


def test_import_goes_to_the_card_by_default(jax_to_port, monkeypatch):
    *_, dump = jax_to_port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        migrate.import_engine(dump)


# -------------------------------------------------- port dump → JAX

def test_port_dump_imports_in_jax(port_to_jax):
    port, jeng, _ = port_to_jax
    assert jeng.store.words == port.store.words
    np.testing.assert_array_equal(np.asarray(jeng.store.vectors_norm),
                                  np_(port.store.vectors_norm))
    np.testing.assert_array_equal(np.asarray(jeng.pq.codes), np_(port.pq.codes))
    np.testing.assert_array_equal(np.asarray(jeng.ivpq.codes),
                                  np_(port.ivpq.codes))
    np.testing.assert_array_equal(np.asarray(jeng.ivfadc.codes_sorted),
                                  np_(port.ivfadc.codes_sorted))
    assert set(jeng.statistics) == set(port.statistics)
    got, want = port.knn_in_pq("w7", 5, list(range(0, 3000, 4))), \
        jeng.knn_in_pq("w7", 5, list(range(0, 3000, 4)))
    assert [w for w, _ in got] == [w for w, _ in want]


def test_port_dump_reimports_in_the_port(port_to_jax):
    port, _, dump = port_to_jax
    back = migrate.import_engine(dump, device="cpu")
    assert back.store.words == port.store.words
    assert torch.equal(back.pq.codes, port.pq.codes)
    assert torch.equal(back.ivfadc.codes_sorted, port.ivfadc.codes_sorted)
    assert torch.equal(back.ivpq.cell_of, port.ivpq.cell_of)
    assert back.knn_in_pq("w7", 5, list(range(0, 3000, 4))) == \
        port.knn_in_pq("w7", 5, list(range(0, 3000, 4)))


def test_port_dump_after_insert_flushes_the_ivfadc_tail(engines, tmp_path):
    _, port = engines
    eng = Freddy(port.store.extend(["fresh"], port.store.vectors[:1] * 2),
                 pq=port.pq.add(port.store.vectors_norm[:1]),
                 ivfadc=port.ivfadc.add(port.store.vectors_norm[:1]),
                 ivpq=port.ivpq.add(port.store.vectors_norm[:1]))
    assert eng.ivfadc.tail_count == 1
    migrate.export_engine(eng, tmp_path)
    back = jmigrate.import_engine(tmp_path)
    assert back.store.size == port.store.size + 1
    assert np.asarray(back.ivfadc.codes_sorted).shape[0] == back.store.size


def test_export_opq_raises(tmp_path):
    from postgres_word2vec_tpu_torch import PQIndex, VectorStore

    x = torch.nn.functional.normalize(torch.randn(64, 8,
                                      generator=torch.Generator().manual_seed(0)),
                                      dim=1)
    store = VectorStore.from_arrays([f"a{i}" for i in range(64)], x)
    pq = PQIndex.build(torch.Generator().manual_seed(0), x, m=2, k=4,
                       train_size=None, iters=2, opq_iters=1)
    with pytest.raises(ValueError, match="OPQ"):
        migrate.export_engine(Freddy(store, pq=pq), tmp_path)
