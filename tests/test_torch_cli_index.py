"""The port's offline index construction drivers
(``postgres_word2vec_tpu_torch.cli.index_creation``) against the
repository's JAX drivers (``index_creation/*.py``), on the CPU, and the
rule every driver keeps: without ``--device`` it runs on the card, so
here, with no card, it raises.

Each driver runs through both packages on the same config: stores are
bit-equal, text conversions byte-identical, index artifacts have the JAX
layout and load in both packages, ``load_index`` prints the same line,
and FREDDY dumps import to equal arrays and export byte-identically.
Sizes are tiny (n = 1,200, d = 24); the JAX artifacts are built once for
the module."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from postgres_word2vec_tpu import Freddy as JFreddy
from postgres_word2vec_tpu.models import ivpq as jivpq
from postgres_word2vec_tpu.models.ivfadc import IVFADCIndex as JIVFADC
from postgres_word2vec_tpu.models.ivpq import IVPQIndex as JIVPQ
from postgres_word2vec_tpu.models.pq import PQIndex as JPQ
from postgres_word2vec_tpu.store import VectorStore as JStore
from postgres_word2vec_tpu_torch.cli.index_creation import (
    import_freddy, ivfadc, ivpq, load_index, pq_index, transform_vecs,
    vec2database)
from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils import migrate
from test_torch_parity_util import REPO, jax_script

N, D = 1200, 24
#: the port's drivers, the 17 of the repository's scripts it mirrors
DRIVERS = {
    "index_creation": ("vec2database", "transform_vecs", "pq_index",
                       "ivfadc", "ivpq", "load_index", "import_freddy"),
    "evaluation": ("time_measurement", "time_precision_eval",
                   "step_wise_time_measurement", "confidence_eval",
                   "target_counts", "flexible_pq_eval", "vec_distr"),
    "examples": ("quickstart", "serving", "multichip"),
}
#: each index family: the port's driver (named as its JAX script), its
#: build config (the shipped configs' keys at a tiny size) and both
#: packages' loaders
FAMILIES = {
    "pq": (pq_index, dict(m=6, k=16, train_size=800, iters=4, seed=0),
           PQIndex, JPQ),
    "ivfadc": (ivfadc, dict(m=6, k=16, k_coarse=12, train_size_coarse=800,
                            iters=4, seed=0), IVFADCIndex, JIVFADC),
    "ivpq": (ivpq, dict(m=6, k=16, k_coarse=5, train_size_coarse=800,
                        iters=4, seed=0), IVPQIndex, JIVPQ),
}


def write_config(path: Path, **keys) -> str:
    path.write_text(json.dumps(keys))
    return str(path)


def write_bin(path: Path, words, vecs) -> None:
    with open(path, "wb") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n".encode())
        for w, v in zip(words, vecs):
            f.write(w.encode() + b" " + v.astype(np.float32).tobytes()
                    + b"\n")


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Embedding files (text and .bin), the JAX driver's store of each and
    the JAX drivers' three indexes of the text store."""
    tmp = tmp_path_factory.mktemp("cli_index")
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    words = [f"tok{i}" for i in range(N)]
    (tmp / "vecs.txt").write_text(f"{N} {D}\n" + "".join(
        w + " " + " ".join(f"{x:.6f}" for x in row) + "\n"
        for w, row in zip(words, vecs)))
    write_bin(tmp / "vecs.bin", words, vecs)
    for kind in ("txt", "bin"):
        jax_script("index_creation/vec2database.py").main(write_config(
            tmp / f"jax_vecs_{kind}.json", vec_file_path=str(
                tmp / f"vecs.{kind}"),
            store_path=str(tmp / f"jax_store_{kind}.npz"), max_words=None))
    for fam, (driver, keys, _, _) in FAMILIES.items():
        script = driver.__name__.rsplit(".", 1)[1]
        jax_script(f"index_creation/{script}.py").main(write_config(
            tmp / f"jax_{fam}.json", store_path=str(tmp / "jax_store_txt.npz"),
            export_filename=str(tmp / f"jax_{fam}.npz"), **keys))
    (tmp / "domain.txt").write_text("\n".join(
        [f"tok{i}" for i in range(0, N, 3)] + ["not_a_word", ""]))
    return tmp


# ---------------------------------------------------------- vec2database
@pytest.mark.parametrize("kind", ["txt", "bin"])
def test_vec2database_matches_jax(art, kind):
    """Text and .bin: equal words, bit-equal vectors, and each package
    loads the other's store."""
    out = art / f"port_store_{kind}.npz"
    store = vec2database.main(write_config(
        art / f"port_vecs_{kind}.json", vec_file_path=str(
            art / f"vecs.{kind}"), store_path=str(out), max_words=None),
        device="cpu")
    assert store.device.type == "cpu" and store.size == N
    with np.load(out) as got, np.load(art / f"jax_store_{kind}.npz") as want:
        assert got.files == want.files
        np.testing.assert_array_equal(got["words"], want["words"])
        assert got["vectors"].dtype == want["vectors"].dtype == np.float32
        np.testing.assert_array_equal(got["vectors"], want["vectors"])
    jloaded = JStore.load(out)
    ploaded = VectorStore.load(art / f"jax_store_{kind}.npz", device="cpu")
    assert jloaded.words == ploaded.words == store.words
    np.testing.assert_array_equal(np.asarray(jloaded.vectors),
                                  ploaded.vectors.numpy())


def test_vec2database_max_words(art):
    out = art / "port_store_cut.npz"
    vec2database.main(write_config(
        art / "port_cut.json", vec_file_path=str(art / "vecs.bin"),
        store_path=str(out), max_words=100), device="cpu")
    with np.load(out) as f:
        assert f["vectors"].shape == (100, D)
        assert list(f["words"][:2]) == ["tok0", "tok1"]


# -------------------------------------------------------- transform_vecs
@pytest.mark.parametrize("max_words", [None, 57])
def test_transform_vecs_is_byte_identical(art, capsys, max_words):
    jax_script("index_creation/transform_vecs.py").main(
        str(art / "vecs.bin"), str(art / "jax.txt"), max_words)
    want = capsys.readouterr().out
    rows = transform_vecs.main(str(art / "vecs.bin"), str(art / "port.txt"),
                               max_words, device="cpu")
    assert capsys.readouterr().out == want.replace("jax.txt", "port.txt")
    assert rows == (max_words or N)
    assert (art / "port.txt").read_bytes() == (art / "jax.txt").read_bytes()


# -------------------------------------------------------- index builders
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_index_artifact_has_the_jax_layout(art, capsys, fam):
    """The port's artifact has JAX's fields, shapes and dtypes; the JAX
    package loads it and the port loads JAX's; the log lines agree."""
    driver, keys, loader, jloader = FAMILIES[fam]
    out = art / f"port_{fam}.npz"
    capsys.readouterr()
    index = driver.main(write_config(
        art / f"port_{fam}.json", store_path=str(art / "jax_store_txt.npz"),
        export_filename=str(out), **keys), device="cpu")
    log = capsys.readouterr().out.splitlines()
    assert len(log) == 2 and log[1].endswith(f"index written to {out}")
    assert f"index built ({N} codes" in log[0]
    with np.load(out) as got, np.load(art / f"jax_{fam}.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert got[name].shape == want[name].shape, name
            assert got[name].dtype == want[name].dtype, name
    # each package loads the other's artifact, and saves it back unchanged
    j = jloader.load(out)
    assert j.size == index.size == N
    j.save(art / f"jax_resaved_{fam}.npz")
    p = loader.load(art / f"jax_{fam}.npz", device="cpu")
    p.save(art / f"port_resaved_{fam}.npz")
    for a, b in ((f"jax_resaved_{fam}", f"port_{fam}"),
                 (f"port_resaved_{fam}", f"jax_{fam}")):
        with np.load(art / f"{a}.npz") as x, np.load(art / f"{b}.npz") as y:
            for name in y.files:
                np.testing.assert_array_equal(x[name], y[name], name)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_load_index_prints_the_jax_line(art, capsys, fam):
    """On one JAX-built artifact both drivers print the same line."""
    store, index = str(art / "jax_store_txt.npz"), str(art / f"jax_{fam}.npz")
    capsys.readouterr()
    jax_script("index_creation/load_index.py").main(store, index, fam)
    want = capsys.readouterr().out
    hit = load_index.main(store, index, fam, device="cpu")
    assert capsys.readouterr().out == want
    assert want.startswith(f"loaded {fam} index: {N} rows")
    assert 0.0 <= hit <= 1.0


def test_load_index_refuses_another_stores_index(art):
    small = art / "small_store.npz"
    JStore.from_arrays(["a", "b"], np.eye(2, D, dtype=np.float32)).save(small)
    with pytest.raises(SystemExit, match="index rows"):
        load_index.main(str(small), str(art / "jax_pq.npz"), "pq",
                        device="cpu")


def test_ivpq_statistics_equal_jax_build_statistics(art):
    """``<export>.stats.npy`` of the port's driver equals the JAX
    package's ``build_statistics`` on the same index and domain (unknown
    words dropped), and the JAX driver's file equals the port's function
    on JAX's index."""
    keys = dict(FAMILIES["ivpq"][1], statistic_words_path=str(
        art / "domain.txt"))
    words = [w for w in (art / "domain.txt").read_text().split("\n") if w]
    jstore = JStore.load(art / "jax_store_txt.npz")
    ids = jstore.get_ids(words, strict=False)
    assert len(ids) == len(words) - 1
    out = art / "port_ivpq_stats.npz"
    ivpq.main(write_config(art / "port_stats.json", store_path=str(
        art / "jax_store_txt.npz"), export_filename=str(out), **keys),
        device="cpu")
    jidx = JIVPQ.load(out)
    want = jivpq.build_statistics(jidx.cell_of, jnp.asarray(ids, jnp.int32),
                                  jidx.num_cells)
    got = np.load(str(out) + ".stats.npy")
    assert got.dtype == np.float32 and got.shape == (jidx.num_cells + 1,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
    assert got[-1] == len(ids)

    jout = art / "jax_ivpq_stats.npz"
    jax_script("index_creation/ivpq.py").main(write_config(
        art / "jax_stats.json", store_path=str(art / "jax_store_txt.npz"),
        export_filename=str(jout), **keys))
    pidx = IVPQIndex.load(jout, device="cpu")
    np.testing.assert_allclose(
        np.load(str(jout) + ".stats.npy"),
        ivpq_mod.build_statistics(pidx.cell_of, torch.as_tensor(ids),
                                  pidx.num_cells).numpy(), rtol=1e-6, atol=0)


# --------------------------------------------------------- import_freddy
@pytest.fixture(scope="module")
def dump(art):
    """A FREDDY dump of a JAX engine with all three families (no OPQ: a
    dump holds no rotation) and a statistics table, by the JAX driver."""
    store = JStore.load(art / "jax_store_txt.npz")
    eng = JFreddy.build(store, seed=0, pq_m=6, pq_k=16, opq_iters=0,
                        ivfadc_m=6, ivfadc_k=16, k_coarse=12, ivpq_m=6,
                        ivpq_k=16, ivpq_k_coarse=5, train_size=None, iters=3)
    eng.create_statistics("dom", store.words[:300])
    eng.save(art / "jax_engine")
    jax_script("index_creation/import_freddy.py").main(
        ["export", str(art / "jax_engine"), str(art / "dump")])
    return art / "dump"


def _arrays(directory: Path) -> dict:
    out = {}
    for f in sorted(directory.glob("*.npz")):
        with np.load(f) as z:
            out.update({f"{f.stem}.{n}": z[n] for n in z.files})
    return out


def test_import_freddy_matches_jax(art, dump, capsys):
    """Importing one dump gives equal arrays and engine settings, and the
    log line names the same families and tables."""
    jax_script("index_creation/import_freddy.py").main(
        ["import", str(dump), str(art / "jax_imported")])
    want = capsys.readouterr().out.splitlines()
    eng = import_freddy.main(["import", str(dump), str(art / "port_imported")],
                             device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert eng.store.device.type == "cpu" and eng.store.size == N
    assert [ln.split(" in ")[0].split("INFO: ")[1] for ln in got[:1]] == [
        ln.split(" in ")[0].split("INFO: ")[1] for ln in want[:1]]
    a, b = _arrays(art / "port_imported"), _arrays(art / "jax_imported")
    assert a.keys() == b.keys() and "statistics.dom" in a
    for name in b:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert json.loads((art / "port_imported" / "engine.json").read_text()) \
        == json.loads((art / "jax_imported" / "engine.json").read_text())


def test_import_freddy_export_is_byte_identical(art, dump):
    """Exporting an imported engine gives the JAX driver's files, byte for
    byte, and those equal the dump imported; all but the normalized
    vector table, which each package derives from the raw vectors when it
    loads the engine: float32 sums in another order, so rows agree within
    one unit in the last place."""
    import_freddy.main(["import", str(dump), str(art / "round")],
                       device="cpu")
    import_freddy.main(["export", str(art / "round"), str(art / "port_dump")],
                       device="cpu")
    jax_script("index_creation/import_freddy.py").main(
        ["export", str(art / "round"), str(art / "jax_dump")])
    names = sorted(p.name for p in (art / "jax_dump").iterdir())
    assert names == sorted(p.name for p in (art / "port_dump").iterdir())
    assert len(names) == 12 and "google_vecs_norm.copy" in names
    for name in names:
        if name == "google_vecs_norm.copy":
            continue
        assert (art / "port_dump" / name).read_bytes() == (
            art / "jax_dump" / name).read_bytes(), name
        assert (art / "port_dump" / name).read_bytes() == (
            dump / name).read_bytes(), name
    norms = [migrate.import_engine(art / d, device="cpu").store.vectors_norm
             for d in ("port_dump", "jax_dump")]
    torch.testing.assert_close(norms[0], norms[1], rtol=0, atol=1.2e-7)


def test_import_freddy_table_names(art, dump, tmp_path):
    """``role=table`` pairs rename a table on export and find it on
    import."""
    renamed = tmp_path / "renamed"
    import_freddy.main(["export", str(art / "jax_engine"), str(renamed),
                        "pq_quantization=my_pq_cb"], device="cpu")
    assert (renamed / "my_pq_cb.copy").exists()
    eng = import_freddy.main(["import", str(renamed), str(tmp_path / "e"),
                              "pq_quantization=my_pq_cb"], device="cpu")
    assert eng.pq is not None


# ------------------------------------------------ on the card by default
def _sample_args(group: str, name: str, art: Path) -> tuple:
    cfg = str(art / "jax_pq.json")
    return {"transform_vecs": (str(art / "vecs.bin"), str(art / "x.txt")),
            "load_index": (str(art / "jax_store_txt.npz"),
                           str(art / "jax_pq.npz"), "pq"),
            "import_freddy": (["import", str(art), str(art / "x")],),
            "quickstart": (), "serving": (), "multichip": ()}.get(
                name, (cfg,))


@pytest.mark.parametrize("group,name", [(g, n) for g, names in DRIVERS.items()
                                        for n in names])
def test_driver_without_device_raises_without_a_card(art, group, name):
    """``main`` with no ``device`` runs on the card: here, with none, it
    raises before it reads or writes anything, and falls back to
    nothing."""
    assert not torch.cuda.is_available()
    mod = importlib.import_module(
        f"postgres_word2vec_tpu_torch.cli.{group}.{name}")
    before = sorted(p.name for p in art.iterdir())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(*_sample_args(group, name, art))
    assert sorted(p.name for p in art.iterdir()) == before


@pytest.mark.parametrize("module,args", [
    ("index_creation.pq_index", ["index_creation/config/pq_config.json"]),
    ("evaluation.vec_distr", ["evaluation/config/time_measurement.json"])])
def test_the_entry_point_without_device_fails_without_a_card(module, args):
    """``python -m`` with no ``--device`` exits non-zero, says why, and
    prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", f"postgres_word2vec_tpu_torch.cli.{module}",
         *args], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_the_entry_point_runs_with_device_cpu(art):
    """``python -m … --device cpu`` is the CPU run."""
    cfg = write_config(art / "cli_pq.json",
                       store_path=str(art / "jax_store_txt.npz"),
                       export_filename=str(art / "cli_pq.npz"),
                       **FAMILIES["pq"][1])
    out = subprocess.run(
        [sys.executable, "-m",
         "postgres_word2vec_tpu_torch.cli.index_creation.pq_index", cfg,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "index written to" in out.stdout
    assert PQIndex.load(art / "cli_pq.npz", device="cpu").size == N
