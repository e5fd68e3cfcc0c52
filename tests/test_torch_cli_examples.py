"""The port's examples (``postgres_word2vec_tpu_torch.cli.examples``)
against the repository's JAX examples (``examples/*.py``), on the CPU:
the quickstart and the serving walkthrough print the JAX examples' exact
kNN answers (similarities to 1e-6), and the mesh walkthrough runs on the
JAX tests' 4 × 2 mesh of CPU entries."""

import contextlib
import json
import sys

import numpy as np

from postgres_word2vec_tpu_torch.cli.examples import (multichip, quickstart,
                                                      serving)
from test_torch_parity_util import REPO, jax_script

TOL = 1e-6


@contextlib.contextmanager
def argv(args):
    saved = sys.argv
    sys.argv = args
    try:
        yield
    finally:
        sys.argv = saved


def exact_answers(text: str) -> list[list[str]]:
    """The exact-kNN block of the quickstart's output, one row a line."""
    block = text.split("knn('word0', 5):")[1].split("\n\n")[0]
    return [line.split() for line in block.strip().splitlines()]


def test_quickstart_prints_the_jax_exact_answers(capsys):
    capsys.readouterr()
    with argv([str(REPO / "examples" / "quickstart.py")]):
        jax_script("examples/quickstart.py").main()
    want = capsys.readouterr().out
    eng = quickstart.main(device="cpu")
    got = capsys.readouterr().out
    assert exact_answers(got) == exact_answers(want)
    assert len(exact_answers(got)) == 5
    assert got.splitlines()[0] == want.splitlines()[0]
    assert "inserted compound term; vocab now 2001" in got
    assert eng.store.size == 2001 and eng.store.device.type == "cpu"


def served_knn(text: str) -> list:
    line = next(ln for ln in text.splitlines() if ln.startswith("knn: "))
    return json.loads(line[len("knn: "):].replace("'", '"'))


def test_serving_prints_the_jax_exact_answers(capsys):
    capsys.readouterr()
    jax_script("examples/serving.py").main()
    want = capsys.readouterr().out
    health = serving.main(device="cpu")
    got = capsys.readouterr().out
    g, w = served_knn(got), served_knn(want)
    assert [r[0] for r in g] == [r[0] for r in w] and len(g) == 3
    np.testing.assert_allclose([r[1] for r in g], [r[1] for r in w],
                               atol=TOL, rtol=0)
    assert "serving example OK" in got
    assert health["vocab"] == 2001 and health["knn_max_coalesced"] >= 1


def test_multichip_runs_on_a_4x2_cpu_mesh(capsys):
    out = multichip.main(4, 2, device="cpu")
    text = capsys.readouterr().out
    assert "mesh: {'rows': 4, 'q': 2}" in text
    assert "not multi-GPU scaling" in text
    assert out["exact"] == 1.0 and out["pq"] >= 0.75
    assert out["ivfadc"] >= 0.75 and out["ivpq"] >= 0.5
