"""Shared set-up of the command-line drivers: their argument parser, an
engine built or loaded from a JSON experiment config, and the sampled
query and target words.

The port's copy of ``evaluation/_common.py``. Config keys: ``store_path``
(a store ``.npz``) or ``synthetic`` {n, d, seed, optional ``generator``}
to generate data in-process; optional ``pq_index`` / ``ivfadc_index`` /
``ivpq_index`` artifact paths (with all three given the engine is
assembled from them, else the missing families are trained with the
``build`` hyperparameters); plus each driver's own keys.

``"generator": "wordlike"`` draws the calibrated GoogleNews-like data
with ``synth.generate_wordlike`` from a ``torch.Generator`` on the
engine's device. Its draws differ from the JAX package's for the same
seed, so records made from it are compared with the JAX package's within
margins. The Gaussian branch and :func:`sample_words` draw with numpy's
``default_rng``, so both packages see the same vectors and words.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from postgres_word2vec_tpu_torch.api import Freddy
from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """A driver's parser: its docstring as help, and ``--device``."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card, cuda; "
                        "cpu for the CPU)")
    return p


def config_cli(main, doc: str) -> None:
    """The command line of a driver whose one argument is its config:
    ``main(config, device=...)``."""
    p = arg_parser(doc)
    p.add_argument("config")
    args = p.parse_args()
    main(args.config, device=args.device)


def engine_from_config(cfg: Configuration,
                       device: torch.device | str | None = None) -> Freddy:
    """The config's engine on ``device`` (the card unless another is
    named)."""
    device = resolve_device(device)
    if cfg.has_key("store_path"):
        store = VectorStore.load(cfg.get_value("store_path"), device=device)
    else:
        syn = cfg.get_value_or("synthetic",
                               {"n": 20000, "d": 300, "seed": 0})
        words = [f"word{i}" for i in range(syn["n"])]
        if syn.get("generator") == "wordlike":
            gen = torch.Generator(device).manual_seed(syn.get("seed", 0))
            vecs = synth.generate_wordlike(gen, syn["n"], syn.get("d", 300))
            store = VectorStore.from_arrays(words, vecs, normalized=True)
        else:
            rng = np.random.default_rng(syn.get("seed", 0))
            vecs = rng.normal(size=(syn["n"], syn["d"])).astype(np.float32)
            store = VectorStore.from_arrays(words, vecs, device=device)

    build = cfg.get_value_or("build", {})
    indexes = {}
    for name, loader in (("pq_index", PQIndex.load),
                         ("ivfadc_index", IVFADCIndex.load),
                         ("ivpq_index", IVPQIndex.load)):
        path = cfg.get_value_or(name, "")
        if path:
            indexes[name.split("_")[0]] = loader(path, device=device)

    if indexes.keys() >= {"pq", "ivfadc", "ivpq"}:
        return Freddy(store, pq=indexes["pq"], ivfadc=indexes["ivfadc"],
                      ivpq=indexes["ivpq"])
    eng = Freddy.build(
        store, seed=build.get("seed", 0),
        pq_m=build.get("pq_m", 12), pq_k=build.get("pq_k", 256),
        ivfadc_m=build.get("ivfadc_m", 12),
        ivfadc_k=build.get("ivfadc_k", 256),
        k_coarse=build.get("k_coarse", 1000),
        ivpq_m=build.get("ivpq_m", 30), ivpq_k=build.get("ivpq_k", 32),
        ivpq_k_coarse=build.get("ivpq_k_coarse", 32),
        ivpq_coarse_positions=build.get("ivpq_coarse_positions", 2),
        train_size=build.get("train_size", 100_000),
        iters=build.get("iters", 10),
        init=build.get("init", "sample"),
        restarts=build.get("restarts", 1),
        opq_iters=build.get("opq_iters", 0),
        with_pq=build.get("with_pq", True),
        with_ivfadc=build.get("with_ivfadc", True),
        with_ivpq=build.get("with_ivpq", True))
    for fam, idx in indexes.items():
        setattr(eng, fam, idx)
    return eng


def sample_words(engine: Freddy, count: int, seed: int = 0,
                 offset: int = 0) -> list[str]:
    """``count`` distinct words of the store drawn with numpy's
    ``default_rng(seed)`` from ids ``offset..N-1``."""
    rng = np.random.default_rng(seed)
    n = engine.store.size
    ids = rng.choice(n - offset, size=min(count, n - offset),
                     replace=False) + offset
    return [engine.store.words[int(i)] for i in ids]
