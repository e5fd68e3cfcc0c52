"""Offline loader: embedding file → vector store artifact.

The port's ``index_creation/vec2database.py``: parses a word2vec text or
``.bin`` file with the native parser, L2-normalizes on the device and
writes the store ``.npz`` (vocabulary and raw vectors; the normalized
table is derived at load), the JAX package's format.

    python -m postgres_word2vec_tpu_torch.cli.index_creation.vec2database \\
        index_creation/config/vecs_config.json [--device cpu]

Config keys: ``vec_file_path`` (text or .bin), ``store_path`` (output
.npz), optional ``max_words``, ``normalized`` (ignored: both tables are
always available).
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.cli._common import config_cli
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.config import (INFO, Configuration,
                                                      Logger)
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> VectorStore:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    log = Logger()
    src = Path(cfg.get_value("vec_file_path"))
    out = Path(cfg.get_value("store_path"))
    max_words = cfg.get_value_or("max_words", None)
    t0 = time.perf_counter()
    if src.suffix == ".bin":
        store = VectorStore.from_binary_file(src, max_words, device=device)
    else:
        store = VectorStore.from_text_file(src, max_words, device=device)
    log.log(INFO, f"parsed {store.size} x {store.dim} vectors in "
                  f"{time.perf_counter() - t0:.1f}s")
    store.save(out)
    log.log(INFO, f"store written to {out}")
    return store


if __name__ == "__main__":
    config_cli(main, __doc__)
