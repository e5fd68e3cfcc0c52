"""PQ index build driver.

The port's ``index_creation/pq_index.py``: codebook training and encoding
on the device (batched Lloyd's), the index written in the JAX package's
``.npz`` layout.

    python -m postgres_word2vec_tpu_torch.cli.index_creation.pq_index \\
        index_creation/config/pq_config.json [--device cpu]

Config keys: ``m``, ``k``, ``train_size``, ``store_path`` (input store
.npz), ``export_filename`` (output index .npz), optional ``seed`` (of the
``torch.Generator`` the training draws from), ``iters``.
"""

from __future__ import annotations

import time

import torch

from postgres_word2vec_tpu_torch.cli._common import config_cli
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.config import (INFO, Configuration,
                                                      Logger)
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> PQIndex:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"), device=device)
    t0 = time.perf_counter()
    index = PQIndex.build(
        torch.Generator(device).manual_seed(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 12), k=cfg.get_value_or("k", 256),
        train_size=cfg.get_value_or("train_size", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"PQ index built ({index.size} codes, m={index.m}, "
                  f"k={index.k}) in {time.perf_counter() - t0:.1f}s")
    out = cfg.get_value("export_filename")
    index.save(out)
    log.log(INFO, f"index written to {out}")
    return index


if __name__ == "__main__":
    config_cli(main, __doc__)
