"""IVPQ (multi-index) build driver.

The port's ``index_creation/ivpq.py``.

    python -m postgres_word2vec_tpu_torch.cli.index_creation.ivpq \\
        index_creation/config/ivpq_config.json [--device cpu]

Config keys: ``m``, ``k``, ``k_coarse`` (per position; 2 positions →
k_coarse² cells), ``train_size_coarse``, ``store_path``,
``export_filename``, optional ``seed``, ``iters`` and
``statistic_words_path``: a newline-separated word list whose per-cell
frequency statistics (``build_statistics``; unknown words dropped) are
written to ``<export_filename>.stats.npy``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import config_cli
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex, build_statistics
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.config import (INFO, Configuration,
                                                      Logger)
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> IVPQIndex:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"), device=device)
    t0 = time.perf_counter()
    index = IVPQIndex.build(
        torch.Generator(device).manual_seed(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 30), k=cfg.get_value_or("k", 32),
        k_coarse=cfg.get_value_or("k_coarse", 32),
        train_size=cfg.get_value_or("train_size_coarse", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"IVPQ index built ({index.size} codes, "
                  f"{index.num_cells} cells) in "
                  f"{time.perf_counter() - t0:.1f}s")
    out = cfg.get_value("export_filename")
    index.save(out)
    log.log(INFO, f"index written to {out}")

    stats_words = cfg.get_value_or("statistic_words_path", "")
    if stats_words:
        words = [w for w in Path(stats_words).read_text().split("\n") if w]
        ids = torch.as_tensor(store.get_ids(words, strict=False),
                              dtype=torch.int32, device=device)
        stats = build_statistics(index.cell_of, ids, index.num_cells)
        stats_out = str(out) + ".stats.npy"
        np.save(stats_out, stats.cpu().numpy())
        log.log(INFO, f"statistics ({len(words)} domain words) written to "
                      f"{stats_out}")
    return index


if __name__ == "__main__":
    config_cli(main, __doc__)
