"""IVFADC index build driver.

The port's ``index_creation/ivfadc.py``: coarse k-means, residual
codebook and CSR lists on the device, written in the JAX package's
``.npz`` layout.

    python -m postgres_word2vec_tpu_torch.cli.index_creation.ivfadc \\
        index_creation/config/ivfadc_config.json [--device cpu]

Config keys: ``m``, ``k``, ``k_coarse``, ``train_size_coarse`` (the shared
training-sample size), ``store_path``, ``export_filename``, optional
``seed``, ``iters``.
"""

from __future__ import annotations

import time

import torch

from postgres_word2vec_tpu_torch.cli._common import config_cli
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.config import (INFO, Configuration,
                                                      Logger)
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> IVFADCIndex:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    log = Logger()
    store = VectorStore.load(cfg.get_value("store_path"), device=device)
    t0 = time.perf_counter()
    index = IVFADCIndex.build(
        torch.Generator(device).manual_seed(cfg.get_value_or("seed", 0)),
        store.vectors_norm,
        m=cfg.get_value_or("m", 12), k=cfg.get_value_or("k", 256),
        k_coarse=cfg.get_value_or("k_coarse", 1000),
        train_size=cfg.get_value_or("train_size_coarse", 100_000),
        iters=cfg.get_value_or("iters", 10))
    log.log(INFO, f"IVFADC index built ({index.size} codes, "
                  f"{index.num_cells} cells, list_cap={index.list_cap}) "
                  f"in {time.perf_counter() - t0:.1f}s")
    out = cfg.get_value("export_filename")
    index.save(out)
    log.log(INFO, f"index written to {out}")
    return index


if __name__ == "__main__":
    config_cli(main, __doc__)
