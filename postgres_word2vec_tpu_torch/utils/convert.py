"""Carry state saved by the JAX package across into the port.

The JAX package saves a store as ``words`` + ``vectors``
(``postgres_word2vec_tpu/store.py``, ``VectorStore.save``), a PQ index as
``centroids``, ``counts``, ``codes`` and an optional ``rotation``
(``models/pq.py``, ``PQIndex.save``), an IVFADC index as its coarse
quantizer, residual codebook and CSR lists (``models/ivfadc.py``,
``IVFADCIndex.save``) and an IVPQ index as its multi-index quantizer,
codebook, codes and cells (``models/ivpq.py``, ``IVPQIndex.save``). These
helpers take those fields as numpy arrays and build the port's objects on
a device, keeping the code dtype (uint8 for k ≤ 256, int16 otherwise).
``Freddy.load`` goes through them, so an engine directory written by the
JAX ``Freddy.save`` loads here, and tests can hold both packages to the
same trained index.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from postgres_word2vec_tpu_torch.models.ivfadc import (CoarseQuantizer,
                                                       IVFADCIndex)
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                     MultiIndexQuantizer)
from postgres_word2vec_tpu_torch.models.pq import PQCodebook, PQIndex
from postgres_word2vec_tpu_torch.store import VectorStore

_CODE_DTYPES = (np.uint8, np.int16)


def store_from_numpy(words: Sequence[str], vectors: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> VectorStore:
    """A store from the JAX store's fields (raw vectors; normalized here,
    as the JAX ``VectorStore.load`` does)."""
    return VectorStore.from_arrays(words, np.asarray(vectors, np.float32),
                                   device=device)


def _on(device):
    def dev(a, dtype=None):
        a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return dev


def _codebook(arrays: Mapping[str, np.ndarray], codes_key: str,
              dev) -> tuple[PQCodebook, torch.Tensor]:
    """The (centroids, counts) codebook and its code table, checked."""
    codes = np.asarray(arrays[codes_key])
    if codes.dtype not in _CODE_DTYPES:
        raise ValueError(f"{codes_key} must be uint8 or int16, got "
                         f"{codes.dtype}")
    centroids = np.asarray(arrays["centroids"], np.float32)
    if codes.ndim != 2 or codes.shape[1] != centroids.shape[0]:
        raise ValueError(f"{codes_key} {codes.shape} do not match m="
                         f"{centroids.shape[0]}")
    return (PQCodebook(dev(centroids), dev(arrays["counts"], np.int32)),
            dev(codes))


def pq_from_numpy(arrays: Mapping[str, np.ndarray],
                  device: torch.device | str | None = None) -> PQIndex:
    """A PQ index from the JAX ``pq.npz`` fields."""
    dev = _on(device)
    codebook, codes = _codebook(arrays, "codes", dev)
    rot = arrays.get("rotation")
    return PQIndex(codebook, codes, rotation=None if rot is None
                   else dev(rot, np.float32))


def ivfadc_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: torch.device | str | None = None
                      ) -> IVFADCIndex:
    """An IVFADC index from the JAX ``ivfadc.npz`` fields (the insert tail
    is flushed before the JAX package saves, so the lists are whole)."""
    dev = _on(device)
    codebook, codes = _codebook(arrays, "codes_sorted", dev)
    offsets = np.asarray(arrays["cell_offsets"])
    if offsets[-1] != codes.shape[0]:
        raise ValueError(f"cell_offsets end at {offsets[-1]}, not at the "
                         f"{codes.shape[0]} code rows")
    return IVFADCIndex(
        CoarseQuantizer(dev(arrays["coarse_centroids"], np.float32),
                        dev(arrays["coarse_counts"], np.int32)),
        codebook, dev(offsets, np.int32), codes,
        dev(arrays["row_ids"], np.int32),
        dev(arrays["assignments"], np.int32), int(arrays["list_cap"]))


def ivpq_from_numpy(arrays: Mapping[str, np.ndarray],
                    device: torch.device | str | None = None) -> IVPQIndex:
    """An IVPQ index from the JAX ``ivpq.npz`` fields."""
    dev = _on(device)
    codebook, codes = _codebook(arrays, "codes", dev)
    return IVPQIndex(
        MultiIndexQuantizer(dev(arrays["coarse_centroids"], np.float32),
                            dev(arrays["cell_counts"], np.int32)),
        codebook, codes, dev(arrays["cell_of"], np.int64))
