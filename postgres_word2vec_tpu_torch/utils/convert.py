"""Carry state saved by the JAX package across into the port.

The JAX package saves a store as ``words`` + ``vectors``
(``postgres_word2vec_tpu/store.py``, ``VectorStore.save``), a PQ index as
``centroids``, ``counts``, ``codes`` and an optional ``rotation``
(``models/pq.py``, ``PQIndex.save``), an IVFADC index as its coarse
quantizer, residual codebook and CSR lists (``models/ivfadc.py``,
``IVFADCIndex.save``) and an IVPQ index as its multi-index quantizer,
codebook, codes and cells (``models/ivpq.py``, ``IVPQIndex.save``), and
an engine's settings as ``engine.json`` (``api.py``, ``Freddy.save``).
These helpers take those fields and build the port's objects on a device
(the card unless the caller names another, ``utils.device.resolve_device``),
keeping the code dtype (uint8 for k ≤ 256, int16 otherwise).
``Freddy.load`` goes through them, so an engine directory written by the
JAX ``Freddy.save`` — after inserts too — loads here, and tests can hold
both packages to the same trained index.
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
from postgres_word2vec_tpu_torch.utils.device import resolve_device

_CODE_DTYPES = (np.uint8, np.int16)


def store_from_numpy(words: Sequence[str], vectors: np.ndarray,
                     device: torch.device | str | None = None
                     ) -> VectorStore:
    """A store from the JAX store's fields (raw vectors; normalized here,
    as the JAX ``VectorStore.load`` does)."""
    return VectorStore.from_arrays(words, np.asarray(vectors, np.float32),
                                   device=device)


def _on(device):
    device = resolve_device(device)

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
    """An IVFADC index from the JAX ``ivfadc.npz`` fields. After an insert
    the JAX package flushes the insert tail into the CSR lists before it
    saves (as the port does), so the lists are whole, ``cell_offsets``
    ends at the row count and the rows of every cell are one run."""
    dev = _on(device)
    codebook, codes = _codebook(arrays, "codes_sorted", dev)
    offsets = np.asarray(arrays["cell_offsets"])
    if offsets[-1] != codes.shape[0]:
        raise ValueError(f"cell_offsets end at {offsets[-1]}, not at the "
                         f"{codes.shape[0]} code rows")
    n_rows = np.asarray(arrays["row_ids"]).shape[0]
    if n_rows != codes.shape[0] or np.asarray(
            arrays["assignments"]).shape[0] != n_rows:
        raise ValueError("row_ids and assignments must have one entry per "
                         "code row")
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


def engine_meta(meta: Mapping) -> dict:
    """The JAX ``engine.json`` settings: ``params`` (the runtime
    parameters, ``pq_lut_dtype`` among them), ``dispatch``, ``exact_dtype``
    and ``exact_approx`` (defaults for files that predate the last two).
    ``Freddy`` checks each value as it applies it."""
    return {"params": dict(meta["params"]), "dispatch": dict(meta["dispatch"]),
            "exact_dtype": meta.get("exact_dtype", "float32"),
            "exact_approx": bool(meta.get("exact_approx", False))}
