"""Streaming ("pipeline") index construction with checkpoint/resume.

Counterpart of ``postgres_word2vec_tpu/models/builders.py``. Parity
targets: the reference's incremental build mode — ``VectorFeeder``
(vector_feeder.py:3-17, cursor-based batch iterator),
``PQIndexCreator.index_batch`` / ``IVFADCIndexCreator.index_batch``
(pq_index_creator.py:9-63, ivfadc_index_creator.py:9-81) — and the
resilience story: a resumable artifact so a partial build can be picked up
again (pq_index.py:237-258, index_manager.py:20-44).

The quantizers train once up front on a training sample, then a vector
stream of any length encodes batch by batch on the codebook's device; the
codes stay there (they are small: 12 bytes a row at m = 12).
``checkpoint()`` writes one ``np.savez_compressed`` file with the JAX
package's keys (builders.py:85-104, 144-166), so either package resumes
the other's checkpoints; ``resume()`` restores the builder mid-stream on
the card unless ``device=`` names another device. ``finalize()``
assembles the normal index object.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from postgres_word2vec_tpu_torch.models.ivfadc import (CoarseQuantizer,
                                                       IVFADCIndex)
from postgres_word2vec_tpu_torch.models.pq import (PQCodebook, PQIndex,
                                                   recount, train_codebook)
from postgres_word2vec_tpu_torch.ops import kmeans
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _rows_on(vectors, device: torch.device) -> torch.Tensor:
    """A batch (numpy, list or tensor) as float32 rows on ``device``."""
    if isinstance(vectors, torch.Tensor):
        return vectors.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(vectors, np.float32), device=device)


def _training_rows(train_vectors, device) -> torch.Tensor:
    """Training rows on ``device``; a tensor keeps its own device unless
    ``device`` is given, anything else goes to the card unless ``device``
    names another (:func:`~postgres_word2vec_tpu_torch.utils.device.
    resolve_device`)."""
    if isinstance(train_vectors, torch.Tensor) and device is None:
        return train_vectors.float()
    return _rows_on(train_vectors, resolve_device(device))


def _codes_or_empty(parts: list[torch.Tensor], empty_shape, dtype
                    ) -> np.ndarray:
    """The accumulated parts as one host array (the checkpoint's form)."""
    if not parts:
        return np.zeros(empty_shape, dtype)
    return torch.cat(parts).cpu().numpy()


class VectorFeeder:
    """Batch iterator over a vector source (vector_feeder.py parity).

    Accepts any ``(n, d)`` array-like or tensor; yields
    ``(vectors, row_offset)``. A tensor is sliced in place (a card-resident
    table streams without a host copy); anything else becomes a float32
    numpy array."""

    def __init__(self, vectors, batch_size: int = 4096):
        self._vectors = (vectors if isinstance(vectors, torch.Tensor)
                         else np.asarray(vectors, np.float32))
        self.batch_size = int(batch_size)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self._vectors.shape[0]

    def next_batch(self):
        start = self._pos
        end = min(start + self.batch_size, self._vectors.shape[0])
        self._pos = end
        return self._vectors[start:end], start

    def __iter__(self) -> Iterator[tuple]:
        while self.has_next():
            yield self.next_batch()


class PQIndexCreator:
    """Streaming PQ builder (pq_index_creator.py parity)."""

    def __init__(self, codebook: PQCodebook):
        self.codebook = codebook
        self._codes: list[torch.Tensor] = []
        self.rows_done = 0

    @property
    def device(self) -> torch.device:
        return self.codebook.centroids.device

    @classmethod
    def from_training(cls, generator: torch.Generator, train_vectors,
                      m: int = 12, k: int = 256, iters: int = 10, *,
                      device: torch.device | str | None = None
                      ) -> "PQIndexCreator":
        """Train an m×k codebook on all of ``train_vectors`` with draws
        from ``generator`` (on the training rows' device)."""
        tv = _training_rows(train_vectors, device)
        return cls(train_codebook(generator, tv, m, k, train_size=None,
                                  iters=iters))

    def index_batch(self, vectors) -> torch.Tensor:
        """Encode one batch, keep its codes, and return them ``(b, m)``."""
        codes = kmeans.encode_subspaces(_rows_on(vectors, self.device),
                                        self.codebook.centroids)
        self._codes.append(codes)
        self.rows_done += codes.shape[0]
        return codes

    # ---------------------------------------------------- checkpoint/resume
    def checkpoint(self, path: str | Path) -> None:
        np.savez_compressed(
            path, kind="pq",
            centroids=self.codebook.centroids.cpu().numpy(),
            counts=self.codebook.counts.cpu().numpy(),
            codes=_codes_or_empty(self._codes, (0, 0), np.uint8))

    @classmethod
    def resume(cls, path: str | Path, *,
               device: torch.device | str | None = None
               ) -> "PQIndexCreator":
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as f:
            c = cls(PQCodebook(torch.as_tensor(f["centroids"], device=dev),
                               torch.as_tensor(f["counts"], device=dev)))
            codes = f["codes"]
            if codes.size:
                c._codes = [torch.as_tensor(codes, device=dev)]
                c.rows_done = codes.shape[0]
        return c

    def finalize(self) -> PQIndex:
        codes = torch.cat(self._codes)
        return PQIndex(recount(self.codebook, codes), codes)


class IVFADCIndexCreator:
    """Streaming IVFADC builder (ivfadc_index_creator.py parity): coarse
    assignment + residual encode per batch, CSR assembly at finalize."""

    def __init__(self, coarse_centroids: torch.Tensor, codebook: PQCodebook):
        self.coarse_centroids = coarse_centroids
        self.codebook = codebook
        self._codes: list[torch.Tensor] = []
        self._assign: list[torch.Tensor] = []
        self.rows_done = 0

    @property
    def device(self) -> torch.device:
        return self.codebook.centroids.device

    @classmethod
    def from_training(cls, generator: torch.Generator, train_vectors,
                      m: int = 12, k: int = 256, k_coarse: int = 1000,
                      iters: int = 10, *,
                      device: torch.device | str | None = None
                      ) -> "IVFADCIndexCreator":
        """Coarse k-means, then a residual codebook, on all of
        ``train_vectors`` with draws from ``generator``."""
        tv = _training_rows(train_vectors, device)
        coarse = kmeans.kmeans(generator, tv, k_coarse, iters)
        resid = tv - coarse.centroids[kmeans.assign(tv, coarse.centroids)]
        cb = kmeans.kmeans_subspaces(
            generator, kmeans.split_subspaces(resid, m), k, iters)
        return cls(coarse.centroids, PQCodebook(cb.centroids, cb.counts))

    def index_batch(self, vectors) -> tuple[torch.Tensor, torch.Tensor]:
        """Assign and residual-encode one batch → (codes (b, m), coarse
        cell int32 (b,))."""
        v = _rows_on(vectors, self.device)
        assign = kmeans.assign(v, self.coarse_centroids)
        codes = kmeans.encode_residual_subspaces(
            v, self.coarse_centroids, assign, self.codebook.centroids)
        assign = assign.to(torch.int32)
        self._codes.append(codes)
        self._assign.append(assign)
        self.rows_done += codes.shape[0]
        return codes, assign

    def checkpoint(self, path: str | Path) -> None:
        np.savez_compressed(
            path, kind="ivfadc",
            coarse=self.coarse_centroids.cpu().numpy(),
            centroids=self.codebook.centroids.cpu().numpy(),
            counts=self.codebook.counts.cpu().numpy(),
            codes=_codes_or_empty(self._codes, (0, 0), np.uint8),
            assign=_codes_or_empty(self._assign, (0,), np.int32))

    @classmethod
    def resume(cls, path: str | Path, *,
               device: torch.device | str | None = None
               ) -> "IVFADCIndexCreator":
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as f:
            c = cls(torch.as_tensor(f["coarse"], device=dev),
                    PQCodebook(torch.as_tensor(f["centroids"], device=dev),
                               torch.as_tensor(f["counts"], device=dev)))
            if f["codes"].size:
                c._codes = [torch.as_tensor(f["codes"], device=dev)]
                c._assign = [torch.as_tensor(f["assign"].astype(np.int32),
                                             device=dev)]
                c.rows_done = f["codes"].shape[0]
        return c

    def finalize(self) -> IVFADCIndex:
        codes = torch.cat(self._codes)
        assign = torch.cat(self._assign).long()
        k_coarse = self.coarse_centroids.shape[0]
        counts = torch.bincount(assign, minlength=k_coarse).to(torch.int32)
        return IVFADCIndex._assemble(
            CoarseQuantizer(self.coarse_centroids, counts), self.codebook,
            codes, assign)
