"""Vector store + vocabulary — the framework's L0, on torch tensors.

Counterpart of ``postgres_word2vec_tpu/store.py``: a host-side vocabulary
(word ↔ dense row id) and ``(N, d)`` float32 tables of raw and
L2-normalized vectors on one device. It reads and writes the same
``store.npz`` as the JAX package (``words`` as fixed-width unicode,
``vectors`` float32), so a store saved by either loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from postgres_word2vec_tpu_torch.ops.vector_ops import vec_normalize
from postgres_word2vec_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class VectorStore:
    """Vocabulary + device-resident vector tables. ``id`` is the dense row
    index (0..N-1)."""

    words: list[str]
    word_to_id: dict[str, int]
    vectors: torch.Tensor        # (N, d) float32, raw
    vectors_norm: torch.Tensor   # (N, d) float32, L2-normalized

    # ------------------------------------------------------------ creation
    @classmethod
    def from_arrays(cls, words: Sequence[str], vectors,
                    normalized: bool = False, *,
                    device: torch.device | str | None = None
                    ) -> "VectorStore":
        """Build from a word list and an ``(N, d)`` array or tensor.

        ``normalized=True`` declares the rows unit-length already: the
        normalized table is then the raw table itself, not a copy.
        ``device``: a torch tensor stays on its own device unless one is
        named; anything else goes to the card (``resolve_device``), or to
        ``device`` if given."""
        if device is not None or not isinstance(vectors, torch.Tensor):
            device = resolve_device(device)
        vecs = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        if vecs.ndim != 2 or vecs.shape[0] != len(words):
            raise ValueError(
                f"vectors shape {tuple(vecs.shape)} does not match "
                f"{len(words)} words")
        word_to_id = {w: i for i, w in enumerate(words)}
        if len(word_to_id) != len(words):
            raise ValueError("duplicate words in vocabulary")
        norm = vecs if normalized else vec_normalize(vecs)
        return cls(list(words), word_to_id, vecs, norm)

    @classmethod
    def from_text_file(cls, path: str | Path, max_words: int | None = None,
                       use_native: bool = True, *,
                       device: torch.device | str | None = None
                       ) -> "VectorStore":
        """Parse word2vec text format (header line ``N d``, then
        ``word v1 … vd`` rows) — parity with index_utils.py:8-40. The C++
        parser (native/fastio.cpp) when ``use_native`` and it builds,
        else numpy. On the card unless ``device`` names another; the
        device is resolved before the file is read."""
        device = resolve_device(device)
        words, vecs = _load_text_embeddings(Path(path), max_words,
                                            use_native=use_native)
        return cls.from_arrays(words, vecs, device=device)

    @classmethod
    def from_binary_file(cls, path: str | Path,
                         max_words: int | None = None, *,
                         device: torch.device | str | None = None
                         ) -> "VectorStore":
        """Load word2vec .bin format through the native parser (JAX
        store.py:101-109; replaces the reference's gensim conversion,
        transform_vecs.py:1-9). On the card unless ``device`` names
        another, resolved before the file is read."""
        from postgres_word2vec_tpu_torch.utils import native_io

        device = resolve_device(device)
        words, vecs = native_io.load_binary_embeddings(Path(path), max_words)
        return cls.from_arrays(words, vecs, device=device)

    # ------------------------------------------------------------- lookups
    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def size(self) -> int:
        return len(self.words)

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def __len__(self) -> int:
        return len(self.words)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_id

    def get_id(self, word: str) -> int:
        return self.word_to_id[word]

    def get_ids(self, words: Iterable[str], *, strict: bool = True
                ) -> list[int]:
        """Map words → ids. ``strict=False`` silently drops unknown words
        (the reference's SQL joins drop non-matching rows the same way)."""
        if strict:
            return [self.word_to_id[w] for w in words]
        return [self.word_to_id[w] for w in words if w in self.word_to_id]

    def get_words(self, ids: Iterable[int]) -> list[str]:
        """Map ids → words, "" for an id outside the store."""
        n = len(self.words)
        return [self.words[i] if 0 <= i < n else "" for i in ids]

    def vector_for(self, word: str, *, normalized: bool = True
                   ) -> torch.Tensor:
        table = self.vectors_norm if normalized else self.vectors
        return table[self.word_to_id[word]]

    def vectors_for(self, words: Sequence[str], *,
                    normalized: bool = True) -> torch.Tensor:
        ids = torch.as_tensor(self.get_ids(words), dtype=torch.int64,
                              device=self.device)
        table = self.vectors_norm if normalized else self.vectors
        return table.index_select(0, ids)

    # ------------------------------------------------------------ mutation
    def _check_new(self, words: Sequence[str]) -> None:
        for w in words:
            if w in self.word_to_id:
                raise ValueError(f"word already present: {w!r}")

    def extend(self, words: Sequence[str], vectors) -> "VectorStore":
        """Append new (word, raw vector) rows, returning a new store (JAX
        store.py:150-169). New rows get the next dense ids; their
        normalized rows are ``normalize(vectors)``. Duplicate words raise
        (``insert_batch`` skips terms already present, freddy.c:1498-1514,
        before it gets here)."""
        self._check_new(words)
        vecs = torch.as_tensor(vectors, dtype=torch.float32,
                               device=self.device)
        w2i = dict(self.word_to_id)
        for i, w in enumerate(words, start=len(self.words)):
            w2i[w] = i
        return VectorStore(self.words + list(words), w2i,
                           torch.cat([self.vectors, vecs]),
                           torch.cat([self.vectors_norm,
                                      vec_normalize(vecs)]))

    def extend_inplace(self, words: Sequence[str], vectors
                       ) -> "VectorStore":
        """The insert path's :meth:`extend`: appends to THIS store and
        returns it (JAX store.py:171-201). The host side is a list and
        dict append, O(batch); the device side one concatenation per
        table. Duplicates are checked before anything changes, so a raise
        leaves the store as it was. The raw table is replaced before the
        normalized one is concatenated, so the old raw table can be freed
        first."""
        self._check_new(words)
        vecs = torch.as_tensor(vectors, dtype=torch.float32,
                               device=self.device)
        self.vectors = torch.cat([self.vectors, vecs])
        self.vectors_norm = torch.cat([self.vectors_norm,
                                       vec_normalize(vecs)])
        start = len(self.words)
        self.words.extend(words)
        for i, w in enumerate(words, start=start):
            self.word_to_id[w] = i
        return self

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        """Serialize to .npz, the JAX package's format. Words are
        fixed-width unicode, never dtype=object: loading object arrays
        needs allow_pickle=True, which executes code from the file."""
        np.savez_compressed(
            path,
            words=np.asarray(self.words, dtype=str),
            vectors=self.vectors.detach().cpu().numpy(),
        )

    @classmethod
    def load(cls, path: str | Path, *,
             device: torch.device | str | None = None) -> "VectorStore":
        """A store saved by either package, on the card unless ``device``
        names another."""
        from postgres_word2vec_tpu_torch.utils.convert import store_from_numpy

        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as f:
            words = [str(w) for w in f["words"]]
            vectors = f["vectors"]
        return store_from_numpy(words, vectors, device)


# ---------------------------------------------------------------- parsing

def _load_text_embeddings(path: Path, max_words: int | None,
                          use_native: bool = True
                          ) -> tuple[list[str], np.ndarray]:
    """The native parser when asked for and it works (JAX
    store.py:226-235), else :func:`_load_text_embeddings_py`."""
    if use_native:
        try:
            from postgres_word2vec_tpu_torch.utils import native_io
            return native_io.load_text_embeddings(path, max_words)
        except Exception:
            pass  # fall back to the numpy parser
    return _load_text_embeddings_py(path, max_words)


def _load_text_embeddings_py(path: Path, max_words: int | None
                             ) -> tuple[list[str], np.ndarray]:
    words: list[str] = []
    rows: list[np.ndarray] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        dim = int(header[1]) if len(header) == 2 else None
        if dim is None:
            # No header: first line is a data row.
            f.seek(0)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if dim is None:
                dim = len(parts) - 1
            if len(parts) < dim + 1:
                continue
            words.append(parts[0])
            rows.append(np.asarray(parts[1:dim + 1], dtype=np.float32))
            if max_words is not None and len(words) >= max_words:
                break
    return words, np.stack(rows) if rows else np.zeros((0, dim or 0),
                                                       np.float32)
