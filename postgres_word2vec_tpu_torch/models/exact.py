"""Exact brute-force k-NN — the ground-truth path.

Counterpart of ``postgres_word2vec_tpu/models/exact.py``: parity targets
``k_nearest_neighbour`` (freddy--0.0.1.sql:426-454 — full table ORDER BY
cosine), the ``knn_in_exact`` overloads (sql:991-1084) and
``knn_search_in_batch`` (sql:456-501). One ``(B, d) × (d, N)`` matmul per
row chunk with a running top-k; the matmul is ``torch.matmul``, as the JAX
package leaves it to XLA. Distances are squared L2 (similarity
= 1 − d²/2 on normalized vectors, sql:511).

A bfloat16 table is widened to float32 per chunk before the matmul: a
bf16 × bf16 ``torch.matmul`` returns bf16, and the JAX path keeps float32
scores (bf16 operands, float32 accumulation). float32 matmuls run with
TF32 off, as the JAX path pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses

import torch

from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32, row_sqnorms
from postgres_word2vec_tpu_torch.utils.shapes import snap_chunk

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NOT_YET = ("arrives with ROADMAP.md queue 1, item 4 (exact slice: int8 "
            "and extended())")


def _dtype(name: str) -> torch.dtype:
    if name == "int8":
        raise NotImplementedError(f"compute_dtype='int8' {_NOT_YET}")
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32|bfloat16|int8, "
                         f"got {name!r}")
    return _DTYPES[name]


def _sqdist_block(q: torch.Tensor, v_chunk: torch.Tensor,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Squared L2 ``(B, d) × (C, d) → (B, C)`` float32, operands rounded
    to ``compute_dtype``."""
    qf = q.float()
    vf = v_chunk.float()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    vv = torch.sum(vf * vf, dim=-1)
    qv = q.to(compute_dtype).float() @ v_chunk.to(compute_dtype).float().t()
    return torch.clamp_min(qq - 2.0 * qv + vv[None, :], 0.0)


@no_tf32()
def exact_top_k(queries: torch.Tensor, vectors: torch.Tensor, k: int, *,
                chunk_size: int = 262144, dtype: str = "float32"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-scan exact top-k → ``(B, k)`` (squared L2 dists, row ids)."""
    compute_dtype = _dtype(dtype)
    n = vectors.shape[0]
    if n <= chunk_size:
        dists = _sqdist_block(queries, vectors, compute_dtype)
        return topk_ops.top_k_smallest(dists, min(k, n))
    chunk_size = snap_chunk(n, chunk_size)
    return topk_ops.chunked_top_k_smallest(
        lambda s: _sqdist_block(queries, vectors[s:s + chunk_size],
                                compute_dtype),
        n, chunk_size, k)


@no_tf32()
def exact_top_k_in(queries: torch.Tensor, vectors: torch.Tensor,
                   target_ids: torch.Tensor, target_mask: torch.Tensor,
                   k: int, *, dtype: str = "float32"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k restricted to a padded target-id set; ids are global,
    −1 where fewer than k real targets exist (``knn_in_exact``,
    sql:991-1084)."""
    tids = target_ids.long()
    tv = vectors[torch.clamp_min(tids, 0)]
    d = _sqdist_block(queries, tv, _dtype(dtype))
    d = torch.where(target_mask[None, :], d, torch.full_like(d, float("inf")))
    k_eff = min(k, tids.shape[0])
    vals, pos = topk_ops.top_k_smallest(d, k_eff)
    ids = torch.where(torch.isfinite(vals), tids[pos],
                      torch.full_like(pos, -1))
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff),
                                       value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    return vals, ids


@no_tf32()
def exact_top_k_precast(queries: torch.Tensor, table: torch.Tensor,
                        norms: torch.Tensor, k: int, *,
                        chunk_size: int = 1_048_576
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan a pre-cast table (float32 or bfloat16) with precomputed float32
    row norms → (squared dists, ids). The top-k is exact."""
    n = table.shape[0]
    qc = queries.to(table.dtype).float()
    qf = queries.float()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)

    def score(s: int) -> torch.Tensor:
        qv = qc @ table[s:s + chunk_size].float().t()
        return torch.clamp_min(qq - 2.0 * qv + norms[s:s + chunk_size][None],
                               0.0)

    if n <= chunk_size:
        return topk_ops.top_k_smallest(score(0), min(k, n))
    chunk_size = snap_chunk(n, chunk_size)
    return topk_ops.chunked_top_k_smallest(score, n, chunk_size, k)


@dataclasses.dataclass
class ExactIndex:
    """Brute-force index over a device-resident ``(N, d)`` table.

    ``compute_dtype``: "float32" for the bit-faithful ground truth,
    "bfloat16" for the production scan (table cast once; float32
    accumulation and float32 row norms). ``fused=True`` lays the table out
    for the fused scan kernel K1 (:func:`ops.kernels.fused_exact_top_k`,
    bfloat16 only), which ``search`` runs when ``approx`` is set on the
    index or the call; every other search is an exact top-k. "int8" and
    :meth:`extended` are not ported yet and raise ``NotImplementedError``.
    """

    vectors: torch.Tensor
    compute_dtype: str = "float32"
    approx: bool = False
    fused: bool = False

    def __post_init__(self) -> None:
        dt = _dtype(self.compute_dtype)
        self._norms = row_sqnorms(self.vectors)
        self._table = (self.vectors if dt == torch.float32
                       else self.vectors.to(dt))
        self._tiled = None
        if self.fused:
            if dt != torch.bfloat16:
                raise ValueError("fused mode runs the bf16 scan kernel; "
                                 "use compute_dtype='bfloat16'")
            from postgres_word2vec_tpu_torch.ops import kernels
            self._tiled, self._tiled_norms, self._valid_n = (
                kernels.tile_table(self.vectors))

    def extended(self, full_vectors: torch.Tensor, new_rows: torch.Tensor
                 ) -> "ExactIndex":
        raise NotImplementedError(f"ExactIndex.extended() {_NOT_YET}")

    def search(self, queries: torch.Tensor, k: int, *,
               approx: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        use_approx = self.approx if approx is None else approx
        if self._tiled is not None and use_approx:
            from postgres_word2vec_tpu_torch.ops import kernels
            return kernels.fused_exact_top_k(queries, self._tiled,
                                             self._tiled_norms, k,
                                             valid_n=self._valid_n)
        return exact_top_k_precast(queries, self._table, self._norms, k)

    def search_in(self, queries: torch.Tensor, k: int,
                  target_ids: torch.Tensor,
                  target_mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k restricted to a target id set (``knn_in_exact``,
        sql:991-1084), in the index's compute dtype; global ids."""
        if target_mask is None:
            target_mask = torch.ones(target_ids.shape, dtype=torch.bool,
                                     device=target_ids.device)
        return exact_top_k_in(queries, self.vectors, target_ids, target_mask,
                              k, dtype=self.compute_dtype)
