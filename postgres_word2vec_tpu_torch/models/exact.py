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

The int8 index quantizes rows symmetrically (one scale per row) and
queries likewise; the q·v cross term is an exact int8 × int8 → int32
product, ``torch._int_mm`` (as the JAX package leaves it to XLA, outside
any kernel), rescaled by both scales; ‖v‖² stays the exact float32 norm.

Online insert goes through :meth:`ExactIndex.extended`: only the new rows
are cast or quantized, and they are written in place into capacity
buffers that grow by doubling.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32, row_sqnorms
from postgres_word2vec_tpu_torch.utils.shapes import snap_chunk

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _dtype(name: str) -> torch.dtype:
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


def _float_dtype(name: str) -> torch.dtype:
    dt = _dtype(name)
    if dt == torch.int8:
        raise ValueError("the float scans take float32|bfloat16; int8 "
                         "scans run through exact_top_k_int8")
    return dt


@no_tf32()
def exact_top_k(queries: torch.Tensor, vectors: torch.Tensor, k: int, *,
                chunk_size: int = 262144, dtype: str = "float32"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-scan exact top-k → ``(B, k)`` (squared L2 dists, row ids)."""
    compute_dtype = _float_dtype(dtype)
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
    d = _sqdist_block(queries, tv, _float_dtype(dtype))
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


def quantize_rows_int8(vectors: torch.Tensor, *, chunk_rows: int = 262144
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization → (int8 table, float32 scales):
    ``scale = max|v|/127``, ``q = clip(round(v / max(scale, 1e-12)))`` —
    the JAX package's ``quantize_rows_int8`` (exact.py:140-152), in row
    chunks so no float copy of a large table exists whole."""
    n, d = vectors.shape
    q = torch.empty(n, d, dtype=torch.int8, device=vectors.device)
    scales = torch.empty(n, dtype=torch.float32, device=vectors.device)
    for s in range(0, n, chunk_rows):
        v = vectors[s:s + chunk_rows].float()
        sc = torch.amax(torch.abs(v), dim=-1) / 127.0
        safe = torch.clamp_min(sc, 1e-12)
        q[s:s + chunk_rows] = torch.clamp(torch.round(v / safe[:, None]),
                                          -127, 127).to(torch.int8)
        scales[s:s + chunk_rows] = sc
    return q, scales


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for int8 ``a`` (M, K) and ``b`` (N, K) → exact int32
    (M, N) through ``torch._int_mm``. On the card it wants more than 16
    rows in ``a`` and K and N multiples of 8: zero rows and columns are
    padded where needed (exact) and cut off again."""
    m, kd = a.shape
    n = b.shape[0]
    if a.is_cuda:
        mp, kp, np_ = max(_round8(m), 24), _round8(kd), _round8(n)
        if (mp, kp) != (m, kd):
            a = F.pad(a, (0, kp - kd, 0, mp - m))
        if (np_, kp) != (n, kd):
            b = F.pad(b, (0, kp - kd, 0, np_ - n))
        return torch._int_mm(a, b.t())[:m, :n]
    return torch._int_mm(a, b.t())


def exact_top_k_int8(queries: torch.Tensor, table_i8: torch.Tensor,
                     scales: torch.Tensor, norms: torch.Tensor, k: int, *,
                     chunk_size: int = 1_048_576
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 brute-force top-k → (approximate squared dists, ids).

    ``q·v ≈ (q_i8·v_i8)·s_q·s_v`` with the int8 product exact in int32;
    ‖q‖² and the table's float32 ``norms`` are exact, so the only error is
    the cross term's quantization (the JAX package's ``exact_top_k_int8``,
    exact.py:155-198). ``table_i8`` may be wider than the queries (zero
    columns) and longer than the valid rows (+inf norms); the top-k over
    the scores is exact."""
    n = table_i8.shape[0]
    qf = queries.float()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    q_safe = torch.clamp_min(torch.amax(torch.abs(qf), dim=-1) / 127.0,
                             1e-12)
    q_i8 = torch.clamp(torch.round(qf / q_safe[:, None]), -127,
                       127).to(torch.int8)
    if q_i8.shape[1] < table_i8.shape[1]:
        q_i8 = F.pad(q_i8, (0, table_i8.shape[1] - q_i8.shape[1]))

    def score(s: int) -> torch.Tensor:
        qv_i = _int8_matmul(q_i8, table_i8[s:s + chunk_size]).float()
        qv = qv_i * q_safe[:, None] * scales[s:s + chunk_size][None, :]
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
    accumulation and float32 row norms), "int8" for the per-row quantized
    table (:func:`exact_top_k_int8`; the int8 table is stored with its
    columns padded to a multiple of 8). ``fused=True`` lays the table out
    for the fused scan kernel K1 (:func:`ops.kernels.fused_exact_top_k`,
    bfloat16 only), which ``search`` runs when ``approx`` is set on the
    index or the call; every other search is an exact top-k.
    :meth:`extended` appends rows in place into capacity buffers.
    """

    vectors: torch.Tensor
    compute_dtype: str = "float32"
    approx: bool = False
    fused: bool = False

    #: capacity rounds up to this many rows when the buffers grow
    _GROW_QUANTUM = 4096

    def __post_init__(self) -> None:
        dt = _dtype(self.compute_dtype)
        self._consumed = False
        self._size = int(self.vectors.shape[0])
        self._norms = row_sqnorms(self.vectors)
        self._scales = None
        if dt == torch.int8:
            q, self._scales = quantize_rows_int8(self.vectors)
            d = q.shape[1]
            self._table = F.pad(q, (0, _round8(d) - d)) if d % 8 else q
        elif dt == torch.float32:
            self._table = self.vectors
        else:
            self._table = self.vectors.to(dt)
        self._tiled = None
        if self.fused:
            if dt != torch.bfloat16:
                raise ValueError("fused mode runs the bf16 scan kernel; "
                                 "use compute_dtype='bfloat16'")
            from postgres_word2vec_tpu_torch.ops import kernels
            self._tiled, self._tiled_norms, self._valid_n = (
                kernels.tile_table(self.vectors))

    # ------------------------------------------------------------ mutation
    def _encode_rows(self, rows: torch.Tensor):
        """New rows in the table's storage form → (rows, norms, scales)."""
        rf = rows.float()
        norms = torch.sum(rf * rf, dim=-1)
        if self.compute_dtype == "int8":
            q, scales = quantize_rows_int8(rows)
            return q, norms, scales
        return rows.to(_dtype(self.compute_dtype)), norms, None

    def extended(self, full_vectors: torch.Tensor, new_rows: torch.Tensor
                 ) -> "ExactIndex":
        """O(batch) successor index after an insert (``insert_batch``
        appends rows, freddy.c:1631-1655 — the reference never rebuilds on
        insert; JAX exact.py:283-344).

        Casts or quantizes only ``new_rows`` and writes them in place into
        capacity buffers. When the buffers are full they grow to
        ``max(2·capacity, needed)`` rounded up to 4096 rows (one copy,
        amortized O(1) per row); capacity rows past the last real row are
        zeros with +inf norms, so every search excludes them without a
        mask. ``full_vectors`` is the already-extended store table, used by
        :meth:`search_in` — aliased, not copied.

        The receiver is consumed: its buffers become the successor's, and
        searching it afterwards raises. Fused mode raises: its tiled
        layout does not extend (build a fresh fused index instead)."""
        if self.fused:
            raise ValueError("extended() does not support fused mode — "
                             "rebuild the fused index instead")
        self._check_live()
        b = int(new_rows.shape[0])
        n = self._size
        rows, rnorms, rscales = self._encode_rows(new_rows)
        table, norms, scales = self._table, self._norms, self._scales
        if n + b > table.shape[0]:
            q = self._GROW_QUANTUM
            cap = -(-max(2 * table.shape[0], n + b) // q) * q
            grown = torch.zeros(cap, table.shape[1], dtype=table.dtype,
                                device=table.device)
            grown[:n] = table[:n]
            table = grown
            norms = torch.cat([norms[:n], torch.full(
                (cap - n,), float("inf"), device=norms.device)])
            if scales is not None:
                scales = torch.cat([scales[:n], scales.new_zeros(cap - n)])
        table[n:n + b, :rows.shape[1]] = rows
        norms[n:n + b] = rnorms
        if scales is not None:
            scales[n:n + b] = rscales
        out = ExactIndex.__new__(ExactIndex)
        out.vectors, out.compute_dtype = full_vectors, self.compute_dtype
        out.approx, out.fused = self.approx, False
        out._consumed, out._size, out._tiled = False, n + b, None
        out._table, out._norms, out._scales = table, norms, scales
        self._consumed = True
        self._table = self._norms = self._scales = None
        return out

    def _check_live(self) -> None:
        if self._consumed:
            raise RuntimeError("this ExactIndex was consumed by extended(); "
                               "search the index it returned")

    # ------------------------------------------------------------- search
    def search(self, queries: torch.Tensor, k: int, *,
               approx: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        self._check_live()
        use_approx = self.approx if approx is None else approx
        if self._scales is not None:
            return exact_top_k_int8(queries, self._table, self._scales,
                                    self._norms, k)
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
        sql:991-1084), in the index's compute dtype (float32 for an int8
        index, as in the JAX package); global ids."""
        self._check_live()
        if target_mask is None:
            target_mask = torch.ones(target_ids.shape, dtype=torch.bool,
                                     device=target_ids.device)
        dtype = ("float32" if self.compute_dtype == "int8"
                 else self.compute_dtype)
        return exact_top_k_in(queries, self.vectors, target_ids, target_mask,
                              k, dtype=dtype)
