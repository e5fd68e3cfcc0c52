"""Small-vector algebra of the reference's SQL layer, on torch tensors.

Counterpart of ``postgres_word2vec_tpu/ops/vector_ops.py``: the
reference's scalar C functions (core_functions.c:23-383,
cosine_similarity.c:12-45) — cosine similarity, full and dot-only; vector
plus, minus and normalize; centroid; squared L2 — batched over leading
axes, and the squared-distance ↔ cosine maps of the ADC paths
(freddy--0.0.1.sql:511,526,547). Accumulation is float32.
"""

from __future__ import annotations

import contextlib

import torch

_EPS = 1e-12


@contextlib.contextmanager
def no_tf32():
    """Run float32 matmuls on the card in full float32 (TF32 off) inside
    the block, as the JAX package pins ``Precision.HIGHEST`` per call, and
    give the caller back its own ``allow_tf32`` setting after it. Also a
    decorator."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full cosine similarity along the last axis, both sides normalized
    (``cosine_similarity``, core_functions.c:23-42)."""
    a, b = a.float(), b.float()
    na = torch.sqrt(torch.sum(a * a, dim=-1))
    nb = torch.sqrt(torch.sum(b * b, dim=-1))
    return torch.sum(a * b, dim=-1) / torch.clamp_min(na * nb, _EPS)


def cosine_similarity_norm(a: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """Dot product only, for normalized inputs
    (``cosine_similarity_norm``, core_functions.c:44-81)."""
    return torch.sum(a.float() * b.float(), dim=-1)


def vec_plus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``vec_plus`` (core_functions.c:146-178)."""
    return a + b


def vec_minus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``vec_minus`` (core_functions.c:83-115)."""
    return a - b


def vec_normalize(a: torch.Tensor) -> torch.Tensor:
    """L2-normalize along the last axis (float32 result)."""
    a = a.float()
    norm = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    return a / torch.clamp_min(norm, _EPS)


def centroid(vectors: torch.Tensor) -> torch.Tensor:
    """Mean over the second-to-last axis, ``(..., n, d) → (..., d)``
    (``centroid``, core_functions.c:271-383)."""
    return torch.mean(vectors.float(), dim=-2)


def squared_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance along the last axis (``squareDistance``,
    index_utils.c:500-508)."""
    d = a.float() - b.float()
    return torch.sum(d * d, dim=-1)


def row_sqnorms(x: torch.Tensor, *, chunk_rows: int = 262144
                ) -> torch.Tensor:
    """``‖x_i‖²`` in float32 for an ``(N, d)`` table, in row chunks so the
    squared copy of a large table never exists whole."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk_rows):
        c = x[s:s + chunk_rows].float()
        out[s:s + chunk_rows] = torch.sum(c * c, dim=-1)
    return out


def sim_from_sqdist(sqdist):
    """Squared L2 distance between unit vectors → cosine similarity
    (``1 − d²/2``, the reference's ADC report, sql:511). Works on tensors
    and numpy arrays alike."""
    return 1.0 - sqdist / 2.0


def sqdist_from_sim(sim):
    """Inverse of :func:`sim_from_sqdist`."""
    return 2.0 - 2.0 * sim
