"""Small-vector algebra of the reference's SQL layer, on torch tensors.

Counterpart of ``postgres_word2vec_tpu/ops/vector_ops.py`` for the ops the
search path needs: L2 normalisation (``vec_normalize``,
core_functions.c:211-243) and the squared-distance ↔ cosine maps of the
ADC paths (freddy--0.0.1.sql:511,526,547). Accumulation is float32.
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


def vec_normalize(a: torch.Tensor) -> torch.Tensor:
    """L2-normalize along the last axis (float32 result)."""
    a = a.float()
    norm = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    return a / torch.clamp_min(norm, _EPS)


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
