"""ADC lookup-table construction, single and fused-pair.

Counterpart of ``postgres_word2vec_tpu/ops/lut.py``: the per-query m×k
table of squared subspace distances (``getPrecomputedDistances``,
index_utils.c:445-455), for the whole query batch at once — the cross term
is one batched matmul, the norm terms are rank-1 — and its fused-pair
(m/2)×k² variant with the matching pair codes.
"""

from __future__ import annotations

import torch

from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32


@no_tf32()
def build_luts(queries: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """Per-subspace squared-distance tables:
    ``(B, d) × (m, k, dsub) → (B, m, k)`` float32.

    ``luts[b, j, i] = ‖q_b[j·dsub:(j+1)·dsub] − codebooks[j, i]‖²``

    Computed in full float32: TF32 is switched off for the matmul, as the
    JAX version pins ``Precision.HIGHEST``.
    """
    m, k, dsub = codebooks.shape
    B = queries.shape[0]
    q = queries.float().reshape(B, m, dsub)
    c = codebooks.float()
    qq = torch.sum(q * q, dim=-1)                     # (B, m)
    cc = torch.sum(c * c, dim=-1)                     # (m, k)
    qc = torch.einsum("bmd,mkd->bmk", q, c)
    return torch.clamp_min(qq[:, :, None] - 2.0 * qc + cc[None], 0.0)


def build_double_luts(luts: torch.Tensor) -> torch.Tensor:
    """Fuse adjacent subspace pairs: ``(B, m, k) → (B, m/2, k²)``.

    ``double[b, p, i₁·k + i₂] = luts[b, 2p, i₁] + luts[b, 2p+1, i₂]`` — the
    reference's "short codes" tables (``getPrecomputedDistancesDouble``,
    index_utils.c:457-475), used by the IVPQ join when
    ``alpha·k > long_codes_threshold``. Requires even m."""
    B, m, k = luts.shape
    if m % 2 != 0:
        raise ValueError(f"double LUTs require even m, got {m}")
    a = luts[:, 0::2, :]
    b = luts[:, 1::2, :]
    return (a[:, :, :, None] + b[:, :, None, :]).reshape(B, m // 2, k * k)


def fuse_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pair-fuse codes to index double LUTs: ``(n, m) → (n, m/2)``,
    ``fused[:, p] = codes[:, 2p]·k + codes[:, 2p+1]``. int16 while k² fits
    it (the scan kernels read int16 codes), else int32."""
    dtype = torch.int16 if k * k <= 32768 else torch.int32
    c = codes.to(dtype)
    return c[:, 0::2] * k + c[:, 1::2]
