"""Exact similarities and the fused scan's binned top-k, in float64.

FREDDY's similarity of two rows is ``1 − d²/2`` with ``d²`` their squared
L2 distance (``‖q‖² + ‖v‖² − 2·q·v``, never below 0; on unit rows the
similarity is the cosine).

The fused exact scan keeps one survivor per strided bin, the best row of
each bin, and answers the best k survivors. A bin is the 64 rows
``t·block_n + a·bins + j`` (a = 0…63) of tile ``t``, for ``j`` in
``[0, bins)``; two neighbours that share a bin give one survivor. Its
table is bfloat16: the product ``q·v`` is of the two rows rounded to
bfloat16, the norms are the float32 rows'. The reference answers the
same, from its own float64 sums (``operand=torch.bfloat16``).
"""

from __future__ import annotations

import torch

from freddy_bench.reference import no_tf32


def _operand(x: torch.Tensor, operand) -> torch.Tensor:
    """``x`` in float64, rounded to ``operand`` first where one is given."""
    return (x if operand is None else x.to(operand)).double()


def sims_f64(q: torch.Tensor, v: torch.Tensor, operand=None
             ) -> torch.Tensor:
    """``(B, d) × (C, d)`` float64 similarities ``1 − d²/2``; the product
    ``q·v`` of the rows rounded to ``operand`` where one is given."""
    qf, vf = q.double(), v.double()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    vv = torch.sum(vf * vf, dim=-1)
    qv = _operand(q, operand) @ _operand(v, operand).t()
    return 1.0 - torch.clamp_min(qq + vv[None, :] - 2.0 * qv, 0.0) / 2.0


def true_sims(vectors: torch.Tensor, qids: torch.Tensor,
              rows: torch.Tensor, operand=None) -> torch.Tensor:
    """The float64 similarity of query row ``qids[b]`` to each of
    ``rows[b]`` (B, k), the product of operands rounded to ``operand``
    where one is given; NaN where a row id is negative."""
    q = vectors[qids]
    v = vectors[rows.clamp_min(0).reshape(-1)].reshape(*rows.shape, -1)
    qf, vf = q.double(), v.double()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    vv = torch.sum(vf * vf, dim=-1)
    qv = torch.einsum("bd,bkd->bk", _operand(q, operand),
                      _operand(v, operand))
    s = 1.0 - torch.clamp_min(qq + vv - 2.0 * qv, 0.0) / 2.0
    return torch.where(rows >= 0, s, torch.full_like(s, float("nan")))


def _merge(best_s, best_i, s, i, k):
    cs = torch.cat([best_s, s], dim=1)
    ci = torch.cat([best_i, i], dim=1)
    top, pos = torch.topk(cs, k, dim=1)
    return top, torch.gather(ci, 1, pos)


@no_tf32()
def binned_top_k(vectors: torch.Tensor, qids: torch.Tensor, k: int, *,
                 operand=None, block_n: int = 8192, bins: int = 128,
                 q_block: int = 128, tiles_per_chunk: int = 32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The best ``k`` bin survivors of each query row → (ids (B, k) int64,
    sims (B, k) float64), best first; products as :func:`sims_f64`."""
    n = vectors.shape[0]
    dev = vectors.device
    B = qids.shape[0]
    best_s = torch.full((B, k), -float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    chunk = tiles_per_chunk * block_n
    j = torch.arange(bins, device=dev)
    for r0 in range(0, n, chunk):
        v = vectors[r0:r0 + chunk]
        rows = v.shape[0]
        tiles = -(-rows // block_n)
        for b0 in range(0, B, q_block):
            s = sims_f64(vectors[qids[b0:b0 + q_block]], v, operand)
            pad = tiles * block_n - rows
            if pad:
                s = torch.nn.functional.pad(s, (0, pad),
                                            value=-float("inf"))
            s = s.reshape(s.shape[0], tiles, block_n // bins, bins)
            top, arg = torch.max(s, dim=2)              # (qb, tiles, bins)
            t = torch.arange(tiles, device=dev)[:, None]
            ids = r0 + t * block_n + arg * bins + j
            top = top.reshape(top.shape[0], -1)
            ids = ids.reshape(ids.shape[0], -1)
            best_s[b0:b0 + q_block], best_i[b0:b0 + q_block] = _merge(
                best_s[b0:b0 + q_block], best_i[b0:b0 + q_block], top, ids,
                k)
    return best_i, best_s


@no_tf32()
def exact_top_k(vectors: torch.Tensor, qids: torch.Tensor, k: int, *,
                targets: torch.Tensor | None = None, q_block: int = 256,
                chunk: int = 262144) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact best ``k`` rows of each query row among ``targets`` (row
    ids; all rows when None) → (ids (B, k) int64, sims (B, k) float64),
    best first."""
    dev = vectors.device
    if targets is None:
        targets = torch.arange(vectors.shape[0], device=dev)
    B = qids.shape[0]
    best_s = torch.full((B, k), -float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    for t0 in range(0, targets.shape[0], chunk):
        tid = targets[t0:t0 + chunk]
        v = vectors[tid].double()
        for b0 in range(0, B, q_block):
            s = sims_f64(vectors[qids[b0:b0 + q_block]], v)
            top, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
            best_s[b0:b0 + q_block], best_i[b0:b0 + q_block] = _merge(
                best_s[b0:b0 + q_block], best_i[b0:b0 + q_block], top,
                tid[pos], k)
    return best_i, best_s
