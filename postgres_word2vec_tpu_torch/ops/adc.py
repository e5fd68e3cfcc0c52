"""Asymmetric distance computation (ADC) — plain PyTorch versions.

Counterpart of ``postgres_word2vec_tpu/ops/adc.py``: the per-row
``LUT[pos·k + code]`` accumulation of ``pq_search`` (freddy.c:117-132),
its in-set and per-query-rows variants, the budgeted tile-gather probes of
IVFADC and the IVPQ join, and the exact post-verification re-rank
``postverify`` (index_utils.c:477-498). These are the CPU path and the
reference the scan and budget kernels (``ops/kernels.py``) are held to.
"""

from __future__ import annotations

import torch

from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32

#: Elements a plain budget probe gathers at once; larger query batches run
#: in query chunks so the gathered candidate block stays bounded.
_GATHER_ELEMS = 1 << 26


def _sum_dtype(luts: torch.Tensor) -> torch.dtype:
    """int8 LUTs sum exactly in int32; every other LUT sums in float32."""
    return torch.int32 if luts.dtype == torch.int8 else torch.float32


def adc_distances(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Dense ADC distances: ``(B, m, k) × (n, m) → (B, n)`` float32, or
    exact int32 sums for int8 LUTs (the caller applies their scale).

    ``out[b, i] = Σ_j luts[b, j, codes[i, j]]``, summed over j in order
    (freddy.c:128: ``distance += querySimilarities[j*k + codes[j]]``)."""
    dt = _sum_dtype(luts)
    lf = luts.to(dt)
    c = codes.long()
    out = torch.zeros(luts.shape[0], codes.shape[0], dtype=dt,
                      device=luts.device)
    for j in range(codes.shape[1]):
        out += lf[:, j].index_select(1, c[:, j])
    return out


def adc_distances_per_query(luts: torch.Tensor, codes: torch.Tensor
                            ) -> torch.Tensor:
    """ADC where every query has its own candidate rows:
    ``(B, m, k) × (B, T, m) → (B, T)`` float32 (int32 for int8 LUTs),
    ``out[b, t] = Σ_j luts[b, j, codes[b, t, j]]`` summed over j in order —
    the per-query gather of the probe paths."""
    dt = _sum_dtype(luts)
    lf = luts.to(dt)
    out = torch.zeros(codes.shape[:2], dtype=dt, device=luts.device)
    for j in range(codes.shape[2]):
        out += torch.gather(lf[:, j], 1, codes[:, :, j].long())
    return out


def tile_positions(tiles: torch.Tensor, block_t: int) -> torch.Tensor:
    """Row positions of each query's probed tiles: ``(B, P) → (B,
    P·block_t)`` int64, slot-major (slot p covers columns
    ``[p·block_t, (p+1)·block_t)``)."""
    lane = torch.arange(block_t, device=tiles.device)
    return (tiles.long()[:, :, None] * block_t
            + lane[None, None, :]).reshape(tiles.shape[0], -1)


def _query_chunk(per_query: int) -> int:
    return max(1, _GATHER_ELEMS // max(per_query, 1))


def budget_adc_xla(luts: torch.Tensor, codes_aligned: torch.Tensor,
                   rowterm: torch.Tensor, tiles: torch.Tensor, *,
                   block_t: int, scale: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Budgeted tile-gather ADC → ``(B, P·block_t)`` float32: per query,
    the lut-sum of its P tiles of ``block_t`` cell-aligned code rows plus
    ``rowterm`` (+inf marks pad rows and the inf tile, and stays +inf).
    int8 LUTs come with their per-query ``scale`` (B,): the exact int32
    sum is multiplied by it, then the row term is added, each rounded on
    its own.

    ``codes_aligned`` is row-major ``(NA, m)`` (a transposed view of the
    kernels' ``(m, NA)`` table works as well). Queries run in chunks so the
    gathered ``(B, P·block_t, m)`` codes stay bounded. The JAX package's
    plain twin of ``budget_adc_pallas``."""
    B = luts.shape[0]
    pt = tiles.shape[1] * block_t
    out = torch.empty(B, pt, dtype=torch.float32, device=luts.device)
    step = _query_chunk(pt * codes_aligned.shape[1])
    for s in range(0, B, step):
        pos = tile_positions(tiles[s:s + step], block_t)
        cand = codes_aligned[pos.reshape(-1)].reshape(*pos.shape, -1)
        d = adc_distances_per_query(luts[s:s + step], cand)
        if scale is not None:
            d = d.float() * scale[s:s + step, None]
        out[s:s + step] = d + rowterm[pos]
    return out


@no_tf32()
def budget_exact_xla(queries: torch.Tensor, vecs_aligned: torch.Tensor,
                     rownorm: torch.Tensor, tiles: torch.Tensor, *,
                     block_t: int) -> torch.Tensor:
    """Budgeted tile-gather exact scores → ``(B, P·block_t)`` shifted
    scores ``‖v‖² − 2·q·v`` (+inf on padding; add ‖q‖² back for squared
    L2). Queries and the gathered rows are float32 (a bf16 table widens
    exactly); ``vecs_aligned`` is ``(NA, D)`` with D ≥ the query width
    (zero-padded columns add nothing). The JAX package's plain twin of
    ``budget_exact_pallas``, in query chunks."""
    B, d = queries.shape
    q = queries.float()
    pt = tiles.shape[1] * block_t
    out = torch.empty(B, pt, dtype=torch.float32, device=queries.device)
    step = _query_chunk(pt * d)
    for s in range(0, B, step):
        pos = tile_positions(tiles[s:s + step], block_t)
        cand = vecs_aligned[pos.reshape(-1), :d].float().reshape(
            *pos.shape, d)
        qv = torch.bmm(cand, q[s:s + step, :, None])[..., 0]
        out[s:s + step] = rownorm[pos] - 2.0 * qv
    return out


def top_k_in(dists: torch.Tensor, target_ids: torch.Tensor,
             target_mask: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``(B, T)`` in-set distances → ``(B, k)`` (dists, global
    int64 ids): masked slots score +inf, and ids are −1 with +inf past the
    real targets (``pq_search_in``, freddy.c:1026-1174)."""
    tids = target_ids.long()
    d = torch.where(target_mask[None, :], dists,
                    torch.full_like(dists, float("inf")))
    k_eff = min(k, tids.shape[0])
    vals, pos = topk_ops.top_k_smallest(d, k_eff)
    ids = torch.where(torch.isfinite(vals), tids[pos],
                      torch.full_like(pos, -1))
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff),
                                       value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    return vals, ids


def adc_top_k_in(luts: torch.Tensor, codes: torch.Tensor,
                 target_ids: torch.Tensor, target_mask: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k restricted to a padded target id set → ``(B, k)`` (dists,
    global int64 ids); padding slots score +inf and surface as id −1 only
    when fewer than k real targets exist (``pq_search_in``,
    freddy.c:1026-1174)."""
    d = adc_distances(luts, codes[torch.clamp_min(target_ids.long(), 0)])
    return top_k_in(d, target_ids, target_mask, k)


def adc_top_k(luts: torch.Tensor, codes: torch.Tensor, k: int, *,
              chunk_size: int = 131072
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive ADC top-k over all n code rows → ``(B, k)`` (dists, ids).

    Parity: ``pq_search`` (freddy.c:26-170) — full-table ADC scan with a
    running top-k, batched over queries."""
    return topk_ops.chunked_top_k_smallest(
        lambda s: adc_distances(luts, codes[s:s + chunk_size]),
        codes.shape[0], chunk_size, k)


def post_verify(queries: torch.Tensor, cand_ids: torch.Tensor,
                cand_dists: torch.Tensor, vectors: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of ADC candidates → ``(B, k)`` (exact sqdists, ids).

    Gathers the ``(B, C)`` candidate rows' vectors and re-scores with exact
    squared L2 in float32. Invalid candidates (id < 0 or +inf ADC
    distance) stay +inf and come back as id −1.

    Parity: ``postverify`` (index_utils.c:477-498) and
    ``k_nearest_neighbour_pq_pv`` (freddy--0.0.1.sql:625-662)."""
    cv = vectors[torch.clamp_min(cand_ids.long(), 0)]          # (B, C, d)
    return rerank(queries, cand_ids, cand_dists, cv, k)


@no_tf32()
def rerank(queries: torch.Tensor, cand_ids: torch.Tensor,
           cand_dists: torch.Tensor, cand_vecs: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`post_verify` over candidate rows already gathered,
    ``cand_vecs`` (B, C, d) — the sharded post-verify assembles them from
    the shards that own them."""
    q = queries.float()                                        # (B, d)
    ids = cand_ids.long()
    cv = cand_vecs.float()
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    cc = torch.sum(cv * cv, dim=-1)
    qc = torch.bmm(cv, q.unsqueeze(-1)).squeeze(-1)
    d = torch.clamp_min(qq - 2.0 * qc + cc, 0.0)
    valid = (ids >= 0) & torch.isfinite(cand_dists)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    vals, pos = topk_ops.top_k_smallest(d, min(k, ids.shape[-1]))
    out = torch.gather(ids, -1, pos)
    return vals, torch.where(torch.isfinite(vals), out,
                             torch.full_like(out, -1))
