"""IVPQ — inverted multi-index PQ for batched kNN-joins.

Counterpart of ``postgres_word2vec_tpu/models/ivpq.py``. Parity targets:
the build script ivpq.py (product coarse quantizer over ``positions``
vector parts, cell id ``Σ cᵢ·k_cⁱ``; fine PQ codebook over the raw vectors;
defaults from ivpq_config.json: m=30, k=32, k_coarse=32), the join kernel
``ivpq_search_in`` (ivpq_search_in.c:21-721) with its tuning surface —
``alpha``, ``pvf``, ``method`` ∈ {0: ADC, 1: exact, 2: ADC + post-verify},
``confidence``, ``use_targetlists``, ``long_codes_threshold`` (fused-pair
LUTs) — and statistics-driven adaptive probing with the hypergeometric
confidence model (index_utils.c:252-443, 673-682).

Each query sorts all cell distances, the confidence rule picks a probe
prefix, and the join runs one of two rounds:

- **budget** (default on the card): the target set laid out cell-aligned
  in whole tiles (:class:`JoinTiles`), each query scanning only its
  selected cells' tiles through the budget kernels (K6/K7 ADC, K9/K10
  exact; ``ops/kernels.py``);
- **dense** (default on the CPU): every target scored, then masked to the
  selected cells — a plain gather of the selection mask by cell (the JAX
  package's one-hot matmul exists only because TPU gathers serialize);
  ADC through K2 on the card.

Alpha escalation (``alpha += alpha`` until every query has k results,
ivpq_search_in.c:639-684) is a host loop over rounds with per-query
retirement. The tiles carry target positions, mapped to global store ids
at the end; methods 1 and 2 read raw rows from the store table by global
id, so no gathered copy of the target vectors is kept — or, for a handle
prepared with ``vecs_pregathered=True``, from the caller's ``(T, d)``
target matrix by position. Unprepared calls keep their tile layouts in a
small LRU cache per index (:data:`IVPQIndex._JOIN_CACHE_CAP` target sets).
``lut_dtype="int8"`` runs the budget round's grouped ADC over int8 LUTs
(K8). ``add`` is the online insert: multi-index assignment and the
running-mean fine-codebook update.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from postgres_word2vec_tpu_torch.models.ivfadc import plan_probe_tiles
from postgres_word2vec_tpu_torch.models.join_graphs import RoundGraphs
from postgres_word2vec_tpu_torch.models.pq import (PQCodebook, _sample_rows,
                                                   online_codebook_update)
from postgres_word2vec_tpu_torch.ops import adc, kernels, kmeans, lut
from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32
from postgres_word2vec_tpu_torch.utils.tracker import host

# Distance-phase method flags (parity: index_utils.h:103).
PQ_CALC = 0
EXACT_CALC = 1
PQ_PV_CALC = 2

#: Queries per block of one budget round. The JAX package needs it for a
#: TPU scalar-memory limit; the port keeps it so the grouped-vs-per-query
#: decision falls as in the JAX package at the same shapes.
_BUDGET_SCAN_BLOCK = 512


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device; a Python number
    is filled there rather than copied from the host, which a captured
    graph cannot do."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def confidence_hyp(expect, size, p, stat_size) -> torch.Tensor:
    """P[#targets in the probed cells ≥ expect] — normal approximation of
    the hypergeometric tail with its finite-population correction
    (``getConfidenceHyp``, index_utils.c:673-682)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    expect, size, stat_size = (_f32(x, p) for x in (expect, size, stat_size))
    mu = size * p
    fpc = (stat_size - size) / torch.clamp_min(stat_size - 1.0, 1.0)
    sig = torch.sqrt(torch.clamp_min(size * p * (1.0 - p), 0.0)) * fpc
    num = expect - 0.5 - mu
    z = num / torch.clamp_min(sig, 1e-30) / math.sqrt(2.0)
    conf = 1.0 - 0.5 * (1.0 + torch.special.erf(z))
    # degenerate spread: the tail is a step function at mu.
    conf = torch.where(sig <= 0.0, (num <= 0.0).float(), conf)
    return torch.where(expect > size, 0.0, conf)


def confidence_bin(expect, size, p) -> torch.Tensor:
    """Binomial-tail variant without the finite-population correction
    (``getConfidenceBin``, index_utils.c:667-671)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    expect, size = _f32(expect, p), _f32(size, p)
    mu = size * p
    sig = torch.sqrt(torch.clamp_min(size * p * (1.0 - p), 0.0))
    num = expect - 0.5 - mu
    z = num / torch.clamp_min(sig, 1e-30) / math.sqrt(2.0)
    conf = 1.0 - 0.5 * (1.0 + torch.special.erf(z))
    return torch.where(sig <= 0.0, (num <= 0.0).float(), conf)


class MultiIndexQuantizer(NamedTuple):
    """Product coarse quantizer → k_c^positions virtual cells
    (``coarse_quantization_ivpq`` + ``_counts`` tables)."""
    centroids: torch.Tensor    # (positions, k_c, d/positions) float32
    cell_counts: torch.Tensor  # (k_c**positions,) int32

    @property
    def num_cells(self) -> int:
        p, kc, _ = self.centroids.shape
        return int(kc) ** int(p)


@no_tf32()
def assign_cells(vectors: torch.Tensor, coarse_centroids: torch.Tensor, *,
                 chunk_size: int = 262144) -> torch.Tensor:
    """Multi-index coarse assignment: per-position argmin → combined cell
    id ``Σ cᵢ·k_cⁱ`` (``combine_centroids``, ivpq.py:18), int64, chunked
    over rows."""
    p, kc, dsub = coarse_centroids.shape
    cb = coarse_centroids.float()
    cc = torch.sum(cb * cb, dim=-1)                        # (p, kc)
    out = torch.empty(vectors.shape[0], dtype=torch.int64,
                      device=vectors.device)
    for s in range(0, vectors.shape[0], chunk_size):
        xf = vectors[s:s + chunk_size].float()
        cell = torch.zeros(xf.shape[0], dtype=torch.int64, device=xf.device)
        for i in range(p):
            sc = xf[:, i * dsub:(i + 1) * dsub] @ cb[i].t()
            cell += torch.argmin(cc[i][None] - 2.0 * sc, dim=-1) * kc ** i
        out[s:s + chunk_size] = cell
    return out


def cell_distances(queries: torch.Tensor, coarse_centroids: torch.Tensor
                   ) -> torch.Tensor:
    """All-cell squared distances ``(B, d) → (B, k_c**positions)``, in
    :func:`assign_cells`'s combination order: per-position LUTs and one
    broadcast add per further position (the reference walks a
    Multi-Sequence queue, index_utils.c:322-395)."""
    p, kc, _ = coarse_centroids.shape
    subd = lut.build_luts(queries, coarse_centroids)       # (B, p, kc)
    total = subd[:, 0, :]
    for i in range(1, p):
        # new flat index = old + c_i·kc^i: the new axis goes on the left.
        total = (subd[:, i, :, None] + total[:, None, :]).reshape(
            total.shape[0], kc ** (i + 1))
    return total


def build_statistics(cell_assignments: torch.Tensor,
                     domain_ids: torch.Tensor, num_cells: int
                     ) -> torch.Tensor:
    """Per-cell relative frequency of a word domain + its absolute size →
    ``(num_cells + 1,)`` float32, the layout the reference reads
    (index_utils.c:632-665; SQL ``create_statistics``, sql:150-171)."""
    cells = cell_assignments[domain_ids.long()].long()
    counts = torch.bincount(cells, minlength=num_cells).float()
    total = torch.clamp_min(counts.sum(), 1.0)
    return torch.cat([counts / total, total[None]])


def uniform_statistics(cell_counts: torch.Tensor) -> torch.Tensor:
    """Statistics from the full table's cell occupancy, used when no domain
    table is active."""
    c = cell_counts.float()
    total = torch.clamp_min(c.sum(), 1.0)
    return torch.cat([c / total, total[None]])


def _select_cells(queries: torch.Tensor, coarse_centroids: torch.Tensor,
                  statistics: torch.Tensor, cell_counts: torch.Tensor,
                  t_real: torch.Tensor, k: int, alpha: int,
                  confidence: float) -> tuple[torch.Tensor, ...]:
    """Statistics-driven adaptive cell selection, vectorized over queries
    (index_utils.c:252-443) → (order (B, C) cells by distance, n_sel (B,)
    probe prefix length, exhausted (B,), predicted (B,) statistics-model
    target count, retrieved_sel (B,) true target rows in the prefix).

    The probe prefix is the first one whose confidence reaches
    ``confidence``, extended until it holds ≥ min(k, T) real targets (the
    JAX package's coverage floor, from the known per-cell counts)."""
    num_cells = statistics.shape[0] - 1
    order = torch.argsort(cell_distances(queries, coarse_centroids), dim=-1,
                          stable=True)
    cum_p = torch.cumsum(statistics[:num_cells][order], dim=-1)
    t_f = t_real.float()
    conf = confidence_hyp(float(k * alpha), t_f, cum_p,
                          statistics[num_cells])
    satisfied = conf >= confidence
    first = torch.argmax(satisfied.to(torch.uint8), dim=-1) + 1
    n_sel = torch.where(satisfied.any(-1), first, num_cells)
    cum_counts = torch.cumsum(cell_counts.float()[order], dim=-1)
    covered = cum_counts >= torch.clamp_max(t_f, float(k))
    k_first = torch.argmax(covered.to(torch.uint8), dim=-1) + 1
    n_sel = torch.maximum(n_sel, torch.where(covered.any(-1), k_first,
                                             num_cells))
    last = (n_sel - 1)[:, None]
    predicted = torch.gather(cum_p, 1, last)[:, 0] * t_f
    retrieved_sel = torch.gather(cum_counts, 1, last)[:, 0]
    return order, n_sel, n_sel >= num_cells, predicted, retrieved_sel


def _dense_adc(luts: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """Dense ADC over ``(m, n)`` codes: K2 on the card, the plain gather on
    the CPU."""
    if codes_t.is_cuda:
        return kernels.adc_scan(luts, codes_t)
    return adc.adc_distances(luts, codes_t.t())


def _finish(dists: torch.Tensor, pos_of, target_ids: torch.Tensor,
            queries: torch.Tensor, vectors: torch.Tensor | None,
            pregathered: bool, k: int, pvf: int, method: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a round's (B, W) candidate distances → (vals, global int64
    ids, −1 past the candidates). ``pos_of(cols)`` maps candidate columns
    to target positions (−1 on padding). Method 2 takes k·pvf by ADC and
    re-ranks them exactly against ``vectors``: the store table by global
    id, or a ``pregathered`` (T, d) target matrix by position."""
    tids = target_ids.long()

    def ids_of(p):
        return torch.where(p >= 0, tids[torch.clamp_min(p, 0)], -1)

    if method == PQ_PV_CALC:
        cvals, cpos = topk_ops.top_k_smallest(dists,
                                              min(k * pvf, dists.shape[1]))
        p = torch.where(torch.isfinite(cvals), pos_of(cpos), -1)
        vals, rows = adc.post_verify(queries, p if pregathered else ids_of(p),
                                     cvals, vectors, k)
        return vals, ids_of(rows) if pregathered else rows
    k_eff = min(k, dists.shape[1])
    vals, pos = topk_ops.top_k_smallest(dists, k_eff)
    ids = torch.where(torch.isfinite(vals), ids_of(pos_of(pos)), -1)
    if k_eff < k:
        vals = F.pad(vals, (0, k - k_eff), value=float("inf"))
        ids = F.pad(ids, (0, k - k_eff), value=-1)
    return vals, ids


@no_tf32()
def _ivpq_round(queries: torch.Tensor, coarse_centroids: torch.Tensor,
                codebook_cent: torch.Tensor, codes_t: torch.Tensor | None,
                target_cells: torch.Tensor, target_ids: torch.Tensor,
                target_mask: torch.Tensor, statistics: torch.Tensor,
                vectors: torch.Tensor | None, k: int, alpha: int, pvf: int,
                method: int, confidence: float, use_double: bool,
                pregathered: bool,
                t_real_override: torch.Tensor | None = None,
                cell_counts_override: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ...]:
    """One dense probe round: every target scored, masked to each query's
    selected cells → (sqdists (B, k), global ids (B, k), retrieved (B,)
    real candidates, exhausted (B,) probed every cell, predicted (B,)).
    ``codes_t`` is the (m, T) target code table, fused-pair codes when
    ``use_double`` (:meth:`PreparedJoin.codes_t`); the exact method reads
    ``vectors`` instead, by global id or, ``pregathered``, by position.
    The overrides give the cell selection the whole target set's count and
    per-cell counts where these targets are one shard of it
    (``parallel/sharding.py``); None counts these targets."""
    B = queries.shape[0]
    num_cells = statistics.shape[0] - 1
    cells = target_cells.long()
    cell_counts = cell_counts_override
    if cell_counts is None:
        cell_counts = torch.zeros(num_cells,
                                  device=queries.device).index_add_(
            0, cells, target_mask.float())
    t_real = target_mask.sum() if t_real_override is None \
        else t_real_override
    order, n_sel, exhausted, predicted, _ = _select_cells(
        queries, coarse_centroids, statistics, cell_counts, t_real, k,
        alpha, confidence)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(num_cells, device=order.device).expand_as(
            order))
    sel_cell = ranks < n_sel[:, None]
    cand = torch.gather(sel_cell, 1, cells.expand(B, -1)) & target_mask
    retrieved = cand.sum(-1)

    if method == EXACT_CALC:
        q = queries.float()
        tv = (vectors if pregathered
              else vectors[torch.clamp_min(target_ids.long(), 0)]).float()
        dists = torch.clamp_min(
            torch.sum(q * q, -1, keepdim=True) - 2.0 * (q @ tv.t())
            + torch.sum(tv * tv, -1)[None], 0.0)
    else:
        luts = lut.build_luts(queries, codebook_cent)
        if use_double:
            # "short codes": fused-pair LUTs (ivpq_search_in.c:262-291).
            luts = lut.build_double_luts(luts)
        dists = _dense_adc(luts, codes_t)
    dists = torch.where(cand, dists, float("inf"))
    vals, ids = _finish(dists, lambda pos: pos, target_ids, queries, vectors,
                        pregathered, k, pvf, method)
    return vals, ids, retrieved, exhausted, predicted


class JoinTiles(NamedTuple):
    """Cell-aligned tiling of a kNN-join's target set: every round scans
    only the tiles of each query's selected cells, the fetched-rows-only
    semantics of ``ivpq_search_in``'s SPI query (ivpq_search_in.c:355-401,
    459-543). NA is the JAX package's static bound ``roundup(T) +
    (C+1)·block_t``; the last tile is the inf tile."""
    block_t: int
    codes_t: torch.Tensor      # (m, NA) aligned codes, storage dtype
    rowterm: torch.Tensor      # (NA,) float32: 0 on real rows, +inf padding
    local_ids: torch.Tensor    # (NA,) int64 target positions, −1 padding
    tile_start: torch.Tensor   # (C,) int64
    tile_cnt: torch.Tensor     # (C,) int64
    tile_rows: torch.Tensor    # (NT,) int64 real rows per tile
    cell_sizes: torch.Tensor   # (C,) float32 target rows per cell
    t_real: torch.Tensor       # () number of real targets
    vecs: torch.Tensor | None  # (NA, D) bf16 aligned rows (method 1 only)
    rownorm: torch.Tensor      # (NA,) float32 ‖v‖², +inf padding
    inf_tile: int
    cache: dict                # fused-pair codes_t by codebook size

    def fused_codes_t(self, k: int) -> torch.Tensor:
        """``codes_t`` as fused-pair codes over a ``k``-centroid codebook
        (int16 while k² fits), built once."""
        if k not in self.cache:
            fused = lut.fuse_codes(self.codes_t.t(), k)
            self.cache[k] = fused.t().contiguous()
        return self.cache[k]


def build_join_tiles(target_codes: torch.Tensor, target_cells: torch.Tensor,
                     target_mask: torch.Tensor,
                     vec_rows: torch.Tensor | None,
                     vectors: torch.Tensor | None, *, block_t: int,
                     num_cells: int, with_vecs: bool,
                     chunk_rows: int = 262144) -> JoinTiles:
    """Sort the targets by coarse cell and lay them out cell-aligned in
    whole ``block_t`` tiles. ``with_vecs`` also lays out the raw rows
    (``vectors[vec_rows]``, bf16, D = d rounded up to 8) with float32
    norms for the exact method, gathered in row chunks; ``vec_rows`` None
    reads row t for target t (a pregathered matrix)."""
    T, m = target_codes.shape
    bt = block_t
    dev = target_codes.device
    na = -(-T // bt) * bt + (num_cells + 1) * bt
    nt = na // bt
    cells_s = torch.where(target_mask, target_cells.long(), num_cells)
    sorted_cells, order = torch.sort(cells_s, stable=True)
    counts = torch.bincount(cells_s, minlength=num_cells + 1)
    sizes = counts[:num_cells]
    tile_cnt = -(-sizes // bt)
    tile_start = torch.cumsum(tile_cnt, 0) - tile_cnt
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T, device=dev) - offsets[sorted_cells]
    valid_s = sorted_cells < num_cells
    apos = torch.where(
        valid_s,
        tile_start[torch.clamp_max(sorted_cells, num_cells - 1)] * bt + rank,
        na - 1)

    codes_t = torch.zeros(m, na, dtype=target_codes.dtype, device=dev)
    codes_t[:, apos] = target_codes[order].t()
    rowterm = torch.full((na,), float("inf"), device=dev)
    rowterm[apos] = torch.where(valid_s, 0.0, float("inf"))
    local_ids = torch.full((na,), -1, dtype=torch.int64, device=dev)
    local_ids[apos] = torch.where(valid_s, order, -1)
    tile_rows = torch.zeros(nt, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(valid_s, apos // bt, nt - 1), valid_s.long())

    vecs = None
    rownorm = torch.full((na,), float("inf"), device=dev)
    if with_vecs:
        d = vectors.shape[1]
        vecs = torch.zeros(na, -(-d // 8) * 8, dtype=torch.bfloat16,
                           device=dev)
        for s in range(0, T, chunk_rows):
            keep = valid_s[s:s + chunk_rows]
            rows = apos[s:s + chunk_rows][keep]
            src = order[s:s + chunk_rows][keep]
            if vec_rows is not None:
                src = vec_rows[src].long()
            vf = vectors[src].float()
            vecs[rows, :d] = vf.to(torch.bfloat16)
            rownorm[rows] = torch.sum(vf * vf, dim=-1)
    return JoinTiles(
        block_t=bt, codes_t=codes_t, rowterm=rowterm, local_ids=local_ids,
        tile_start=tile_start, tile_cnt=tile_cnt, tile_rows=tile_rows,
        cell_sizes=sizes.float(), t_real=target_mask.sum(), vecs=vecs,
        rownorm=rownorm, inf_tile=nt - 1, cache={})


def select_tiles(queries: torch.Tensor, coarse_centroids: torch.Tensor,
                 statistics: torch.Tensor, jt: JoinTiles, k: int, alpha: int,
                 confidence: float,
                 t_real_override: torch.Tensor | None = None,
                 cell_counts_override: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """Each query's selected cells as runs of tiles, in probe order →
    (start (B, C) first tile of each cell, cnt (B, C) its tiles, 0 past
    the selection, exhausted (B,), predicted (B,), retrieved_sel (B,)), as
    :func:`_select_cells` defines them; the overrides as in
    :func:`_ivpq_round`. ``cnt.sum(1)`` is the tiles a query needs."""
    num_cells = statistics.shape[0] - 1
    order, n_sel, exhausted, predicted, retrieved_sel = _select_cells(
        queries, coarse_centroids, statistics,
        jt.cell_sizes if cell_counts_override is None
        else cell_counts_override,
        jt.t_real if t_real_override is None else t_real_override, k,
        alpha, confidence)
    rank_lt = (torch.arange(num_cells, device=queries.device)[None, :]
               < n_sel[:, None])
    return (jt.tile_start[order], torch.where(rank_lt, jt.tile_cnt[order], 0),
            exhausted, predicted, retrieved_sel)


def budget_need(counts: list[torch.Tensor]) -> torch.Tensor:
    """The most tiles any query's selected cells take (the ``cnt`` of
    :func:`select_tiles`, over every block in ``counts``), on the device."""
    return torch.stack([c.sum(1).max() for c in counts]).max()


def fit_need(need: torch.Tensor, cap: int) -> int:
    """Tile slots a budget round plans for each query from
    :func:`budget_need` (one host read): in sixteens, at most ``cap``.
    Unlike the JAX package's power of two for the expected k·alpha rows, no
    query's cells are cut short (ivpq_search_in.c:355-401 fetches every
    selected cell)."""
    n = int(host(need))
    return max(1, min(-(-n // 16) * 16, cap))


def fit_budget(counts: list[torch.Tensor], cap: int) -> int:
    """:func:`fit_need` of the selections' tile counts ``counts``."""
    return fit_need(budget_need(counts), cap)


def _ivpq_round_budget(queries: torch.Tensor, codebook_cent: torch.Tensor,
                       jt: JoinTiles, vectors: torch.Tensor | None,
                       selection: tuple, k: int, pvf: int, method: int,
                       use_double: bool, p_budget: int, lut_dtype: str,
                       target_ids: torch.Tensor, pregathered: bool
                       ) -> tuple[torch.Tensor, ...]:
    """One selectivity-proportional round: each query scans the tiles of
    its selected cells (``selection``, its :func:`select_tiles`), at most
    ``p_budget`` of them. Same return contract as :func:`_ivpq_round`
    (``target_ids`` maps target positions to global ids); ``retrieved``
    counts rows actually scanned, so a query cut short by the budget is
    never wrongly retired."""
    bt = jt.block_t
    start, cnt, exhausted, predicted, retrieved_sel = selection
    tiles, _ = plan_probe_tiles(p_budget, start, cnt, jt.inf_tile)

    if method == EXACT_CALC:
        qf = queries.float()
        d = kernels.budget_exact_auto(queries, jt.vecs, jt.rownorm, tiles,
                                      block_t=bt)
        dists = torch.clamp_min(d + torch.sum(qf * qf, -1, keepdim=True),
                                0.0)
    else:
        luts = lut.build_luts(queries, codebook_cent)
        codes_t = jt.codes_t
        if use_double:
            codes_t = jt.fused_codes_t(codebook_cent.shape[1])
            luts = lut.build_double_luts(luts)
        dists = kernels.budget_adc_auto(luts, codes_t, jt.rowterm, tiles,
                                        block_t=bt, lut_dtype=lut_dtype)

    found = torch.sum(jt.tile_rows[tiles.long()], dim=1)
    exhausted = exhausted & (found.float() >= retrieved_sel)
    gpos = adc.tile_positions(tiles, bt)
    vals, ids = _finish(
        dists, lambda pos: jt.local_ids[torch.gather(gpos, 1, pos)],
        target_ids, queries, vectors, pregathered, k, pvf, method)
    return vals, ids, found, exhausted, predicted


@dataclasses.dataclass
class PreparedJoin:
    """Reusable target-set handle for repeated kNN-joins (the reference's
    statistics-table serving pattern, sql:150-171): the target code and
    cell gathers, and lazily each tile layout, are paid once.
    ``vectors`` is the store table the target ids index, or with
    ``vecs_pregathered`` the ``(T, d)`` target rows in target order, aliased
    (methods 1 and 2 read raw rows from it); ``tiles(with_vecs=True)`` lays
    those rows out for the exact method."""

    target_ids: torch.Tensor            # (T,) int64 global ids
    target_mask: torch.Tensor           # (T,) bool
    target_codes: torch.Tensor          # (T, m) storage dtype
    target_cells: torch.Tensor          # (T,) int64
    vectors: torch.Tensor | None        # (N, d) store table, (T, d), None
    num_cells: int
    block_t: int
    build_s: float                      # host seconds spent preparing
    vecs_pregathered: bool = False      # vectors row t is target t
    _tiles: dict = dataclasses.field(default_factory=dict, repr=False)
    _codes_t: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return int(self.target_ids.shape[0])

    def tiles(self, with_vecs: bool) -> JoinTiles:
        jt = self._tiles.get(bool(with_vecs))
        if jt is None:
            if with_vecs and self.vectors is None:
                raise ValueError("prepare_join was called without vectors — "
                                 "method=1 (exact distances) needs raw rows")
            jt = build_join_tiles(self.target_codes, self.target_cells,
                                  self.target_mask,
                                  None if self.vecs_pregathered
                                  else self.target_ids,
                                  self.vectors, block_t=self.block_t,
                                  num_cells=self.num_cells,
                                  with_vecs=bool(with_vecs))
            self._tiles[bool(with_vecs)] = jt
        return jt

    def codes_t(self, fused_k: int | None = None) -> torch.Tensor:
        """The (m, T) target codes the dense round scans, contiguous (K2's
        layout), fused-pair codes over a ``fused_k``-centroid codebook when
        given; built once per form."""
        ct = self._codes_t.get(fused_k)
        if ct is None:
            codes = self.target_codes
            if fused_k is not None:
                codes = lut.fuse_codes(codes, fused_k)
            ct = self._codes_t[fused_k] = codes.t().contiguous()
        return ct


@dataclasses.dataclass
class _JoinCall:
    """The settings of one ``search_join`` call that every round shares."""
    prepared: PreparedJoin
    jt: JoinTiles | None        # None: dense rounds
    statistics: torch.Tensor
    k: int
    pvf: int
    method: int
    confidence: float
    long_codes_threshold: float
    budget_tiles: int | None
    lut_dtype: str
    #: a round so far has scanned fused-pair ("short") codes
    short_codes: bool = False
    #: candidate slots scored so far, summed over queries and rounds
    scan_slots: int = 0
    #: query chunks whose first round replayed its graphs
    graph_rounds: int = 0


def _merge_round(best, new, resolved: torch.Tensor, k: int):
    """Fold an escalation round into the running best: queries already
    resolved keep their earlier results (ivpq_search_in.c:639-684).
    ``best``/``new`` are (vals, ids, retrieved, predicted); ``new`` also
    carries exhausted. → (best, resolved, done)."""
    vals, ids, retrieved, exhausted, predicted = new
    upd = ~resolved
    bv = torch.where(upd[:, None], vals, best[0])
    bi = torch.where(upd[:, None], ids, best[1])
    br = torch.where(upd, retrieved, best[2])
    bp = torch.where(upd, predicted, best[3])
    resolved = resolved | (retrieved >= k)
    return ((bv, bi, br, bp), resolved,
            bool(host(torch.all(resolved | exhausted))))


@dataclasses.dataclass
class IVPQIndex:
    """Multi-index PQ join index on one device."""

    coarse: MultiIndexQuantizer
    codebook: PQCodebook        # (m, k, dsub) over raw vectors
    codes: torch.Tensor         # (n, m) uint8, original row order
    cell_of: torch.Tensor       # (n,) int64 coarse cell per row

    #: Tile layouts of unprepared ``search_join`` calls, LRU, keyed by
    #: :meth:`_join_tiles_key`. ``add`` returns a new index, so an insert
    #: starts an empty cache.
    _join_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)
    _JOIN_CACHE_CAP = 4
    #: Captured first budget rounds (:meth:`_graph_round`); a new index
    #: starts with none.
    _round_graphs: RoundGraphs = dataclasses.field(
        default_factory=RoundGraphs, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_cells(self) -> int:
        return self.coarse.num_cells

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, generator: torch.Generator, vectors: torch.Tensor, *,
              m: int = 30, k: int = 32, k_coarse: int = 32,
              coarse_positions: int = 2, train_size: int | None = 100_000,
              iters: int = 10, restarts: int = 1,
              init: str = "sample") -> "IVPQIndex":
        """Multi-index coarse quantizer + raw-vector PQ codebook + codes
        (``create_index_data`` parity, ivpq.py)."""
        train = _sample_rows(generator, vectors, train_size)
        cres = kmeans.kmeans_subspaces(
            generator, kmeans.split_subspaces(train, coarse_positions),
            k_coarse, iters, restarts=restarts, init=init)
        cell_of = assign_cells(vectors, cres.centroids)
        cell_counts = torch.bincount(
            cell_of, minlength=k_coarse ** coarse_positions).to(torch.int32)
        fres = kmeans.kmeans_subspaces(
            generator, kmeans.split_subspaces(train, m), k, iters,
            restarts=restarts, init=init)
        codes = kmeans.encode_subspaces(vectors, fres.centroids)
        return cls(MultiIndexQuantizer(cres.centroids, cell_counts),
                   PQCodebook(fres.centroids, fres.counts), codes, cell_of)

    # ------------------------------------------------------------- search
    def prepare_join(self, target_ids, *,
                     target_mask: torch.Tensor | None = None,
                     vectors: torch.Tensor | None = None,
                     block_t: int | None = None,
                     with_tiles: bool = True,
                     vecs_pregathered: bool = False) -> PreparedJoin:
        """A :class:`PreparedJoin` for a target set: the code and cell
        gathers, and (``with_tiles``) the ADC tile layout, paid once.
        ``vectors`` is the store table (needed by methods 1 and 2).
        ``vecs_pregathered=True`` declares ``vectors`` to be the ``(T, d)``
        target rows already, aligned with ``target_ids`` (the whole store
        when the targets are every row in order): the handle aliases it and
        reads it by target position (JAX ivpq.py:778-831).
        ``block_t`` defaults to 256 from 50k targets up, else 128."""
        dev = self.codes.device
        tids = torch.as_tensor(target_ids, device=dev).long()
        if vecs_pregathered and (vectors is None
                                 or vectors.shape[0] != tids.shape[0]):
            raise ValueError("vecs_pregathered=True needs vectors with one "
                             "row per target id")
        if target_mask is None:
            target_mask = torch.ones(tids.shape, dtype=torch.bool, device=dev)
        bt = block_t or (256 if tids.shape[0] >= 50_000 else 128)
        t0 = time.perf_counter()
        safe = torch.clamp_min(tids, 0)
        ph = PreparedJoin(target_ids=tids, target_mask=target_mask.to(dev),
                          target_codes=self.codes[safe],
                          target_cells=self.cell_of[safe].long(),
                          vectors=vectors, num_cells=self.num_cells,
                          block_t=bt, build_s=0.0,
                          vecs_pregathered=vecs_pregathered)
        if with_tiles:
            ph.tiles(with_vecs=False).t_real.item()     # wait for the build
        ph.build_s = time.perf_counter() - t0
        return ph

    def search_join(self, queries: torch.Tensor, k: int, target_ids=None, *,
                    prepared: PreparedJoin | None = None,
                    target_mask: torch.Tensor | None = None,
                    vectors: torch.Tensor | None = None,
                    statistics: torch.Tensor | None = None,
                    alpha: int = 3, pvf: int = 20, method: int = PQ_CALC,
                    confidence: float = 0.8,
                    long_codes_threshold: float = 1e7,
                    use_targetlists: bool = True, max_rounds: int = 8,
                    query_chunk: int | None = None, impl: str | None = None,
                    budget_tiles: int | None = None,
                    lut_dtype: str = "bf16", return_info: bool = False):
        """Batched kNN-join (``ivpq_search_in`` parity) → (sqdists, global
        ids), −1 past the targets found.

        ``prepared``: a :meth:`prepare_join` handle (its targets and
        vectors are used); otherwise ``target_ids``/``target_mask``/
        ``vectors`` are prepared for this call, and the budget round's tile
        layout comes from the index's LRU cache when this target set was
        tiled before (a hit reports ``data_retrieval_s`` 0, as in the JAX
        package). ``impl``: "budget" (the
        tiled probe; default on the card), "dense" (all targets, masked;
        default on the CPU), or None; ``use_targetlists=False`` forces
        "dense". ``query_chunk`` queries per host chunk (default 8192
        budget, 1024 dense). ``lut_dtype="int8"`` quantizes the budget
        round's ADC LUTs per query where the grouped kernel is chosen (K8
        on the card, its plain version on the CPU); where the per-query
        kernel is chosen it warns and keeps float32 LUTs, and the dense
        round ignores it — all as in the JAX package. ``return_info`` adds
        a dict: per-query ``retrieved`` and ``target_count``, ``rounds``,
        ``final_alpha``, ``data_retrieval_s``, ``short_codes`` (some round
        scanned fused-pair codes), ``scan_slots`` (candidate slots a
        query, summed over its rounds: a budget round's P·block_t, padding
        included, a dense round's T) and ``graph_rounds`` (the share of
        query chunks whose first round replayed its captured graphs,
        :meth:`_graph_round`). Its device → host reads go through
        :func:`.tracker.host`, which counts them."""
        if lut_dtype not in ("bf16", "int8"):
            raise ValueError(f"lut_dtype must be 'bf16' or 'int8', "
                             f"got {lut_dtype!r}")
        data_retrieval_s = 0.0
        adhoc = prepared is None
        if adhoc:
            if target_ids is None:
                raise ValueError("search_join needs target_ids or prepared=")
            prepared = self.prepare_join(target_ids, target_mask=target_mask,
                                         vectors=vectors, with_tiles=False)
        if method in (EXACT_CALC, PQ_PV_CALC) and prepared.vectors is None:
            raise ValueError("methods 1/2 need raw vectors for exact "
                             "distances")
        if statistics is None:
            statistics = uniform_statistics(self.coarse.cell_counts)
        if impl is None:
            impl = "budget" if queries.is_cuda else "dense"
        if not use_targetlists:
            impl = "dense"
        if impl not in ("budget", "dense"):
            raise ValueError(f"impl must be budget|dense, got {impl!r}")
        if impl != "budget":
            lut_dtype = "bf16"
        if query_chunk is None:
            query_chunk = 8192 if impl == "budget" else 1024
        jt = None
        if impl == "budget" and adhoc:
            jt, data_retrieval_s = self._cached_tiles(prepared,
                                                      method == EXACT_CALC)
        elif impl == "budget":
            t0 = time.perf_counter()
            built = (method == EXACT_CALC) not in prepared._tiles
            jt = prepared.tiles(with_vecs=method == EXACT_CALC)
            if built:
                host(jt.t_real).item()
                data_retrieval_s = time.perf_counter() - t0
        call = _JoinCall(prepared, jt, statistics.to(queries.device), k, pvf,
                         method, float(confidence),
                         float(long_codes_threshold), budget_tiles,
                         lut_dtype)
        chunks = torch.split(queries, query_chunk)
        outs = [self._join_escalate(qc, self._join_round1(qc, call, alpha),
                                    call, alpha, max_rounds)
                for qc in chunks]
        vals = torch.cat([o[0] for o in outs])
        ids = torch.cat([o[1] for o in outs])
        if not return_info:
            return vals, ids
        info = {key: torch.cat([o[2][key] for o in outs])
                for key in ("retrieved", "target_count")}
        info.update(rounds=max(o[2]["rounds"] for o in outs),
                    final_alpha=max(o[2]["final_alpha"] for o in outs),
                    data_retrieval_s=data_retrieval_s,
                    short_codes=call.short_codes,
                    scan_slots=call.scan_slots / max(queries.shape[0], 1),
                    graph_rounds=call.graph_rounds / max(len(chunks), 1))
        return vals, ids, info

    @staticmethod
    def _join_tiles_key(target_ids: torch.Tensor, target_mask: torch.Tensor,
                        block_t: int, with_vecs: bool,
                        vectors: torch.Tensor | None) -> tuple:
        """Cache key of an unprepared call's tile layout: a content digest
        of the target set (one host copy of T ids and T mask bytes) and
        the layout parameters (JAX ivpq.py:1049-1064). Layouts with raw
        rows also key on the table: its identity, version counter, storage
        and shape, since a torch tensor can change in place (an in-place
        write bumps ``_version``; a grown store is a new tensor)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(host(target_ids.detach()).numpy().tobytes())
        h.update(host(target_mask.detach()).numpy().tobytes())
        vec_key = None
        if with_vecs:
            vec_key = (id(vectors), vectors._version, vectors.data_ptr(),
                       tuple(vectors.shape))
        return h.hexdigest(), block_t, with_vecs, vec_key

    def _cached_tiles(self, prepared: PreparedJoin, with_vecs: bool
                      ) -> tuple[JoinTiles, float]:
        """An unprepared call's tile layout from the LRU cache, or built,
        timed and cached (evicting the least recently used of
        :data:`_JOIN_CACHE_CAP`) → (tiles, data-retrieval seconds, 0 on a
        hit). An entry pins its table, so the table's ``id`` cannot be
        reused while the entry lives."""
        key = self._join_tiles_key(prepared.target_ids, prepared.target_mask,
                                   prepared.block_t, with_vecs,
                                   prepared.vectors)
        hit = self._join_cache.pop(key, None)
        if hit is not None:
            self._join_cache[key] = hit           # most recently used last
            return hit[0], 0.0
        t0 = time.perf_counter()
        jt = prepared.tiles(with_vecs=with_vecs)
        host(jt.t_real).item()                    # wait for the build
        seconds = time.perf_counter() - t0
        if len(self._join_cache) >= self._JOIN_CACHE_CAP:
            self._join_cache.pop(next(iter(self._join_cache)))
        self._join_cache[key] = (jt, prepared.vectors if with_vecs else None)
        return jt, seconds

    def _join_round1(self, queries: torch.Tensor, call: _JoinCall,
                     alpha: int) -> dict:
        """The first probe round of the alpha-escalation loop. A budget
        round fitted to its selections (:meth:`_run_round`) scans every
        selected cell, which hold min(k, T) targets or more (the coverage
        floor of :func:`_select_cells`), so no round can add a candidate
        and the done check is not read."""
        vals, ids, retrieved, exhausted, predicted = self._run_round(
            queries, call, int(alpha), first=True)
        resolved = retrieved >= call.k
        whole = call.jt is not None and call.budget_tiles is None
        return dict(best=(vals, ids, retrieved, predicted),
                    resolved=resolved,
                    done=whole or bool(host(torch.all(resolved
                                                      | exhausted))))

    def _join_escalate(self, queries: torch.Tensor, state: dict,
                       call: _JoinCall, alpha: int, max_rounds: int):
        """Alpha escalation (ivpq_search_in.c:639-684) from a
        :meth:`_join_round1` state: while some query has fewer than k
        candidates and has cells left, rerun at ``alpha += alpha`` and keep
        each query's first resolved round."""
        best, resolved, done = state["best"], state["resolved"], state["done"]
        cur_alpha, rounds = int(alpha), 1
        for _ in range(max_rounds - 1):
            if done:
                break
            cur_alpha += cur_alpha
            best, resolved, done = _merge_round(
                best, self._run_round(queries, call, cur_alpha), resolved,
                call.k)
            rounds += 1
        info = {"retrieved": best[2], "target_count": best[3],
                "rounds": rounds, "final_alpha": cur_alpha}
        return best[0], best[1], info

    def _budget_for(self, jt: JoinTiles, budget_tiles: int | None,
                    need) -> int:
        """Tile budget for one round: ``budget_tiles`` where given, else
        :func:`fit_need` of ``need()``, the selections' :func:`budget_need`
        (made only where it is read)."""
        cap = max(int(jt.codes_t.shape[1]) // jt.block_t - 1, 1)
        if budget_tiles is not None:
            return max(1, min(budget_tiles, cap))
        return fit_need(need(), cap)

    def _run_round(self, queries: torch.Tensor, call: _JoinCall,
                   alpha: int, first: bool = False
                   ) -> tuple[torch.Tensor, ...]:
        """One probe round over a query chunk → (vals, global ids,
        retrieved, exhausted, predicted): the JAX package's
        ``_dense_round_program`` or ``_budget_round_program``, the latter
        in blocks of :data:`_BUDGET_SCAN_BLOCK` queries. Without
        ``budget_tiles`` the budget round plans the tiles of the largest
        selection (:func:`fit_budget`). A ``first`` budget round on the
        card replays its captured graphs where it can
        (:meth:`_graph_round`)."""
        ph = call.prepared
        use_double = alpha * call.k > call.long_codes_threshold
        call.short_codes |= use_double and call.method != EXACT_CALC
        if call.jt is None:
            call.scan_slots += queries.shape[0] * ph.size
            k_sub = self.codebook.centroids.shape[1]
            codes_t = None if call.method == EXACT_CALC else ph.codes_t(
                k_sub if use_double else None)
            return _ivpq_round(
                queries, self.coarse.centroids, self.codebook.centroids,
                codes_t, ph.target_cells, ph.target_ids, ph.target_mask,
                call.statistics, ph.vectors, call.k, alpha, call.pvf,
                call.method, call.confidence, use_double,
                ph.vecs_pregathered)
        if first and self._round_graphs.engages(queries):
            out = self._graph_round(queries, call, alpha, use_double)
            if out is not None:
                return out
        sels = self._select(queries, call, alpha)
        p = self._budget_for(call.jt, call.budget_tiles,
                             lambda: budget_need([s[1] for s in sels]))
        call.scan_slots += queries.shape[0] * p * call.jt.block_t
        return self._scan(queries, call, sels, p, use_double)

    def _select(self, queries: torch.Tensor, call: _JoinCall, alpha: int
                ) -> list[tuple[torch.Tensor, ...]]:
        """:func:`select_tiles` of each block of a budget round."""
        return [select_tiles(qb, self.coarse.centroids, call.statistics,
                             call.jt, call.k, alpha, call.confidence)
                for qb in torch.split(queries, _BUDGET_SCAN_BLOCK)]

    def _scan(self, queries: torch.Tensor, call: _JoinCall, sels: list,
              p: int, use_double: bool) -> tuple[torch.Tensor, ...]:
        """A budget round's scan at ``p`` tiles a query over the blocks'
        selections ``sels``, the blocks' outputs concatenated."""
        ph = call.prepared
        outs = [_ivpq_round_budget(
            qb, self.codebook.centroids, call.jt, ph.vectors, sel, call.k,
            call.pvf, call.method, use_double, p, call.lut_dtype,
            ph.target_ids, ph.vecs_pregathered)
            for qb, sel in zip(torch.split(queries, _BUDGET_SCAN_BLOCK),
                               sels)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def _graph_round(self, queries: torch.Tensor, call: _JoinCall,
                     alpha: int, use_double: bool
                     ) -> tuple[torch.Tensor, ...] | None:
        """A first budget round from :attr:`_round_graphs`: the selection
        graph over a static copy of the queries, the one read that fits P
        (:meth:`_budget_for`), then the scan graph, keyed also on P and
        reading the selection graph's outputs. The same work as
        :meth:`_select` and :meth:`_scan`, bit for bit. → the round's
        outputs, copied out of the graph; None on the selection key's
        first sighting, where the caller runs the round eager (the scan
        runs eager on its own key's first sighting). Entries end with the
        prepared set or the statistics table, or an in-place change of
        the latter; an unprepared call's handle ends with the call, so
        such calls stay eager. The index's own tables never change
        (:meth:`add` returns a new index), so the keys leave them out."""
        graphs, ph, jt, st = (self._round_graphs, call.prepared, call.jt,
                              call.statistics)
        sizes = tuple(qb.shape[0] for qb in
                      torch.split(queries, _BUDGET_SCAN_BLOCK))
        alive = (ph, st)
        s_key = ("select", id(ph), id(jt), id(st), st._version, call.k,
                 alpha, call.confidence, sizes, queries.dtype,
                 queries.shape[1])

        def select(q):
            sels = self._select(q, call, alpha)
            return (budget_need([s[1] for s in sels]),
                    *(t for sel in sels for t in sel))

        with graphs.lock:
            s = graphs.run(s_key, select, (queries,), alive=alive)
            if s is None:
                return None
            flat = s.outputs[1:]
            per = len(flat) // len(sizes)
            sels = [flat[i:i + per] for i in range(0, len(flat), per)]
            p = self._budget_for(jt, call.budget_tiles, lambda: s.outputs[0])
            call.scan_slots += queries.shape[0] * p * jt.block_t
            r_key = s_key + ("scan", p, use_double, call.method, call.pvf,
                             call.lut_dtype)
            r = graphs.run(r_key, lambda: self._scan(
                s.inputs[0], call, sels, p, use_double),
                alive=alive, parent=s_key)
            if r is None:
                return self._scan(s.inputs[0], call, sels, p, use_double)
            call.graph_rounds += 1
            return tuple(t.clone() for t in r.outputs)

    # ------------------------------------------------------------ mutation
    def add(self, new_vectors: torch.Tensor) -> "IVPQIndex":
        """Online insert (``insert_batch``'s IVPQ leg, freddy.c:1590-1609;
        JAX ivpq.py:1154-1165): multi-index assignment, running-mean
        fine-codebook update, appended codes and cells. Returns a new
        index; join handles prepared before it keep their targets."""
        new_cells = assign_cells(new_vectors, self.coarse.centroids)
        cb, new_codes = online_codebook_update(self.codebook, new_vectors)
        cell_counts = self.coarse.cell_counts + torch.bincount(
            new_cells, minlength=self.num_cells).to(torch.int32)
        return IVPQIndex(
            MultiIndexQuantizer(self.coarse.centroids, cell_counts), cb,
            torch.cat([self.codes, new_codes.to(self.codes.dtype)]),
            torch.cat([self.cell_of, new_cells.to(self.cell_of.dtype)]))

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        """Write the JAX package's ``ivpq.npz`` fields."""
        def h(t):
            return t.detach().cpu().numpy()

        np.savez_compressed(
            path, coarse_centroids=h(self.coarse.centroids),
            cell_counts=h(self.coarse.cell_counts),
            centroids=h(self.codebook.centroids),
            counts=h(self.codebook.counts), codes=h(self.codes),
            cell_of=h(self.cell_of).astype(np.int32))

    @classmethod
    def load(cls, path: str | Path, *,
             device: torch.device | str | None = None) -> "IVPQIndex":
        """An index saved by either package, on the card unless ``device``
        names another."""
        from postgres_word2vec_tpu_torch.utils.convert import ivpq_from_numpy

        with np.load(path, allow_pickle=False) as f:
            arrays = {name: f[name] for name in f.files}
        return ivpq_from_numpy(arrays, device)
