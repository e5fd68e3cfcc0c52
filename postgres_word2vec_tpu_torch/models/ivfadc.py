"""IVFADC — inverted file with asymmetric distance on PQ-coded residuals.

Counterpart of ``postgres_word2vec_tpu/models/ivfadc.py``. Parity targets:
the build script ivfadc.py (coarse k-means + residual codebook + per-vector
codes; defaults from ivfadc_config.json: m=12, k=256, k_coarse=1000, train
100k), the search kernels ``ivfadc_search`` / ``ivfadc_batch_search``
(freddy.c:172-410, 677-1024) and the post-verified wrapper
``k_nearest_neighbour_ivfadc_pv`` (sql:556-591).

Layout: codes sorted by coarse cell (CSR offsets), laid out cell-aligned in
whole tiles of ``block_t`` rows with one trailing all-padding inf tile
(:class:`TiledIVF`). A probe plans each query's selected cells into a
fixed budget of tile slots (:func:`plan_probe_tiles`) and scans them with
the budget kernels (``ops/kernels.budget_adc_auto``: K6 per query, K7
grouped by tile) on the card, or their plain versions on the CPU. The
reference's "widen until ≥ k found" loop (freddy.c:262-378) is the rank
window escalation of :meth:`IVFADCIndex.search_adaptive`.

Online insert is the JAX package's LSM tail: :meth:`IVFADCIndex.add`
appends rows to a fixed-capacity unsorted tail that every search scans
(:func:`_tail_scan`, plain torch as in the JAX package) and merges; when
the tail would overflow, :meth:`IVFADCIndex._splice` merges it into the
CSR lists.

The row-1 probe :func:`_ivfadc_probe` — the w probed cells' lists gathered
into ``(B, w, list_cap)`` windows and scored with one LUT per (query, cell)
by :func:`grouped_adc_distances` — is the one the sharded IVFADC runs on
each shard's cells (``parallel/sharding.py``), and the tiled probe's
reference in the tests.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from postgres_word2vec_tpu_torch.models.pq import (PQCodebook, _sample_rows,
                                                   online_codebook_update)
from postgres_word2vec_tpu_torch.ops import adc, kernels, kmeans, lut
from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32


class CoarseQuantizer(NamedTuple):
    """Flat coarse quantizer (``coarse_quantization`` table)."""
    centroids: torch.Tensor  # (C, d) float32
    counts: torch.Tensor     # (C,) int32


class TiledIVF(NamedTuple):
    """Cell-aligned tiled inverted file — the probe layout.

    Every cell's rows are padded to whole tiles of ``block_t`` rows, so a
    probe's cost tracks each cell's true size; one trailing inf tile
    absorbs unused budget slots. ``rowterm`` carries the query-independent
    part of the IVFADC distance decomposition

        ‖q − c − r‖² = ‖q − r‖²(LUT) + 2·c·r(rowterm) + ‖q − c‖² − ‖q‖²

    so one LUT per query serves every probed cell.
    """
    block_t: int
    codes_t: torch.Tensor     # (m, NA) storage dtype, cell-aligned
    rowterm: torch.Tensor     # (NA,) float32; +inf on padding rows
    row_ids: torch.Tensor     # (NA,) int32; -1 on padding rows
    tile_start: torch.Tensor  # (C,) int64 first tile of each cell
    tile_cnt: torch.Tensor    # (C,) int64 tiles per cell
    tile_rows: torch.Tensor   # (NT + 1,) int64 real rows per tile
    cell_sizes: torch.Tensor  # (C,) int64 real rows per cell
    inf_tile: int
    max_tile_cnt: int
    avg_tile_cnt: float


@no_tf32()
def _compute_rowterm(coarse_centroids: torch.Tensor,
                     codebooks: torch.Tensor, cells: torch.Tensor,
                     codes: torch.Tensor, *,
                     chunk_size: int = 1_048_576) -> torch.Tensor:
    """``rowterm[r] = 2·Σ_j coarse[cell_r]_j · cb_j[code_rj]`` → (n,)
    float32, through a (C, m, k) table of per-cell cross terms."""
    C, d = coarse_centroids.shape
    m, k, dsub = codebooks.shape
    percell = 2.0 * torch.einsum(
        "cmd,mkd->cmk", coarse_centroids.float().reshape(C, m, dsub),
        codebooks.float()).reshape(-1)
    j_off = (torch.arange(m, device=codes.device) * k)[None, :]
    out = torch.empty(codes.shape[0], dtype=torch.float32,
                      device=codes.device)
    for s in range(0, codes.shape[0], chunk_size):
        idx = (cells[s:s + chunk_size].long()[:, None] * (m * k) + j_off
               + codes[s:s + chunk_size].long())
        out[s:s + chunk_size] = torch.sum(percell[idx], dim=-1)
    return out


def plan_probe_tiles(p_budget: int, start: torch.Tensor, cnt: torch.Tensor,
                     inf_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten each query's selected cells into ``p_budget`` tile slots.

    ``start``/``cnt`` are ``(B, W)`` first-tile ids and tile counts of the
    cells to probe, in probe order (``cnt`` 0 for cells beyond a query's
    selection). → ``(tiles (B, P) int32, slot_cell (B, P) int64)``:
    ``slot_cell`` indexes the W probe slots (W for unused slots, which
    point at the inf tile)."""
    B, w = cnt.shape
    cum = torch.cumsum(cnt.long(), dim=1).contiguous()
    p_iota = torch.arange(p_budget, device=cnt.device)
    # slot of budget position p = first cell whose cumulative tile count
    # exceeds p (right-searchsorted skips cells with no tiles).
    s = torch.searchsorted(cum, p_iota.expand(B, p_budget).contiguous(),
                           right=True)
    valid = s < w
    sc = torch.clamp_max(s, w - 1)
    prev = torch.gather(torch.nn.functional.pad(cum, (1, 0)), 1, sc)
    tiles = torch.where(valid,
                        torch.gather(start.long(), 1, sc) + p_iota - prev,
                        inf_tile)
    return tiles.to(torch.int32), torch.where(valid, sc, w)


def probe_plan(queries: torch.Tensor, coarse: torch.Tensor,
               tiled: TiledIVF, w_lo: int, w_hi: int, p_budget: int
               ) -> tuple[torch.Tensor, ...]:
    """The cells ranked [w_lo, w_hi) per query and their tile plan →
    (cell distances (B, w), cells (B, w), tiles (B, P), slot_cell (B, P))."""
    cd = kmeans.pairwise_sqdist(queries, coarse)
    cdv, cells = topk_ops.top_k_smallest(cd, w_hi)
    cdv, cells = cdv[:, w_lo:], cells[:, w_lo:]
    tiles, slot_cell = plan_probe_tiles(
        p_budget, tiled.tile_start[cells], tiled.tile_cnt[cells],
        tiled.inf_tile)
    return cdv, cells, tiles, slot_cell


def _ivfadc_probe_budget(queries: torch.Tensor, coarse: torch.Tensor,
                         centroids: torch.Tensor, tiled: TiledIVF,
                         w_lo: int, w_hi: int, k: int, p_budget: int
                         ) -> tuple[torch.Tensor, ...]:
    """Budgeted probe of the cells ranked [w_lo, w_hi) per query.

    ``w_lo > 0`` skips cells already probed — the blacklist of the
    reference's widening loop (freddy.c:262-378) as a rank window.
    → (sqdists (B, k), ids (B, k) int64 with −1 past the rows found, rows
    scanned (B,), rows in all selected cells (B,))."""
    B = queries.shape[0]
    bt = tiled.block_t
    cdv, cells, tiles, slot_cell = probe_plan(queries, coarse, tiled, w_lo,
                                              w_hi, p_budget)
    luts = lut.build_luts(queries, centroids)
    d = kernels.budget_adc_auto(luts, tiled.codes_t, tiled.rowterm, tiles,
                                block_t=bt)
    # add the cell-level constant ‖q−c‖² − ‖q‖² per slot.
    qf = queries.float()
    qq = torch.sum(qf * qf, dim=-1)
    cd_slot = torch.gather(torch.nn.functional.pad(cdv, (0, 1)), 1,
                           slot_cell)
    d = d.reshape(B, p_budget, bt) + (cd_slot - qq[:, None])[:, :, None]
    d = torch.clamp_min(d, 0.0).reshape(B, p_budget * bt)
    d = torch.where(torch.isnan(d), float("inf"), d)   # guard, as in JAX

    k_eff = min(k, p_budget * bt)
    vals, pos = topk_ops.top_k_smallest(d, k_eff)
    gpos = torch.gather(tiles.long(), 1, pos // bt) * bt + pos % bt
    ids = torch.where(torch.isfinite(vals), tiled.row_ids[gpos].long(), -1)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff),
                                       value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    found = torch.sum(tiled.tile_rows[tiles.long()], dim=1)
    needed = torch.sum(tiled.cell_sizes[cells], dim=1)
    return vals, ids, found, needed


#: Elements of the row-1 probe's gathered ``(B, w, list_cap, m)`` candidate
#: codes per query chunk; a larger batch runs in chunks of queries.
_PROBE_ELEMS = 1 << 26


def grouped_adc_distances(luts: torch.Tensor, codes: torch.Tensor
                          ) -> torch.Tensor:
    """ADC with per-group LUTs: ``(..., m, k) × (..., L, m) → (..., L)``
    float32 (JAX ivfadc.py:47-66). Each leading-dim group (query × probed
    cell) has its own LUT, the residual-ADC pattern of ``ivfadc_search``
    (freddy.c:347-373): one flat gather into each group's ``(m·k,)`` table,
    then a sum over the m subspaces."""
    m, k = luts.shape[-2:]
    L = codes.shape[-2]
    flat = luts.float().reshape(-1, m * k)
    idx = codes.long() + torch.arange(m, device=codes.device) * k
    gathered = torch.gather(flat, 1, idx.reshape(flat.shape[0], L * m))
    return gathered.reshape(*codes.shape[:-1], m).sum(-1)


@no_tf32()
def _probe_cells(queries: torch.Tensor, coarse: torch.Tensor,
                 centroids: torch.Tensor, cells: torch.Tensor,
                 cell_offsets: torch.Tensor, codes_sorted: torch.Tensor,
                 row_ids: torch.Tensor, list_cap: int, k: int,
                 owned: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """The row-1 probe of each query's ``cells`` (B, w) over a CSR list
    (JAX ivfadc.py:250-282): per-(query, cell) residual LUTs, each cell's
    rows gathered into a window of ``list_cap`` lanes, ADC, a masked top-k.
    ``owned`` (B, w) masks cells whose rows live elsewhere (a shard's).
    → (sqdists (B, k'), int64 ids −1 past the rows found, found (B,) real
    candidates seen), k' = min(k, w·list_cap). The ``(B, w, list_cap, m)``
    gather runs in query chunks of at most :data:`_PROBE_ELEMS` elements."""
    B, d = queries.shape
    w = cells.shape[1]
    m = codes_sorted.shape[1]
    step = max(1, _PROBE_ELEMS // max(w * list_cap * m, 1))
    if B > step:
        outs = [_probe_cells(queries[s:s + step], coarse, centroids,
                             cells[s:s + step], cell_offsets, codes_sorted,
                             row_ids, list_cap, k,
                             None if owned is None else owned[s:s + step])
                for s in range(0, B, step)]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    resid = queries.float()[:, None, :] - coarse[cells]          # (B, w, d)
    luts = lut.build_luts(resid.reshape(B * w, d), centroids)
    luts = luts.reshape(B, w, *luts.shape[1:])               # (B, w, m, k)
    offs = cell_offsets.long()
    pos = offs[cells][..., None] + torch.arange(list_cap,
                                                device=queries.device)
    valid = pos < offs[cells + 1][..., None]                      # (B, w, L)
    if owned is not None:
        valid &= owned[..., None]
    pos_c = torch.clamp_max(pos, codes_sorted.shape[0] - 1)
    dists = grouped_adc_distances(luts, codes_sorted[pos_c])
    dists = torch.where(valid, dists, float("inf")).reshape(B, -1)
    vals, fpos = topk_ops.top_k_smallest(dists, min(k, w * list_cap))
    gpos = torch.gather(pos_c.reshape(B, -1), 1, fpos)
    ids = torch.where(torch.isfinite(vals), row_ids.long()[gpos], -1)
    return vals, ids, valid.reshape(B, -1).sum(-1)


def _ivfadc_probe(queries: torch.Tensor, coarse: torch.Tensor,
                  centroids: torch.Tensor, cell_offsets: torch.Tensor,
                  codes_sorted: torch.Tensor, row_ids: torch.Tensor, w: int,
                  k: int, list_cap: int) -> tuple[torch.Tensor, ...]:
    """Probe the w nearest cells per query, ADC-scan their lists, top-k
    (JAX ivfadc.py:243-282) → (sqdists, int64 global ids, found), where
    ``found[b]`` counts the real candidates seen, the reference's
    ``foundInstances`` (freddy.c:262)."""
    _, cells = topk_ops.top_k_smallest(kmeans.pairwise_sqdist(queries, coarse),
                                       w)
    return _probe_cells(queries, coarse, centroids, cells, cell_offsets,
                        codes_sorted, row_ids, list_cap, k)


def _tail_scan(queries: torch.Tensor, coarse: torch.Tensor,
               centroids: torch.Tensor, tail_codes: torch.Tensor,
               tail_cells: torch.Tensor, tail_ids: torch.Tensor,
               tail_rowterm: torch.Tensor, tail_count: int, w_lo: int,
               w_hi: int, k: int) -> tuple[torch.Tensor, ...]:
    """Scan the insert tail against each query's probed-cell window
    [w_lo, w_hi): dense residual ADC over the (small) tail, masked to rows
    whose cell the query probes → (vals (B, k'), int64 ids, −1 past the
    rows found, rows seen (B,)), k' = min(k, TAIL_CAP). ``tail_rowterm``
    is kept against the current codebook by ``add`` (JAX ivfadc.py:211-239,
    plain in both packages)."""
    cap = tail_codes.shape[0]
    cd = kmeans.pairwise_sqdist(queries, coarse)
    _, cells = topk_ops.top_k_smallest(cd, w_hi)
    cells = cells[:, w_lo:]
    luts = lut.build_luts(queries, centroids)
    d = adc.adc_distances(luts, tail_codes)                   # (B, cap)
    qf = queries.float()
    qq = torch.sum(qf * qf, dim=-1)
    tc = tail_cells.long()
    dist = d + tail_rowterm[None, :] + cd[:, tc] - qq[:, None]
    probed = torch.any(tc[None, :, None] == cells[:, None, :], dim=-1)
    valid = (torch.arange(cap, device=queries.device) < tail_count)[None] \
        & probed
    dist = torch.where(valid, torch.clamp_min(dist, 0.0), float("inf"))
    vals, pos = topk_ops.top_k_smallest(dist, min(k, cap))
    ids = torch.where(torch.isfinite(vals), tail_ids.long()[pos], -1)
    return vals, ids, valid.sum(-1)


@dataclasses.dataclass
class IVFADCIndex:
    """CSR inverted file over PQ-coded residuals, on one device, with the
    LSM insert tail of the JAX package: a fixed-capacity unsorted slab of
    freshly inserted rows (``tail_*``, ``TAIL_CAP`` rows) that every search
    scans and merges, spliced into the CSR lists when it would overflow."""

    coarse: CoarseQuantizer
    codebook: PQCodebook          # residual codebook (m, k, dsub)
    cell_offsets: torch.Tensor    # (C+1,) int32 prefix offsets
    codes_sorted: torch.Tensor    # (n, m) codes sorted by coarse cell
    row_ids: torch.Tensor         # (n,) int32 sorted position → row id
    assignments: torch.Tensor     # (n,) int32 row id → coarse cell
    list_cap: int                 # largest cell

    tail_codes: torch.Tensor | None = None     # (TAIL_CAP, m)
    tail_cells: torch.Tensor | None = None     # (TAIL_CAP,) int32
    tail_ids: torch.Tensor | None = None       # (TAIL_CAP,) int32
    tail_rowterm: torch.Tensor | None = None   # (TAIL_CAP,) float32
    tail_count: int = 0

    _tiled: TiledIVF | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    TAIL_CAP = 8192

    @property
    def size(self) -> int:
        return int(self.codes_sorted.shape[0]) + int(self.tail_count)

    @property
    def num_cells(self) -> int:
        return int(self.coarse.centroids.shape[0])

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, generator: torch.Generator, vectors: torch.Tensor, *,
              m: int = 12, k: int = 256, k_coarse: int = 1000,
              train_size: int | None = 100_000, iters: int = 10,
              restarts: int = 1, init: str = "sample") -> "IVFADCIndex":
        """Coarse k-means → residual codebook → CSR lists
        (``create_index_data`` parity, ivfadc.py:36-96). The residual
        codebook trains on the sample; the full residual table is never
        materialized (fused subtract + encode)."""
        train = _sample_rows(generator, vectors, train_size)
        coarse_res = kmeans.kmeans(generator, train, k_coarse, iters,
                                   restarts=restarts, init=init)
        assign = kmeans.assign(vectors, coarse_res.centroids)
        train_assign = kmeans.assign(train, coarse_res.centroids)
        train_resid = train.float() - coarse_res.centroids[train_assign]
        cb_res = kmeans.kmeans_subspaces(
            generator, kmeans.split_subspaces(train_resid, m), k, iters,
            restarts=restarts, init=init)
        codes = kmeans.encode_residual_subspaces(
            vectors, coarse_res.centroids, assign, cb_res.centroids)
        counts = torch.bincount(assign, minlength=k_coarse).to(torch.int32)
        return cls._assemble(CoarseQuantizer(coarse_res.centroids, counts),
                             PQCodebook(cb_res.centroids, cb_res.counts),
                             codes, assign)

    @classmethod
    def _assemble(cls, coarse: CoarseQuantizer, codebook: PQCodebook,
                  codes: torch.Tensor, assign: torch.Tensor
                  ) -> "IVFADCIndex":
        k_coarse = coarse.centroids.shape[0]
        order = torch.sort(assign, stable=True).indices
        sizes = torch.bincount(assign, minlength=k_coarse)
        offsets = torch.zeros(k_coarse + 1, dtype=torch.int32,
                              device=assign.device)
        offsets[1:] = torch.cumsum(sizes, 0)
        return cls(coarse=coarse, codebook=codebook, cell_offsets=offsets,
                   codes_sorted=codes[order],
                   row_ids=order.to(torch.int32),
                   assignments=assign.to(torch.int32),
                   list_cap=max(int(sizes.max()), 1))

    # ----------------------------------------------------------- tiled IVF
    def tiled(self, block_t: int | None = None) -> TiledIVF:
        """Build (and cache) the cell-aligned tiled probe layout on the
        index's device: 1024-row tiles from 500k rows up, else 128."""
        if self._tiled is not None and (block_t is None
                                        or self._tiled.block_t == block_t):
            return self._tiled
        bt = block_t or (1024 if self.size >= 500_000 else 128)
        dev = self.codes_sorted.device
        offsets = self.cell_offsets.long()
        sizes = offsets[1:] - offsets[:-1]
        n, m = self.codes_sorted.shape
        tile_cnt = -(-sizes // bt)                        # empty cell → 0
        tile_start = torch.cumsum(tile_cnt, 0) - tile_cnt
        nt = int(tile_cnt.sum())
        na = (nt + 1) * bt                                # + the inf tile

        cells_sorted = torch.repeat_interleave(
            torch.arange(sizes.shape[0], device=dev), sizes)
        within = torch.arange(n, device=dev) - offsets[cells_sorted]
        apos = tile_start[cells_sorted] * bt + within

        codes_t = torch.zeros(m, na, dtype=self.codes_sorted.dtype,
                              device=dev)
        codes_t[:, apos] = self.codes_sorted.t()
        rid = torch.full((na,), -1, dtype=torch.int32, device=dev)
        rid[apos] = self.row_ids
        rowterm = torch.full((na,), float("inf"), dtype=torch.float32,
                             device=dev)
        rowterm[apos] = _compute_rowterm(
            self.coarse.centroids, self.codebook.centroids, cells_sorted,
            self.codes_sorted)
        tile_rows = torch.bincount(tile_start[cells_sorted] + within // bt,
                                   minlength=nt + 1)
        tiled = TiledIVF(
            block_t=bt, codes_t=codes_t, rowterm=rowterm, row_ids=rid,
            tile_start=tile_start, tile_cnt=tile_cnt, tile_rows=tile_rows,
            cell_sizes=sizes, inf_tile=nt,
            max_tile_cnt=max(int(tile_cnt.max()), 1) if len(sizes) else 1,
            avg_tile_cnt=float(tile_cnt.float().mean()) if len(sizes)
            else 1.0)
        self._tiled = tiled
        return tiled

    def _auto_budget(self, w: int, budget_tiles: int | None,
                     full: bool) -> int:
        t = self.tiled()
        exact = max(w * t.max_tile_cnt, 1)
        if budget_tiles is not None:
            return max(1, min(budget_tiles, exact))
        if full:
            return exact
        want = max(1, int(np.ceil(1.5 * w * t.avg_tile_cnt)))
        return min(1 << int(np.ceil(np.log2(want))), exact)

    # ------------------------------------------------------------- search
    def search(self, queries: torch.Tensor, k: int, *, w: int = 3,
               budget_tiles: int | None = None, return_info: bool = False):
        """Fixed-nprobe batched IVFADC (``ivfadc_search`` with PARAM_W
        default 3, sql:189; batch parity: ``ivfadc_batch_search``).

        By default the w probed cells are scanned in full (budget = w ×
        the largest cell's tiles; unused slots land on the inf tile).
        ``budget_tiles`` caps the per-query scan; ``return_info`` reports
        coverage (found = rows scanned, needed = rows in the selected
        cells). Like the JAX package, every query probes ``w`` cells (the
        reference's batch mode assigns one cell per query per round)."""
        w_eff = min(w, self.num_cells)
        p = self._auto_budget(w_eff, budget_tiles, full=budget_tiles is None)
        vals, ids, found, needed = _ivfadc_probe_budget(
            queries, self.coarse.centroids, self.codebook.centroids,
            self.tiled(), 0, w_eff, k, p)
        if self.tail_count:
            tv, ti, tf = self._scan_tail(queries, 0, w_eff, k)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti, k)
            found = found + tf
            needed = needed + tf
        if return_info:
            return vals, ids, {"found": found, "needed": needed,
                               "budget_tiles": p}
        return vals, ids

    def search_adaptive(self, queries: torch.Tensor, k: int, *, w: int = 3,
                        max_rounds: int = 4,
                        budget_tiles: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's widening semantics (freddy.c:262-378): probe the
        w best cells; while some query saw fewer than k rows, probe the
        next ranks [w_hi, 2·w_hi) and merge — each round scans only cells
        not yet probed."""
        t = self.tiled()
        w_lo, w_hi = 0, min(w, self.num_cells)
        p = self._auto_budget(w_hi, budget_tiles, full=budget_tiles is None)
        vals, ids, total_found, _ = _ivfadc_probe_budget(
            queries, self.coarse.centroids, self.codebook.centroids, t,
            w_lo, w_hi, k, p)
        if self.tail_count:
            tv, ti, tf = self._scan_tail(queries, 0, w_hi, k)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti, k)
            total_found = total_found + tf
        for _ in range(max_rounds - 1):
            if bool(torch.all(total_found >= k)) or w_hi >= self.num_cells:
                break
            w_lo, w_hi = w_hi, min(w_hi * 2, self.num_cells)
            p = self._auto_budget(w_hi - w_lo, budget_tiles,
                                  full=budget_tiles is None)
            v2, i2, found, _ = _ivfadc_probe_budget(
                queries, self.coarse.centroids, self.codebook.centroids, t,
                w_lo, w_hi, k, p)
            vals, ids = topk_ops.merge_top_k_smallest(vals, ids, v2, i2, k)
            total_found = total_found + found
            if self.tail_count:
                tv, ti, tf = self._scan_tail(queries, w_lo, w_hi, k)
                vals, ids = topk_ops.merge_top_k_smallest(vals, ids, tv, ti,
                                                          k)
                total_found = total_found + tf
        return vals, ids

    def _scan_tail(self, queries: torch.Tensor, w_lo: int, w_hi: int,
                   k: int) -> tuple[torch.Tensor, ...]:
        return _tail_scan(queries, self.coarse.centroids,
                          self.codebook.centroids, self.tail_codes,
                          self.tail_cells, self.tail_ids, self.tail_rowterm,
                          self.tail_count, w_lo, w_hi, k)

    def search_pv(self, queries: torch.Tensor, k: int, pvf: int,
                  vectors: torch.Tensor, *, w: int = 3
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """IVFADC shortlist of k·pvf + exact re-rank
        (``k_nearest_neighbour_ivfadc_pv`` parity, sql:556-591)."""
        from postgres_word2vec_tpu_torch.ops import adc

        cd, ci = self.search(queries, k * pvf, w=w)
        return adc.post_verify(queries, ci, cd, vectors, k)

    # ------------------------------------------------------------ mutation
    def add(self, new_vectors: torch.Tensor) -> "IVFADCIndex":
        """Online insert (``insert_batch``'s IVFADC leg,
        freddy.c:1573-1587; JAX ivfadc.py:544-614): flat coarse
        assignment, residual encode with the running-mean residual codebook
        update, and an append to the insert tail. When the tail would pass
        ``TAIL_CAP`` rows, the tail and the new rows are spliced into the
        CSR lists instead (:meth:`_splice`).

        The new index shares the tail buffers, written in place past the
        receiver's ``tail_count`` (which still masks them for the
        receiver), and keeps the cached tiled layout, whose row term stays
        that of the earlier codebook until the next splice — as in the JAX
        package, existing codes are not re-encoded after the update. The
        tail's row term is recomputed against the new codebook at every
        add."""
        cen = self.coarse.centroids
        assign_new = kmeans.assign(new_vectors, cen)
        resid = new_vectors.float() - cen[assign_new]
        cb, new_codes = online_codebook_update(self.codebook, resid)
        a_new = assign_new.to(torch.int32)
        m_new = int(a_new.shape[0])
        new_codes = new_codes.to(self.codes_sorted.dtype)
        dev = self.codes_sorted.device
        new_ids = torch.arange(m_new, dtype=torch.int32,
                               device=dev) + self.size
        counts = self.coarse.counts + torch.bincount(
            a_new, minlength=self.num_cells).to(torch.int32)
        coarse2 = CoarseQuantizer(cen, counts)

        tc = self.tail_count
        if tc + m_new > self.TAIL_CAP:
            if tc:
                new_codes = torch.cat([self.tail_codes[:tc], new_codes])
                a_new = torch.cat([self.tail_cells[:tc], a_new])
                new_ids = torch.cat([self.tail_ids[:tc], new_ids])
            return self._splice(coarse2, cb, new_codes, a_new, new_ids)

        m = self.codes_sorted.shape[1]
        if self.tail_codes is None:
            t_codes = torch.zeros(self.TAIL_CAP, m,
                                  dtype=self.codes_sorted.dtype, device=dev)
            t_cells = torch.zeros(self.TAIL_CAP, dtype=torch.int32,
                                  device=dev)
            t_ids = torch.full((self.TAIL_CAP,), -1, dtype=torch.int32,
                               device=dev)
        else:
            t_codes, t_cells, t_ids = (self.tail_codes, self.tail_cells,
                                       self.tail_ids)
        t_codes[tc:tc + m_new] = new_codes
        t_cells[tc:tc + m_new] = a_new
        t_ids[tc:tc + m_new] = new_ids
        # the whole tail's row term against the just-updated codebook:
        # _tail_scan builds LUTs from the current codebook.
        t_rt = _compute_rowterm(cen, cb.centroids, t_cells, t_codes)
        return IVFADCIndex(
            coarse=coarse2, codebook=cb, cell_offsets=self.cell_offsets,
            codes_sorted=self.codes_sorted, row_ids=self.row_ids,
            assignments=self.assignments, list_cap=self.list_cap,
            tail_codes=t_codes, tail_cells=t_cells, tail_ids=t_ids,
            tail_rowterm=t_rt, tail_count=tc + m_new, _tiled=self._tiled)

    def flush(self) -> "IVFADCIndex":
        """Merge the insert tail into the CSR lists (no-op when empty)."""
        tc = self.tail_count
        if not tc:
            return self
        return self._splice(self.coarse, self.codebook, self.tail_codes[:tc],
                            self.tail_cells[:tc], self.tail_ids[:tc])

    def _splice(self, coarse2: CoarseQuantizer, cb: PQCodebook,
                new_codes: torch.Tensor, a_new: torch.Tensor,
                new_ids: torch.Tensor) -> "IVFADCIndex":
        """CSR splice on the device (JAX ivfadc.py:625-676): the new rows
        sort by cell among themselves and go after their cell's old rows;
        old rows shift by the new rows of earlier cells, without a global
        re-sort. The result has no tail and no cached tiled layout."""
        c_count = self.num_cells
        dev = self.codes_sorted.device
        n_old = int(self.codes_sorted.shape[0])
        m_new = int(a_new.shape[0])
        a_new = a_new.to(torch.int32)
        order_new = torch.sort(a_new, stable=True).indices
        cells_ns = a_new[order_new].long()
        codes_ns = new_codes[order_new].to(self.codes_sorted.dtype)
        rid_ns = new_ids.to(torch.int32)[order_new]

        counts_new = torch.bincount(a_new, minlength=c_count)
        old_off = self.cell_offsets.long()
        shift = torch.zeros(c_count + 1, dtype=torch.int64, device=dev)
        shift[1:] = torch.cumsum(counts_new, 0)
        new_off = old_off + shift
        cells_old = torch.repeat_interleave(
            torch.arange(c_count, device=dev), old_off[1:] - old_off[:-1])
        dest_old = torch.arange(n_old, device=dev) + shift[cells_old]
        rank_new = torch.arange(m_new, device=dev) - shift[cells_ns]
        dest_new = old_off[cells_ns + 1] + shift[cells_ns] + rank_new

        codes_out = torch.empty(n_old + m_new, self.codes_sorted.shape[1],
                                dtype=self.codes_sorted.dtype, device=dev)
        codes_out[dest_old] = self.codes_sorted
        codes_out[dest_new] = codes_ns
        rids_out = torch.empty(n_old + m_new, dtype=torch.int32, device=dev)
        rids_out[dest_old] = self.row_ids.to(torch.int32)
        rids_out[dest_new] = rid_ns
        sizes = new_off[1:] - new_off[:-1]
        # coarse2 already carries the per-cell counts of every added row
        return IVFADCIndex(
            coarse=coarse2, codebook=cb,
            cell_offsets=new_off.to(torch.int32), codes_sorted=codes_out,
            row_ids=rids_out,
            assignments=torch.cat([self.assignments.to(torch.int32), a_new]),
            list_cap=max(int(sizes.max()), 1) if c_count else 1)

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        """Write the JAX package's ``ivfadc.npz`` fields, in canonical CSR
        form: a non-empty insert tail is flushed first (JAX
        ivfadc.py:679-682), so the JAX package loads what the port
        saves."""
        if self.tail_count:
            self.flush().save(path)
            return

        def h(t):
            return t.detach().cpu().numpy()

        np.savez_compressed(
            path, coarse_centroids=h(self.coarse.centroids),
            coarse_counts=h(self.coarse.counts),
            centroids=h(self.codebook.centroids),
            counts=h(self.codebook.counts), cell_offsets=h(self.cell_offsets),
            codes_sorted=h(self.codes_sorted), row_ids=h(self.row_ids),
            assignments=h(self.assignments),
            list_cap=np.asarray(self.list_cap))

    @classmethod
    def load(cls, path: str | Path, *,
             device: torch.device | str | None = None) -> "IVFADCIndex":
        """An index saved by either package, on the card unless ``device``
        names another."""
        from postgres_word2vec_tpu_torch.utils.convert import ivfadc_from_numpy

        with np.load(path, allow_pickle=False) as f:
            arrays = {name: f[name] for name in f.files}
        return ivfadc_from_numpy(arrays, device)
