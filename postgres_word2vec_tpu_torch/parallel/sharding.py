"""Row sharding — the engine's scale-out axis, driven from one process.

Counterpart of ``postgres_word2vec_tpu/parallel/sharding.py``. The JAX
module runs every search as one ``shard_map`` program over a ``(rows, q)``
device mesh: the database axis N is split over ``rows`` (a top-k per shard,
merged with one ``all_gather``), the query batch over ``q`` (no
communication), and k-means reduces per-cluster sums with ``psum``.

Here one process drives a :class:`Mesh`, a ``(rows, q)`` grid of
``torch.device`` entries, as JAX's single controller drives its local
devices. Nothing uses ``torch.distributed``: the engine has no ranks, and
NCCL cannot put two ranks on one card. A device may appear more than once:
R shards on one card (``make_mesh([torch.device("cuda:0")] * 4, rows=4)``)
is how a one-card machine runs the sharded paths, and eight ``"cpu"``
entries in a 4 × 2 grid mirror the JAX tests' virtual CPU mesh. The
collectives become plain tensor ops:

- ``all_gather`` over rows, then ``top_k``: each q column concatenates its
  shards' ``(B, k)`` results on the column's lead device (mesh row 0), in
  shard order, and takes one top-k;
- ``psum``: a sum on the lead device;
- the q axis: the query batch in q equal chunks, one per mesh column (the
  batch must divide; the engine pads it).

A shard is placed once on each distinct device of its mesh row, so a card
holds one copy of it. Inside the loop over shards nothing is read back to
the host, so on several cards the shards' launches overlap; the host
bookkeeping of the IVFADC escalation and of the join's alpha escalation
runs after every shard of a round has been enqueued.

Each shard launches the port's kernels on its rows: K2 (K3 with
``lut_dtype="int8"``) in the PQ scan, the in-set ADC and the dense join
round; K6/K7 and K9/K10 in the budget join round (``ops/kernels.py``). On
CPU tensors their plain versions run. IVFADC probes each shard's cells
with the row-1 probe (``models.ivfadc._probe_cells``).

Ids are int64 global row ids (the JAX module's are int32), −1 where the
distance is +inf; every merged result has k columns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from postgres_word2vec_tpu_torch.models import exact as exact_mod
from postgres_word2vec_tpu_torch.models import ivfadc as ivfadc_mod
from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
from postgres_word2vec_tpu_torch.ops import kernels, kmeans
from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.adc import rerank
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32

ROWS_AXIS = "rows"
Q_AXIS = "q"


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index gets
    the current one, so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``(rows, q)`` grid of torch devices (``devices[r][j]``).
    ``shape`` maps the axis names to their sizes, as a JAX mesh's does."""

    def __init__(self, devices) -> None:
        grid = [[_device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices = grid
        self.shape = {ROWS_AXIS: len(grid), Q_AXIS: len(grid[0])}

    @property
    def lead(self) -> torch.device:
        """Where merged results land: mesh cell (0, 0)."""
        return self.devices[0][0]

    def row_devices(self, r: int) -> list[torch.device]:
        """The distinct devices of mesh row ``r``, in column order."""
        return list(dict.fromkeys(self.devices[r]))

    def __repr__(self) -> str:
        return (f"Mesh(rows={self.shape[ROWS_AXIS]}, q={self.shape[Q_AXIS]},"
                f" devices={[[str(d) for d in row] for row in self.devices]})")


def make_mesh(devices=None, *, rows: int | None = None, q: int = 1) -> Mesh:
    """Build a 2-D ``(rows, q)`` mesh from a flat device list, row-major
    (JAX sharding.py:42-57). ``rows`` shards the database axis, ``q`` the
    query batch; ``rows`` defaults to ``len(devices) // q``. ``devices``
    defaults to every visible CUDA device; without one it raises, as
    ``utils/device.py: resolve_device`` does. A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh takes every visible card by "
                "default; pass devices=[\"cpu\"] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if rows is None:
        rows = n // q
    if rows < 1 or rows * q != n:
        raise ValueError(f"{rows}×{q} mesh ≠ {n} devices")
    return Mesh([devices[r * q:(r + 1) * q] for r in range(rows)])


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A table cut along its leading axis into one equal contiguous shard
    per mesh row; ``parts[r]`` maps each distinct device of mesh row r to
    its copy of shard r. ``n`` counts the rows of all shards, padding
    included. A ``codes_major`` table keeps each shard transposed,
    ``(m, S)``, the scan kernels' layout (:func:`shard_codes`)."""
    mesh: Mesh
    n: int
    parts: tuple
    codes_major: bool = False

    @property
    def shard_size(self) -> int:
        return self.n // self.mesh.shape[ROWS_AXIS]

    def local(self, r: int, j: int = 0) -> torch.Tensor:
        """Shard ``r`` on the device of mesh cell ``(r, j)``."""
        return self.parts[r][self.mesh.devices[r][j]]


def _copy_to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``dev``, never a view of it."""
    return x.to(dev, copy=True, memory_format=torch.contiguous_format)


def _place(pieces, mesh: Mesh, n: int, codes_major: bool = False
           ) -> Sharded:
    """Shard ``pieces[r]`` once on each distinct device of mesh row r."""
    return Sharded(mesh, n, tuple(
        {dev: _copy_to(p, dev) for dev in mesh.row_devices(r)}
        for r, p in enumerate(pieces)), codes_major)


def _pieces(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    rows = mesh.shape[ROWS_AXIS]
    if x.shape[0] % rows:
        raise ValueError(f"N={x.shape[0]} not divisible by rows={rows}; "
                         "pad first (see pad_rows)")
    return list(torch.split(x, x.shape[0] // rows))


def shard_rows(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """A row-major table with its leading axis sharded over "rows"."""
    return _place(_pieces(x, mesh), mesh, x.shape[0])


def shard_codes(codes: torch.Tensor, mesh: Mesh) -> Sharded:
    """An ``(N, m)`` code table sharded over "rows", each shard laid out
    ``(m, S)`` once, here, for the scan kernels (the JAX module transposes
    and pads each shard on every call)."""
    return _place([p.t() for p in _pieces(codes, mesh)], mesh,
                  codes.shape[0], codes_major=True)


def replicate(x: torch.Tensor, mesh: Mesh) -> dict:
    """One copy of ``x`` on every distinct device of the mesh."""
    devs = dict.fromkeys(d for row in mesh.devices for d in row)
    return {dev: _copy_to(x, dev) for dev in devs}


def _on(x, dev: torch.device) -> torch.Tensor:
    """A replicated operand on ``dev``: its copy there (:func:`replicate`)
    or the tensor moved there."""
    return x[dev] if isinstance(x, dict) else x.to(dev)


def _cuda_context(dev: torch.device):
    """Make ``dev`` current while a shard's kernels launch (their wrappers
    launch on the current device's stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Pad the leading axis with zero rows to a multiple → (padded, the
    original row count, for masking)."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), n


def _q_chunks(x: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    qx = mesh.shape[Q_AXIS]
    if x.shape[0] % qx:
        raise ValueError(f"batch of {x.shape[0]} not divisible by the mesh's "
                         f"q axis ({qx}); pad it first")
    return torch.split(x, x.shape[0] // qx)


def _merge(parts: list, k: int, dev: torch.device) -> tuple:
    """The all-gather merge of one q column on ``dev``: every shard's
    (vals, ids) side by side in shard order, one top-k, −1 on +inf, padded
    to k columns; further outputs are summed (``psum``)."""
    vals = torch.cat([p[0].to(dev) for p in parts], dim=1)
    ids = torch.cat([p[1].to(dev) for p in parts], dim=1)
    v, pos = topk_ops.top_k_smallest(vals, min(k, vals.shape[1]))
    i = torch.where(torch.isfinite(v), torch.gather(ids, 1, pos), -1)
    if v.shape[1] < k:
        v = F.pad(v, (0, k - v.shape[1]), value=float("inf"))
        i = F.pad(i, (0, k - i.shape[1]), value=-1)
    sums = [sum(p[n].to(dev) for p in parts) for n in range(2, len(parts[0]))]
    return (v, i, *sums)


def _sharded_search(mesh: Mesh, q_like: torch.Tensor, per_shard: Callable,
                    k: int) -> tuple[torch.Tensor, ...]:
    """Run ``per_shard(r, j, dev, q_chunk) → (vals, global ids, *counts)``
    on every mesh cell — shard r against the query chunk of column j — and
    merge each column's shards on its lead device (:func:`_merge`); the
    columns' results are concatenated on the mesh's lead device."""
    cols = []
    for j, qj in enumerate(_q_chunks(q_like, mesh)):
        parts = []
        for r in range(mesh.shape[ROWS_AXIS]):
            dev = mesh.devices[r][j]
            with _cuda_context(dev):
                parts.append(per_shard(r, j, dev, qj.to(dev)))
        lead = mesh.devices[0][j]
        with _cuda_context(lead):
            cols.append(_merge(parts, k, lead))
    return tuple(torch.cat([c[n].to(mesh.lead) for c in cols])
                 for n in range(len(cols[0])))


# ---------------------------------------------------- exact and ADC top-k

def sharded_exact_top_k(mesh: Mesh, queries: torch.Tensor, vectors: Sharded,
                        k: int, *, dtype: str = "float32",
                        valid_rows: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a rows-sharded ``(N, d)`` table (JAX :81-110): each
    shard's ``exact_top_k`` of ``min(k, S)`` rows, merged. ``valid_rows``
    masks the padding rows appended to make N divisible by the mesh."""
    n_valid = vectors.n if valid_rows is None else valid_rows
    s = vectors.shard_size

    def shard(r, j, dev, q):
        d, i = exact_mod.exact_top_k(q, vectors.local(r, j), min(k, s),
                                     dtype=dtype)
        i = i + r * s
        return torch.where(i < n_valid, d, float("inf")), i

    return _sharded_search(mesh, queries, shard, k)


def _codes_t(codes: Sharded, r: int, j: int) -> torch.Tensor:
    if not codes.codes_major:
        raise ValueError("the ADC paths take codes sharded by shard_codes")
    return codes.local(r, j)


def sharded_adc_top_k(mesh: Mesh, luts: torch.Tensor, codes: Sharded,
                      k: int, *, valid_rows: int | None = None,
                      lut_dtype: str = "bf16"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive PQ ADC top-k over a rows-sharded code table, the
    multi-device ``pq_search`` (JAX :140-174): per shard the dense scan K2
    (K3 with ``lut_dtype="int8"``) over its ``(m, S)`` codes, then an exact
    top-k of ``min(k, S)``; padding rows and rows past ``valid_rows`` score
    +inf. Only k ids per shard move."""
    n_valid = codes.n if valid_rows is None else valid_rows
    s = codes.shard_size

    def shard(r, j, dev, lq):
        d = kernels.adc_scan(lq, _codes_t(codes, r, j), lut_dtype=lut_dtype)
        cut = n_valid - r * s
        if cut < s:
            d[:, max(cut, 0):] = float("inf")
        vals, pos = topk_ops.top_k_smallest(d, min(k, s))
        return vals, pos + r * s

    return _sharded_search(mesh, luts, shard, k)


# ------------------------------------------------------------------ in-set

def _sharded_in_topk(mesh: Mesh, q_like: torch.Tensor, table: Sharded,
                     target_ids: torch.Tensor, target_mask: torch.Tensor,
                     k: int, dist_fn: Callable
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner-partitioned in-set top-k (JAX :177-223): each shard scores
    only the targets it owns (owner = id // S), ``dist_fn(q, shard,
    local rows) → (B, T)``, the rest +inf; a local top-k of min(k, T), one
    merge (+inf / −1 past the targets)."""
    s = table.shard_size
    k_eff = min(k, target_ids.shape[0])

    def shard(r, j, dev, q):
        tids = target_ids.to(dev).long()
        safe = torch.clamp_min(tids, 0)
        owned = target_mask.to(dev) & (safe // s == r)
        d = dist_fn(q, table.local(r, j), torch.where(owned, safe % s, 0))
        d = torch.where(owned[None, :], d, float("inf"))
        vals, pos = topk_ops.top_k_smallest(d, k_eff)
        return vals, torch.where(torch.isfinite(vals), tids[pos], -1)

    return _sharded_search(mesh, q_like, shard, k)


@no_tf32()
def _exact_rows(q: torch.Tensor, table: torch.Tensor, rows: torch.Tensor
                ) -> torch.Tensor:
    v = table[rows].float()
    qf = q.float()
    return torch.clamp_min(torch.sum(qf * qf, -1)[:, None] - 2.0 * (qf @ v.t())
                           + torch.sum(v * v, -1)[None, :], 0.0)


def sharded_exact_in(mesh: Mesh, queries: torch.Tensor, vectors: Sharded,
                     target_ids: torch.Tensor, target_mask: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact in-set top-k over a rows-sharded table, the multi-device
    ``knn_in_exact`` / ``knn_search_in_batch`` (JAX :226-243)."""
    return _sharded_in_topk(mesh, queries, vectors, target_ids, target_mask,
                            k, _exact_rows)


def sharded_adc_in(mesh: Mesh, luts: torch.Tensor, codes: Sharded,
                   target_ids: torch.Tensor, target_mask: torch.Tensor,
                   k: int, *, lut_dtype: str = "bf16"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """PQ ADC in-set top-k over a rows-sharded code table, the
    multi-device ``pq_search_in`` (JAX :246-271): each shard's owned target
    columns gathered into an ``(m, T)`` table and scored by K2 (K3 with
    ``lut_dtype="int8"``)."""
    def dist(lq, codes_t, rows):
        return kernels.adc_scan(lq, codes_t.index_select(1, rows),
                                lut_dtype=lut_dtype)

    if not codes.codes_major:
        raise ValueError("the ADC paths take codes sharded by shard_codes")
    return _sharded_in_topk(mesh, luts, codes, target_ids, target_mask, k,
                            dist)


def sharded_post_verify(mesh: Mesh, queries: torch.Tensor,
                        cand_dists: torch.Tensor, cand_ids: torch.Tensor,
                        vectors: Sharded, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-device exact re-rank (``postverify``, index_utils.c:477-498;
    JAX :278-318): each shard contributes the candidate rows it owns, zero
    elsewhere, the contributions are summed on the column's lead device
    (``psum``) and the re-rank (``ops.adc.rerank``) runs there once."""
    s = vectors.shard_size
    cols = []
    for j, (qj, cdj, cij) in enumerate(zip(
            _q_chunks(queries, mesh), _q_chunks(cand_dists, mesh),
            _q_chunks(cand_ids, mesh))):
        lead = mesh.devices[0][j]
        cand = None
        for r in range(mesh.shape[ROWS_AXIS]):
            dev = mesh.devices[r][j]
            with _cuda_context(dev):
                ci = cij.to(dev).long()
                safe = torch.clamp_min(ci, 0)
                owned = (ci >= 0) & (safe // s == r)
                rows = vectors.local(r, j)[torch.where(owned, safe % s, 0)]
                part = torch.where(owned[..., None], rows.float(), 0.0)
            cand = part.to(lead) if cand is None else cand + part.to(lead)
        with _cuda_context(lead):
            cols.append(rerank(qj.to(lead), cij.to(lead), cdj.to(lead), cand,
                               k))
    return tuple(torch.cat([c[n].to(mesh.lead) for c in cols])
                 for n in range(2))


# ----------------------------------------------------------------- k-means

@no_tf32()
def sharded_kmeans_step(mesh: Mesh, x: Sharded, centroids: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One data-parallel Lloyd iteration (JAX :366-396): each shard assigns
    its rows (one matmul and argmin), per-cluster sums and counts are
    summed on the lead device (``psum``); an empty cluster keeps its
    centroid. Shards run on mesh column 0 (the other columns would
    repeat them). → (centroids (k, d) float32, counts (k,) int32)."""
    c = centroids.float()
    k, d = c.shape
    sums = counts = None
    for r in range(mesh.shape[ROWS_AXIS]):
        dev = mesh.devices[r][0]
        with _cuda_context(dev):
            xs = x.local(r).float()
            cr = c.to(dev)
            a = torch.argmin(torch.sum(cr * cr, -1)[None, :]
                             - 2.0 * (xs @ cr.t()), dim=-1)
            s = torch.zeros(k, d, device=dev).index_add_(0, a, xs)
            n = torch.bincount(a, minlength=k).float()
        sums = s.to(mesh.lead) if sums is None else sums + s.to(mesh.lead)
        counts = (n.to(mesh.lead) if counts is None
                  else counts + n.to(mesh.lead))
    c = c.to(mesh.lead)
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0), c)
    return new_c, counts.to(torch.int32)


def sharded_kmeans(mesh: Mesh, generator: torch.Generator, x: Sharded,
                   k: int, iters: int = 10
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel k-means over a rows-sharded table, the multi-device
    ``create_quantizer`` (JAX :399-410): k distinct rows drawn with
    ``generator`` as the first centroids, then ``iters`` sharded Lloyd
    steps."""
    s = x.shard_size
    idx = torch.randperm(x.n, generator=generator,
                         device=generator.device)[:k].tolist()
    centroids = torch.stack([x.local(i // s)[i % s].to(mesh.lead)
                             for i in idx]).float()
    counts = torch.zeros(k, dtype=torch.int32, device=mesh.lead)
    for _ in range(iters):
        centroids, counts = sharded_kmeans_step(mesh, x, centroids)
    return centroids, counts


# ------------------------------------------------------------------ IVFADC

def shard_ivfadc(index, mesh: Mesh) -> dict:
    """Partition an :class:`IVFADCIndex`'s inverted lists over the rows
    axis (JAX :688-737): the insert tail is flushed first; cells split into
    contiguous ranges of about equal row counts (a greedy ``searchsorted``
    over the prefix offsets); each shard's rows repacked locally, padded to
    the largest shard, row ids kept global, offsets local and clipped to
    the shard. Returns the bundle :func:`sharded_ivfadc_probe` reads."""
    index = index.flush()
    rows = mesh.shape[ROWS_AXIS]
    offsets = index.cell_offsets.cpu().numpy().astype(np.int64)
    n_cells = index.num_cells
    total = int(offsets[-1])
    bounds = [0] + [int(np.searchsorted(offsets, total * s // rows))
                    for s in range(1, rows)] + [n_cells]
    starts, ends = bounds[:-1], bounds[1:]
    lo, hi = offsets[starts], offsets[ends]
    max_rows = max(int((hi - lo).max()), 1)
    codes, rids = index.codes_sorted, index.row_ids
    offs = index.cell_offsets.long()
    parts = {"codes": [], "row_ids": [], "offsets": []}
    for s in range(rows):
        a, b = int(lo[s]), int(hi[s])
        c = codes.new_zeros((max_rows, codes.shape[1]))
        c[:b - a] = codes[a:b]
        i = torch.full((max_rows,), -1, dtype=torch.int32, device=rids.device)
        i[:b - a] = rids[a:b]
        parts["codes"].append(c)
        parts["row_ids"].append(i)
        parts["offsets"].append(torch.clamp(offs - a, 0, b - a))
    return {
        "codes": _place(parts["codes"], mesh, rows * max_rows),
        "row_ids": _place(parts["row_ids"], mesh, rows * max_rows),
        "offsets": _place(parts["offsets"], mesh, rows * (n_cells + 1)),
        "cell_start": starts, "cell_end": ends,
        "coarse": replicate(index.coarse.centroids, mesh),
        "codebook": replicate(index.codebook.centroids, mesh),
        "num_cells": n_cells,
        "list_cap": int(np.diff(offsets).max(initial=0) or 1),
    }


def sharded_ivfadc_probe(mesh: Mesh, queries: torch.Tensor, bundle: dict, *,
                         w: int, k: int, list_cap: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-device IVFADC probe (JAX :740-798): every shard ranks all
    coarse cells (replicated centroids), runs the row-1 probe over the
    probed cells it owns, and the shards' top-k merge."""
    cap = bundle["list_cap"] if list_cap is None else list_cap

    def shard(r, j, dev, q):
        coarse = bundle["coarse"][dev]
        _, cells = topk_ops.top_k_smallest(
            kmeans.pairwise_sqdist(q, coarse), w)
        owned = (cells >= bundle["cell_start"][r]) \
            & (cells < bundle["cell_end"][r])
        vals, ids, _ = ivfadc_mod._probe_cells(
            q, coarse, bundle["codebook"][dev], cells,
            bundle["offsets"].local(r, j), bundle["codes"].local(r, j),
            bundle["row_ids"].local(r, j), cap, k, owned)
        return vals, ids

    return _sharded_search(mesh, queries, shard, k)


def sharded_ivfadc_adaptive(mesh: Mesh, queries: torch.Tensor, bundle: dict,
                            *, k: int, w: int, max_rounds: int = 3
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-device IVFADC with widening semantics (JAX :321-363): probe
    ``w`` cells; queries that found fewer than k rows re-probe with doubled
    w (the reference's blacklist-and-widen loop, freddy.c:262-378). Each
    escalation round re-probes only the unresolved queries, as a
    power-of-two sub-batch rounded up to a multiple of the q axis. The
    bookkeeping runs on the host, after the round's shards are
    enqueued."""
    vals, ids = sharded_ivfadc_probe(mesh, queries, bundle, w=w, k=k)
    cur_w = w
    n_cells = bundle["num_cells"]
    vals_h = ids_h = None
    qx = mesh.shape[Q_AXIS]
    for _ in range(max_rounds - 1):
        if ids_h is None:
            vals_h, ids_h = vals.cpu().clone(), ids.cpu().clone()
        unresolved = torch.nonzero((ids_h >= 0).sum(-1) < k).flatten()
        if unresolved.numel() == 0 or cur_w >= n_cells:
            break
        cur_w = min(cur_w * 2, n_cells)
        u = unresolved.numel()
        up = -(-(1 << (u - 1).bit_length()) // qx) * qx
        sel = torch.cat([unresolved, unresolved[:1].expand(up - u)])
        v2, i2 = sharded_ivfadc_probe(
            mesh, queries[sel.to(queries.device)], bundle, w=cur_w, k=k)
        vals_h[unresolved] = v2[:u].cpu()
        ids_h[unresolved] = i2[:u].cpu()
    if ids_h is None:
        return vals, ids
    return vals_h.to(vals.device), ids_h.to(ids.device)


# --------------------------------------------------------------- IVPQ join

def _global_counts(mesh: Mesh, cells: Sharded, mask: Sharded,
                   num_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole target set's count and per-cell counts (``psum``)."""
    t_real = counts = None
    for r in range(mesh.shape[ROWS_AXIS]):
        dev = mesh.devices[r][0]
        with _cuda_context(dev):
            m = mask.local(r).float()
            c = torch.zeros(num_cells, device=dev).index_add_(
                0, cells.local(r).long(), m)
            t = m.sum()
        t_real = t.to(mesh.lead) if t_real is None else t_real + t.to(
            mesh.lead)
        counts = c.to(mesh.lead) if counts is None else counts + c.to(
            mesh.lead)
    return t_real, counts


def sharded_ivpq_join_round(mesh: Mesh, queries: torch.Tensor,
                            coarse_cent, codebook_cent,
                            target_codes: Sharded, target_cells: Sharded,
                            target_ids: Sharded, target_mask: Sharded,
                            statistics, target_vecs: Sharded | None, *,
                            k: int, alpha: int, pvf: int = 20,
                            method: int = 0, confidence: float = 0.8
                            ) -> tuple[torch.Tensor, ...]:
    """Multi-device IVPQ kNN-join round (JAX :423-484): targets sharded over
    "rows" (codes by :func:`shard_codes`, padded entries masked false),
    queries over "q". Each shard runs the dense round
    (``models.ivpq._ivpq_round``, K2 on the card) against its targets, with
    the cell selection fed the whole set's counts so that it is the same on
    every shard. The shard's target positions index its own pregathered
    rows (method 2's post-verify reads them by position) and map to global
    ids through its target ids. → (dists, global ids, retrieved)."""
    stats_any = next(iter(statistics.values())) \
        if isinstance(statistics, dict) else statistics
    num_cells = stats_any.shape[0] - 1
    t_real, counts = _global_counts(mesh, target_cells, target_mask,
                                    num_cells)

    def shard(r, j, dev, q):
        vals, ids, retrieved, _, _ = ivpq_mod._ivpq_round(
            q, _on(coarse_cent, dev), _on(codebook_cent, dev),
            _codes_t(target_codes, r, j), target_cells.local(r, j),
            target_ids.local(r, j), target_mask.local(r, j),
            _on(statistics, dev),
            None if target_vecs is None else target_vecs.local(r, j), k,
            alpha, pvf, method, confidence, False, True,
            t_real_override=t_real.to(dev),
            cell_counts_override=counts.to(dev))
        return vals, ids, retrieved

    return _sharded_search(mesh, queries, shard, k)


def shard_join_targets(index, target_ids: torch.Tensor,
                       target_mask: torch.Tensor,
                       target_vecs: torch.Tensor | None, mesh: Mesh) -> dict:
    """The dense join's target arrays (JAX :540-558): codes, cells, ids,
    mask and, for methods 1 and 2, the rows ``target_vecs`` gathered once,
    zero-padded to a multiple of the rows axis (pad entries masked false)
    and sharded, the codes by :func:`shard_codes` → the target keyword
    arguments of :func:`sharded_ivpq_join_round`."""
    rows = mesh.shape[ROWS_AXIS]
    tids = target_ids.long()
    safe = torch.clamp_min(tids, 0)

    def pad(x):
        return pad_rows(x, rows)[0]

    return {"target_codes": shard_codes(pad(index.codes[safe]), mesh),
            "target_cells": shard_rows(pad(index.cell_of[safe]), mesh),
            "target_ids": shard_rows(pad(tids), mesh),
            "target_mask": shard_rows(pad(target_mask), mesh),
            "target_vecs": None if target_vecs is None
            else shard_rows(pad(target_vecs), mesh)}


def shard_join_tiles(index, target_ids: torch.Tensor,
                     target_mask: torch.Tensor,
                     target_vecs: torch.Tensor | None, mesh: Mesh, *,
                     block_t: int = 128, with_vecs: bool = False) -> dict:
    """Per-shard cell-aligned join tiles for the budget join (JAX
    :581-629): the targets split into equal contiguous slices (padded,
    pad entries masked), each slice its own ``models.ivpq.JoinTiles``
    (``with_vecs`` lays out the slice's rows of ``target_vecs`` for the
    exact method) on its shard's devices; the whole set's count and
    per-cell counts are summed once, here."""
    rows = mesh.shape[ROWS_AXIS]
    t = target_ids.shape[0]
    pad = (-t) % rows
    tids = target_ids.long()
    safe = torch.clamp_min(tids, 0)
    t_codes, t_cells = index.codes[safe], index.cell_of[safe]
    t_ids, _ = pad_rows(tids, rows)
    t_mask, _ = pad_rows(target_mask, rows)
    t_codes, _ = pad_rows(t_codes, rows)
    t_cells, _ = pad_rows(t_cells, rows)
    t_vecs = None if target_vecs is None else pad_rows(target_vecs, rows)[0]
    per = (t + pad) // rows
    parts = []
    for s in range(rows):
        sl = slice(s * per, (s + 1) * per)
        jt = ivpq_mod.build_join_tiles(
            t_codes[sl], t_cells[sl], t_mask[sl], None,
            None if t_vecs is None else t_vecs[sl], block_t=block_t,
            num_cells=index.num_cells, with_vecs=with_vecs)
        parts.append({dev: _tiles_to(jt, dev)
                      for dev in mesh.row_devices(s)})
    na = int(parts[0][mesh.devices[0][0]].codes_t.shape[1])
    lead = mesh.lead
    return {
        "jt": parts,
        "t_ids": shard_rows(t_ids, mesh),
        "t_vecs": None if t_vecs is None else shard_rows(t_vecs, mesh),
        "block_t": block_t, "inf_tile": na // block_t - 1,
        "n_tiles": na // block_t, "per_shard": per,
        "t_real": sum(p[mesh.devices[s][0]].t_real.to(lead)
                      for s, p in enumerate(parts)),
        "cell_counts": sum(p[mesh.devices[s][0]].cell_sizes.to(lead)
                           for s, p in enumerate(parts)),
    }


def _tiles_to(jt, dev: torch.device):
    """A ``JoinTiles`` with its tensors on ``dev``."""
    return jt._replace(cache={}, **{
        f: v.to(dev) for f, v in jt._asdict().items()
        if isinstance(v, torch.Tensor)})


def sharded_ivpq_join_round_budget(mesh: Mesh, queries: torch.Tensor,
                                   coarse_cent, codebook_cent, bundle: dict,
                                   statistics, *, k: int, alpha: int,
                                   pvf: int = 20, method: int = 0,
                                   confidence: float = 0.8,
                                   p_budget: int | None = None
                                   ) -> tuple[torch.Tensor, ...]:
    """Selectivity-proportional multi-device join round (JAX :632-685):
    each shard probes only the tiles of each query's selected cells within
    its slice (``models.ivpq._ivpq_round_budget``: K6/K7 for ADC, K9/K10
    for the exact method), the cell selection fed the whole set's counts;
    float LUTs (no ``lut_dtype``), as in the JAX module. Without
    ``p_budget`` each shard plans the tiles of its largest selection
    (``models.ivpq.fit_budget``), so no query's cells are cut short; the
    JAX module's power of two for the expected rows may cut them.
    → (dists, global ids, rows scanned)."""
    t_vecs = bundle["t_vecs"]

    def shard(r, j, dev, q):
        jt = bundle["jt"][r][dev]
        sel = ivpq_mod.select_tiles(
            q, _on(coarse_cent, dev), _on(statistics, dev), jt, k, alpha,
            confidence, bundle["t_real"].to(dev),
            bundle["cell_counts"].to(dev))
        p = p_budget if p_budget is not None else ivpq_mod.fit_budget(
            [sel[1]], max(bundle["n_tiles"] - 1, 1))
        vals, ids, found, _, _ = ivpq_mod._ivpq_round_budget(
            q, _on(codebook_cent, dev), jt,
            None if t_vecs is None else t_vecs.local(r, j), sel, k, pvf,
            method, False, p, "bf16", bundle["t_ids"].local(r, j), True)
        return vals, ids, found

    return _sharded_search(mesh, queries, shard, k)


def sharded_ivpq_join(mesh: Mesh, index, queries: torch.Tensor, k: int,
                      target_ids: torch.Tensor, *,
                      target_mask: torch.Tensor | None = None,
                      vectors: torch.Tensor | None = None,
                      statistics: torch.Tensor | None = None,
                      alpha: int = 3, pvf: int = 20, method: int = 0,
                      confidence: float = 0.8, max_rounds: int = 4,
                      impl: str = "dense"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-device multi-round IVPQ kNN-join (JAX :487-578): targets
    sharded over "rows", alpha doubling across rounds while some query has
    fewer than k candidates (ivpq_search_in.c:639-684); each query keeps its
    first resolved round. ``impl="budget"`` probes each shard's tiles
    (:func:`sharded_ivpq_join_round_budget`), ``"dense"`` scans each
    shard's whole slice and masks (:func:`sharded_ivpq_join_round`).
    ``vectors`` is the store table methods 1 and 2 read."""
    if impl not in ("dense", "budget"):
        raise ValueError(f"impl must be dense|budget, got {impl!r}")
    if method in (ivpq_mod.EXACT_CALC, ivpq_mod.PQ_PV_CALC) \
            and vectors is None:
        raise ValueError("methods 1/2 need raw vectors for exact distances")
    dev = index.codes.device
    tids = torch.as_tensor(target_ids, device=dev).long()
    if target_mask is None:
        target_mask = torch.ones(tids.shape, dtype=torch.bool, device=dev)
    if statistics is None:
        statistics = ivpq_mod.uniform_statistics(index.coarse.cell_counts)
    safe = torch.clamp_min(tids, 0)
    t_vecs = None if method == ivpq_mod.PQ_CALC else vectors[safe]
    cc = replicate(index.coarse.centroids, mesh)
    cb = replicate(index.codebook.centroids, mesh)
    stats = replicate(statistics.to(dev), mesh)

    if impl == "budget":
        bundle = shard_join_tiles(index, tids, target_mask, t_vecs, mesh,
                                  with_vecs=method == ivpq_mod.EXACT_CALC)

        def round_(a):
            return sharded_ivpq_join_round_budget(
                mesh, queries, cc, cb, bundle, stats, k=k, alpha=a, pvf=pvf,
                method=method, confidence=confidence)
    else:
        targets = shard_join_targets(index, tids, target_mask, t_vecs, mesh)

        def round_(a):
            return sharded_ivpq_join_round(
                mesh, queries, cc, cb, statistics=stats, k=k, alpha=a,
                pvf=pvf, method=method, confidence=confidence, **targets)

    cur_alpha = int(alpha)
    vals, ids, retrieved = round_(cur_alpha)
    resolved = retrieved >= k
    for _ in range(max_rounds - 1):
        if bool(torch.all(resolved)):
            break
        cur_alpha += cur_alpha
        v2, i2, retrieved = round_(cur_alpha)
        upd = ~resolved
        vals = torch.where(upd[:, None], v2, vals)
        ids = torch.where(upd[:, None], i2, ids)
        resolved = resolved | (retrieved >= k)
    return vals, ids
