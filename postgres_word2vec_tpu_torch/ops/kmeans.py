"""k-means — codebook training for every index family, on torch tensors.

Counterpart of ``postgres_word2vec_tpu/ops/kmeans.py``. Assignment is one
matmul + argmin per row chunk (the ``‖x‖²`` term is assignment-invariant
and dropped where only the argmin matters); the update step is a
``scatter_add``. The JAX package ``vmap``s one k-means over the m
subspaces; here the subspace axis is a batch dimension written out:
every function below takes ``x`` as ``(n, d)`` or ``(m, n, d)`` with
centroids ``(k, d)`` or ``(m, k, d)``. The flat :func:`kmeans` (the IVFADC
coarse quantizer) is the same Lloyd run with no leading dims.

float32 matmuls here must not run in TF32 (the JAX package pins
``Precision.HIGHEST``); the public entry points run under
:func:`~postgres_word2vec_tpu_torch.ops.vector_ops.no_tf32`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (…, k, d) float32
    counts: torch.Tensor       # (…, k) int32 — sizes at the final assignment
    distortion: torch.Tensor   # (…,) mean point↔centroid distance


def _chunk_scores(xc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x·cᵀ`` for one row chunk, batched over leading dims."""
    return torch.matmul(xc.float(), c.transpose(-1, -2))


@no_tf32()
def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ``(n, d) × (k, d) → (n, k)`` float32: one
    matmul plus rank-1 corrections, clamped at 0 against cancellation."""
    x = x.float()
    c = c.float()
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)
    return torch.clamp_min(xx - 2.0 * (x @ c.t()) + cc[None, :], 0.0)


@no_tf32()
def assign(x: torch.Tensor, centroids: torch.Tensor, *,
           chunk_size: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment ``(…, n, d) → (…, n)`` int64, chunked
    over n. The chunk body is one matmul + bias + argmin."""
    c = centroids.float()
    cc = torch.sum(c * c, dim=-1).unsqueeze(-2)            # (…, 1, k)
    outs = []
    for s in range(0, x.shape[-2], chunk_size):
        xc = x[..., s:s + chunk_size, :]
        outs.append(torch.argmin(cc - 2.0 * _chunk_scores(xc, c), dim=-1))
    return torch.cat(outs, dim=-1)


def assign_with_dist(x: torch.Tensor, centroids: torch.Tensor, *,
                     chunk_size: int = 65536
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment + true squared distance, chunked over
    n → ((…, n) int64, (…, n) float32)."""
    c = centroids.float()
    cc = torch.sum(c * c, dim=-1).unsqueeze(-2)
    a_out, d_out = [], []
    for s in range(0, x.shape[-2], chunk_size):
        xf = x[..., s:s + chunk_size, :].float()
        xx = torch.sum(xf * xf, dim=-1, keepdim=True)
        d = torch.clamp_min(xx - 2.0 * _chunk_scores(xf, c) + cc, 0.0)
        dmin, a = torch.min(d, dim=-1)
        a_out.append(a)
        d_out.append(dmin)
    return torch.cat(a_out, dim=-1), torch.cat(d_out, dim=-1)


def _lloyd_step_repair(x: torch.Tensor, centroids: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd step that reseeds EMPTY clusters onto the worst-fit points
    (largest distance to their assigned centroid): empty cluster #r takes
    the r-th worst-fit point. Batched over the leading dims of ``x``
    ``(…, n, d)`` / ``centroids`` ``(…, k, d)``.

    Returns (new centroids, counts int32, mean distance distortion)."""
    k, d = centroids.shape[-2:]
    n = x.shape[-2]
    xf = x.float()
    a, dmin = assign_with_dist(xf, centroids)
    sums = torch.zeros(*centroids.shape, dtype=torch.float32,
                       device=x.device)
    sums.scatter_add_(-2, a.unsqueeze(-1).expand(*a.shape, d), xf)
    counts = torch.zeros(*centroids.shape[:-1], dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(-1, a, torch.ones_like(dmin))
    cnt = counts.unsqueeze(-1)
    new_c = torch.where(cnt > 0, sums / torch.clamp_min(cnt, 1.0),
                        centroids.float())
    empty = counts <= 0
    _, worst_idx = topk_ops.top_k_largest(dmin, min(k, n))
    rank = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=-1) - 1,
                       0, worst_idx.shape[-1] - 1)
    pick = torch.gather(worst_idx, -1, rank)                 # (…, k)
    reseed = torch.gather(xf, -2, pick.unsqueeze(-1).expand(*pick.shape, d))
    new_c = torch.where(empty.unsqueeze(-1), reseed, new_c)
    # distortion matches scipy's: mean (non-squared) distance.
    distortion = torch.mean(torch.sqrt(dmin), dim=-1)
    return new_c, counts.to(torch.int32), distortion


@no_tf32()
def kmeans_plus_plus_init(generator: torch.Generator, x: torch.Tensor,
                          k: int) -> torch.Tensor:
    """k-means++ (D² sampling) initialization: ``(…, n, d) → (…, k, d)``.

    k − 1 sequential draws; each is one (n, d) distance update, batched
    over the leading dims. A draw ∝ D² is Gumbel-top-1 over log D²."""
    xf = x.float()
    *lead, n, d = xf.shape
    xx = torch.sum(xf * xf, dim=-1)                           # (…, n)

    def take(idx):                                            # (…,) → (…, d)
        return torch.gather(
            xf, -2, idx.reshape(*lead, 1, 1).expand(*lead, 1, d)
        ).squeeze(-2)

    def dist_to(c):                                           # (…, d)
        s = torch.matmul(xf, c.unsqueeze(-1)).squeeze(-1)
        return torch.clamp_min(
            xx - 2.0 * s + torch.sum(c * c, dim=-1, keepdim=True), 0.0)

    first = take(torch.randint(0, n, tuple(lead), generator=generator,
                               device=x.device))
    cents = [first]
    dmin = dist_to(first)
    for _ in range(k - 1):
        u = torch.rand(dmin.shape, generator=generator, device=x.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
        idx = torch.argmax(torch.log(torch.clamp_min(dmin, 1e-30)) + gumbel,
                           dim=-1)
        c = take(idx)
        cents.append(c)
        dmin = torch.minimum(dmin, dist_to(c))
    return torch.stack(cents, dim=-2)


def _kmeans_single(generator: torch.Generator, x: torch.Tensor, k: int,
                   iters: int, init: str) -> KMeansResult:
    """One k-means run (``iters`` repaired Lloyd steps), batched over the
    leading dims of ``x``."""
    *lead, n, d = x.shape
    if init == "kmeans++":
        c = kmeans_plus_plus_init(generator, x, k)
    elif init == "sample":
        # k distinct rows per batch entry: top-k of uniform keys.
        u = torch.rand(*lead, n, generator=generator, device=x.device)
        idx = torch.topk(u, k, dim=-1).indices
        c = torch.gather(x.float(), -2,
                         idx.unsqueeze(-1).expand(*idx.shape, d))
    else:
        raise ValueError(f"init must be 'sample' or 'kmeans++', got {init!r}")
    counts = torch.zeros(*lead, k, dtype=torch.int32, device=x.device)
    distortion = torch.zeros(tuple(lead), device=x.device)
    for _ in range(iters):
        c, counts, distortion = _lloyd_step_repair(x, c)
    return KMeansResult(c, counts, distortion)


@no_tf32()
def kmeans_subspaces(generator: torch.Generator, x_sub: torch.Tensor,
                     k: int, iters: int = 10, *, restarts: int = 1,
                     init: str = "sample") -> KMeansResult:
    """Product-quantizer training: ``(m, n, dsub) → (m, k, dsub)``.

    All m subspace runs go as one batch (parity with ``create_quantizer``'s
    per-subspace loop, quantizer_creation.py:13-29). With ``restarts > 1``
    each subspace keeps its own best restart (scipy ``kmeans(iter=R)``
    semantics)."""
    best = None
    for _ in range(max(restarts, 1)):
        res = _kmeans_single(generator, x_sub, k, iters, init)
        if best is None:
            best = res
            continue
        take_new = res.distortion < best.distortion           # (m,)
        best = KMeansResult(
            torch.where(take_new[:, None, None], res.centroids,
                        best.centroids),
            torch.where(take_new[:, None], res.counts, best.counts),
            torch.minimum(res.distortion, best.distortion))
    return best


def split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(n, d) → (m, n, d/m)`` — subspace view used by PQ training."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dimension {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


@no_tf32()
def kmeans(generator: torch.Generator, x: torch.Tensor, k: int,
           iters: int = 10, *, restarts: int = 1,
           init: str = "sample") -> KMeansResult:
    """Flat Lloyd's k-means ``(n, d) → (k, d)`` with final-assignment
    counts (scipy ``kmeans(…, iter=restarts)`` parity,
    quantizer_creation.py:25: the restart with the lowest distortion
    wins). Same repaired Lloyd steps and inits as the subspace runs."""
    best = None
    for _ in range(max(restarts, 1)):
        res = _kmeans_single(generator, x, k, iters, init)
        if best is None or float(res.distortion) < float(best.distortion):
            best = res
    return best


def _encode_chunks(x: torch.Tensor, codebooks: torch.Tensor,
                   chunk_size: int, prepare) -> torch.Tensor:
    """Nearest-codeword codes of ``prepare(start, x_chunk_f32)`` per row
    chunk → ``(n, m)`` uint8 (k ≤ 256) or int16. Chunked over rows before
    the subspace split, so no transformed float32 copy of the whole table
    ever exists."""
    m, k, dsub = codebooks.shape
    n, d = x.shape
    if d != m * dsub:
        raise ValueError(f"dim {d} != m·dsub = {m}·{dsub}")
    cb = codebooks.float()
    cc = torch.sum(cb * cb, dim=-1).unsqueeze(1)              # (m, 1, k)
    out = torch.empty(n, m, dtype=torch.uint8 if k <= 256 else torch.int16,
                      device=x.device)
    for s in range(0, n, chunk_size):
        xf = prepare(s, x[s:s + chunk_size].float())
        xs = xf.reshape(-1, m, dsub).permute(1, 0, 2)         # (m, c, dsub)
        scores = torch.bmm(xs, cb.transpose(1, 2))            # (m, c, k)
        codes = torch.argmin(cc - 2.0 * scores, dim=-1)       # (m, c)
        out[s:s + chunk_size] = codes.t().to(out.dtype)
    return out


@no_tf32()
def encode_subspaces(x: torch.Tensor, codebooks: torch.Tensor, *,
                     chunk_size: int = 65536,
                     rotation: torch.Tensor | None = None) -> torch.Tensor:
    """PQ-encode: ``(n, d) × (m, k, dsub) → (n, m)`` small-int codes.

    Neither a transposed nor a rotated float32 copy of the full table ever
    exists (at 3M×300 it would be 3.6 GB). ``rotation`` is an optional
    (d, d) OPQ basis applied per chunk. Code dtype is uint8 when k ≤ 256,
    else int16.
    """
    rot = None if rotation is None else rotation.float()
    return _encode_chunks(x, codebooks, chunk_size,
                          lambda s, xf: xf if rot is None else xf @ rot)


@no_tf32()
def encode_residual_subspaces(x: torch.Tensor,
                              coarse_centroids: torch.Tensor,
                              assignments: torch.Tensor,
                              codebooks: torch.Tensor, *,
                              chunk_size: int = 65536) -> torch.Tensor:
    """Fused residual PQ encode: ``codes[i] = encode(x[i] −
    coarse[assignments[i]])`` → ``(n, m)``, chunk by chunk, so the full
    residual table (3.6 GB at 3M×300) is never materialized."""
    coarse = coarse_centroids.float()
    a = assignments.long()
    return _encode_chunks(
        x, codebooks, chunk_size,
        lambda s, xf: xf - coarse[a[s:s + xf.shape[0]]])
