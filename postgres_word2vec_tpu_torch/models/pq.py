"""Product-quantization index: training, encoding, ADC search.

Counterpart of ``postgres_word2vec_tpu/models/pq.py``. Parity targets: the
build driver pq_index.py (codebook k-means + encode + counts), the search
kernel ``pq_search`` (freddy.c:26-170) and the post-verified wrapper
``k_nearest_neighbour_pq_pv`` (sql:625-662). Defaults follow the shipped
configs (m=12, k=256 → uint8 codes).

On a CUDA device the exhaustive scan runs through the hand-written scan
kernels (``ops/kernels.py``: K2 dense, K4 binned, and over int8 LUTs K3
dense, K5 binned) over a cached subspace-major ``(m, N)`` code layout; on
the CPU it runs the plain chunked gather (``ops/adc.py``), or for the int8
modes the kernels' plain versions. The in-set search
(:meth:`PQIndex.search_in`) gathers the targets' columns of that layout
into a contiguous ``(m, T)`` table and scores it with K2 on the card; on
the CPU it runs the plain gather. Online insert (:meth:`PQIndex.add`)
runs the reference's sequential running-mean codebook update
(:func:`online_codebook_update`).
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from postgres_word2vec_tpu_torch.ops import adc, kmeans, lut
from postgres_word2vec_tpu_torch.ops import kernels
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32


class PQCodebook(NamedTuple):
    """``(m, k, dsub)`` centroids + ``(m, k)`` assignment counts (the
    counts back the reference's running-mean online update,
    index_utils.c:684-736)."""
    centroids: torch.Tensor   # (m, k, dsub) float32
    counts: torch.Tensor      # (m, k) int32


def _sample_rows(generator: torch.Generator, vectors: torch.Tensor,
                 size: int | None) -> torch.Tensor:
    """``size`` distinct rows drawn uniformly, or the whole table."""
    n = vectors.shape[0]
    if size is None or size >= n:
        return vectors
    idx = torch.randperm(n, generator=generator,
                         device=generator.device)[:size]
    return vectors[idx.to(vectors.device)]


def train_codebook(generator: torch.Generator, vectors: torch.Tensor,
                   m: int, k: int, *, train_size: int | None = None,
                   iters: int = 10, restarts: int = 1,
                   init: str = "sample") -> PQCodebook:
    """Train an m×k product codebook on a (sampled) training set."""
    train = _sample_rows(generator, vectors, train_size)
    res = kmeans.kmeans_subspaces(generator, kmeans.split_subspaces(train, m),
                                  k=k, iters=iters, restarts=restarts,
                                  init=init)
    return PQCodebook(res.centroids, res.counts)


def _counts(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Per-subspace code histogram ``(n, m) → (m, k)`` int32."""
    m = codes.shape[1]
    counts = torch.zeros(m, k, dtype=torch.int64, device=codes.device)
    counts.scatter_add_(1, codes.t().long(),
                        torch.ones(m, codes.shape[0], dtype=torch.int64,
                                   device=codes.device))
    return counts.to(torch.int32)


def recount(codebook: PQCodebook, codes: torch.Tensor) -> PQCodebook:
    """Recompute counts from a full code table (determine_counts parity)."""
    return PQCodebook(codebook.centroids,
                      _counts(codes, codebook.centroids.shape[1]))


def online_codebook_update(codebook: PQCodebook, new_vectors: torch.Tensor
                           ) -> tuple[PQCodebook, torch.Tensor]:
    """Sequential running-mean update for a batch of inserted vectors →
    (updated codebook, ``(n_new, m)`` int32 codes).

    For each vector in turn, per subspace: assign the nearest centroid,
    ``count += 1``, ``c += (x − c)/count`` — the reference's incremental
    k-means (index_utils.c:908-957). Each row sees the updates of the rows
    before it, so this is a loop over the rows, not a batched op (the JAX
    package's ``online_codebook_update``, a ``lax.scan``, pq.py:80-108).
    The caller's codebook is not modified."""
    m, k, dsub = codebook.centroids.shape
    cents = codebook.centroids.float().clone()
    counts = codebook.counts.to(torch.int32).clone()
    xs = new_vectors.float().reshape(-1, m, dsub)
    codes = torch.empty(xs.shape[0], m, dtype=torch.int32, device=xs.device)
    sub = torch.arange(m, device=xs.device)
    one = torch.ones((), device=xs.device)
    for i in range(xs.shape[0]):
        x = xs[i]                                            # (m, dsub)
        code = torch.argmin(torch.sum((x[:, None, :] - cents) ** 2, dim=-1),
                            dim=-1)                          # (m,)
        counts[sub, code] += 1
        inv = one / counts[sub, code].float()
        c = cents[sub, code]
        cents[sub, code] = c + inv[:, None] * (x - c)
        codes[i] = code
    return PQCodebook(cents, counts), codes


def reconstruct(codes: torch.Tensor, codebooks: torch.Tensor
                ) -> torch.Tensor:
    """Decode PQ codes back to vectors: ``(n, m) × (m, k, dsub) → (n, d)``."""
    m, k, dsub = codebooks.shape
    c = codes.long()
    parts = [codebooks[j][c[:, j]] for j in range(m)]        # m × (n, dsub)
    return torch.cat(parts, dim=1)


def _warm_lloyd(x: torch.Tensor, c0: torch.Tensor, iters: int
                ) -> kmeans.KMeansResult:
    """``iters`` repaired Lloyd steps from ``c0``, batched over subspaces."""
    c = c0.float()
    counts = torch.zeros(c.shape[:-1], dtype=torch.int32, device=c.device)
    dist = torch.zeros(c.shape[:-2], device=c.device)
    for _ in range(iters):
        c, counts, dist = kmeans._lloyd_step_repair(x, c)
    return kmeans.KMeansResult(c, counts, dist)


@no_tf32()
def train_opq_rotation(generator: torch.Generator, train: torch.Tensor,
                       m: int, k: int, *, opq_iters: int = 8,
                       kmeans_iters: int = 5
                       ) -> tuple[torch.Tensor, PQCodebook]:
    """OPQ (non-parametric): alternate subspace k-means with the orthogonal
    Procrustes solve ``R = UVᵀ, USVᵀ = SVD(XᵀX̂)`` minimizing
    ``‖X·R − reconstruction‖²``. Rotations preserve L2, so search
    semantics are unchanged. Returns ``(rotation (d, d), codebook trained
    in the rotated basis)``."""
    x = train.float()
    rot = torch.eye(x.shape[1], dtype=torch.float32, device=x.device)
    cb = None
    for _ in range(opq_iters):
        y = x @ rot
        sub = kmeans.split_subspaces(y, m)
        if cb is None:
            res = kmeans.kmeans_subspaces(generator, sub, k=k,
                                          iters=kmeans_iters,
                                          init="kmeans++")
        else:
            # warm-start Lloyd from the previous rotation's codebook.
            res = _warm_lloyd(sub, cb, kmeans_iters)
        cb = res.centroids
        recon = reconstruct(kmeans.encode_subspaces(y, cb), cb)
        u, _, vt = torch.linalg.svd(x.t() @ recon, full_matrices=False)
        rot = u @ vt
    codes = kmeans.encode_subspaces(x @ rot, cb)
    return rot, PQCodebook(cb, _counts(codes, k))


#: Below this shortlist width the post-verify shortlist stays exact over
#: the dense scan (the analogy path's tiny pvf+3 shortlists).
_APPROX_SHORTLIST_MIN = 100


def _resolve_shortlist(shortlist: str, k: int, pvf: int, impl: str) -> str:
    """Resolve the PV shortlist policy: "auto" → "approx" (the binned
    scan's bin survivors) on the kernel path for wide shortlists
    (k·pvf ≥ 100), "exact" otherwise. ``impl`` is the resolved scan
    implementation; the plain path keeps the exact shortlist."""
    if shortlist not in ("auto", "exact", "approx"):
        raise ValueError(f"shortlist must be auto|exact|approx, "
                         f"got {shortlist!r}")
    if shortlist != "auto":
        return shortlist
    if impl.startswith("kernel") and k * pvf >= _APPROX_SHORTLIST_MIN:
        return "approx"
    return "exact"


#: the most training rows the anisotropic refinement takes
_ANISO_ROWS = 100_000


@dataclasses.dataclass
class PQIndex:
    """Exhaustive-scan PQ index: packed codes + codebook on one device.

    ``rotation``: optional OPQ orthogonal basis (codes live in the rotated
    space; queries are rotated before LUT construction).
    """

    codebook: PQCodebook
    codes: torch.Tensor                     # (n, m) uint8 (k ≤ 256) or int16
    rotation: torch.Tensor | None = None    # (d, d) OPQ rotation or None

    _codes_t: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)

    _BLOCK_N = 2048
    _DENSE_SCAN_BYTES = 6_442_450_944  # 6 GiB of (B, N) float32 distances

    def transposed_codes(self) -> torch.Tensor:
        """Cached subspace-major ``(m, N)`` codes in the storage dtype. Not
        padded: the scan kernels mask the ragged edge."""
        if self._codes_t is None:
            self._codes_t = self.codes.t().contiguous()
        return self._codes_t

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def m(self) -> int:
        return int(self.codebook.centroids.shape[0])

    @property
    def k(self) -> int:
        return int(self.codebook.centroids.shape[1])

    # ------------------------------------------------------------ building
    @classmethod
    def build(cls, generator: torch.Generator, vectors: torch.Tensor, *,
              m: int = 12, k: int = 256, train_size: int | None = 100_000,
              iters: int = 10, restarts: int = 1, init: str = "sample",
              opq_iters: int = 0, aniso_eta: float | None = None,
              aniso_iters: int = 4) -> "PQIndex":
        """Train + encode (pq_index.py ``main`` parity; defaults from
        pq_config.json: m=12, k=256, train_size=100k). ``opq_iters > 0``
        learns an OPQ rotation first.

        ``aniso_eta`` (e.g. 2–4) enables anisotropic (score-aware)
        refinement: the trained codebooks get ``aniso_iters`` rounds of
        weighted Lloyd that penalize the ranking-relevant PARALLEL residual
        η× (:func:`ops.kmeans.anisotropic_refine`) on at most 100,000
        training rows (the refinement's (n, dsub²) intermediate must not
        scale with the table), and the table is encoded under the same
        metric. It stacks with OPQ. LUTs and search are unchanged; later
        ``add()`` rows encode plain-L2, as in the JAX package
        (pq.py:340-410)."""
        if opq_iters > 0:
            train = _sample_rows(generator, vectors, train_size)
            rot, cb = train_opq_rotation(generator, train, m, k,
                                         opq_iters=opq_iters,
                                         kmeans_iters=max(iters // 4, 3))
            if aniso_eta is not None:
                ref = _sample_rows(generator, train, _ANISO_ROWS)
                cb = PQCodebook(kmeans.anisotropic_refine(
                    kmeans.split_subspaces(ref.float() @ rot, m),
                    cb.centroids, aniso_eta, aniso_iters), cb.counts)
            codes = kmeans.encode_subspaces(vectors, cb.centroids,
                                            rotation=rot,
                                            aniso_eta=aniso_eta)
            return cls(recount(cb, codes), codes, rotation=rot)
        cb = train_codebook(generator, vectors, m, k, train_size=train_size,
                            iters=iters, restarts=restarts, init=init)
        if aniso_eta is not None:
            ref = _sample_rows(generator, vectors,
                               min(train_size or _ANISO_ROWS, _ANISO_ROWS))
            cb = PQCodebook(kmeans.anisotropic_refine(
                kmeans.split_subspaces(ref, m), cb.centroids, aniso_eta,
                aniso_iters), cb.counts)
        codes = kmeans.encode_subspaces(vectors, cb.centroids,
                                        aniso_eta=aniso_eta)
        return cls(recount(cb, codes), codes)

    def _rotate(self, x: torch.Tensor) -> torch.Tensor:
        if self.rotation is None:
            return x
        return x.float() @ self.rotation

    def encode(self, vectors: torch.Tensor) -> torch.Tensor:
        return kmeans.encode_subspaces(vectors, self.codebook.centroids,
                                       rotation=self.rotation)

    # ------------------------------------------------------------- search
    _IMPLS = ("kernel", "kernel_binned", "kernel_int8",
              "kernel_binned_int8", "plain")

    def _resolve_impl(self, impl: str | None) -> str:
        """``None`` → "kernel" on a CUDA device, "plain" on the CPU."""
        if impl is None:
            return "kernel" if self.codes.is_cuda else "plain"
        if impl not in self._IMPLS:
            raise ValueError(f"impl must be one of {'|'.join(self._IMPLS)}, "
                             f"got {impl!r}")
        return impl

    def _search_plan(self, n_queries: int, approx: bool,
                     impl: str | None) -> tuple[str, torch.Tensor, int]:
        """Resolve (mode, codes-arg, valid_n) for a search (the JAX
        ``_search_plan``, pq.py:441-474).

        "binned" (K4) for approx requests on the kernel path and for
        dense buffers past the 6 GiB bar; "dense" (K2) for exact kernel
        requests; "plain" (chunked gather) otherwise. An ``_int8`` impl
        suffix selects the int8-LUT twins "dense_i8" (K3) and "binned_i8"
        (K5). "kernel_int8" is a LUT dtype preference (the engine's
        ``pq_lut_dtype`` knob), not an exactness demand: past the bar it
        degrades to "binned_i8" with a warning, where "kernel" raises."""
        impl_requested = impl
        impl = self._resolve_impl(impl)
        if impl == "plain":
            return "plain", self.codes, self.size
        sfx = "_i8" if impl.endswith("_int8") else ""
        base = impl.removesuffix("_int8")
        ct = self.transposed_codes()
        if base == "kernel_binned" or approx:
            return "binned" + sfx, ct, self.size
        dense_bytes = n_queries * ct.shape[1] * 4
        if dense_bytes > self._DENSE_SCAN_BYTES:
            # Past the bar only the binned kernel can run, and its results
            # are bin survivors: never degrade an explicit exact request.
            if impl_requested == "kernel":
                raise ValueError(
                    f"impl='kernel' dense distance buffer would be "
                    f"{dense_bytes / 2**30:.1f} GiB (> "
                    f"{self._DENSE_SCAN_BYTES / 2**30:.0f} GiB bar); pass "
                    "impl='kernel_binned' (approximate) or reduce the "
                    "query batch.")
            warnings.warn(
                "PQIndex.search: dense (B, N) buffer exceeds the "
                f"{self._DENSE_SCAN_BYTES / 2**30:.0f} GiB bar; using the "
                "approximate binned kernel. Pass impl='kernel_binned' to "
                "silence, or chunk queries for exact results.",
                stacklevel=3)
            return "binned" + sfx, ct, self.size
        return "dense" + sfx, ct, self.size

    def _scan_top_k(self, queries: torch.Tensor, k: int, mode: str,
                    codes_arg: torch.Tensor, valid_n: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Rotation → LUTs → scan → top-k."""
        luts = lut.build_luts(self._rotate(queries), self.codebook.centroids)
        lut_dtype = "int8" if mode.endswith("_i8") else "bf16"
        if mode.startswith("binned"):
            return kernels.adc_top_k_binned(luts, codes_arg, k,
                                            valid_n=valid_n,
                                            block_n=self._BLOCK_N,
                                            lut_dtype=lut_dtype)
        if mode.startswith("dense"):
            return kernels.adc_top_k(luts, codes_arg, k, valid_n=valid_n,
                                     lut_dtype=lut_dtype)
        return adc.adc_top_k(luts, codes_arg, k)

    def search(self, queries: torch.Tensor, k: int, *, approx: bool = False,
               impl: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exhaustive ADC top-k (``pq_search`` parity) → (sqdists, ids).

        ``impl``: "kernel" (dense scan K2), "kernel_binned" (binned scan
        K4 — bin survivors, approximate), "kernel_int8" /
        "kernel_binned_int8" (the same over per-query int8 LUTs, K3 / K5),
        "plain" (chunked gather), or None for "kernel" on a CUDA device and
        "plain" on the CPU."""
        mode, codes_arg, valid_n = self._search_plan(queries.shape[0],
                                                     approx, impl)
        return self._scan_top_k(queries, k, mode, codes_arg, valid_n)

    def search_pv(self, queries: torch.Tensor, k: int, pvf: int,
                  vectors: torch.Tensor, *, impl: str | None = None,
                  shortlist: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """ADC shortlist of k·pvf then exact re-rank
        (``k_nearest_neighbour_pq_pv`` parity, sql:625-662).

        ``shortlist``: "exact" (exact top-k over the dense scan), "approx"
        (exact top-k over the binned scan's bin survivors), or "auto" —
        "approx" on the kernel path when k·pvf ≥ 100, "exact" otherwise.
        The final re-rank is exact L2 over ``vectors`` either way."""
        approx_sl = _resolve_shortlist(shortlist, k, pvf,
                                       self._resolve_impl(impl)) == "approx"
        mode, codes_arg, valid_n = self._search_plan(queries.shape[0],
                                                     approx_sl, impl)
        cd, ci = self._scan_top_k(queries, k * pvf, mode, codes_arg,
                                  valid_n)
        return adc.post_verify(queries, ci, cd, vectors, k)

    def adc_in(self, luts: torch.Tensor, target_ids: torch.Tensor
               ) -> torch.Tensor:
        """ADC distances of ``(B, m, k)`` float32 LUTs over a target id set
        → ``(B, T)`` float32 (ids < 0 read row 0; the caller masks them).
        On the card: the targets' columns of :meth:`transposed_codes`
        gathered into a contiguous ``(m, T)`` table, scored by K2; on the
        CPU: the plain gather (``adc.adc_distances``)."""
        safe = torch.clamp_min(target_ids.long(), 0)
        if not self.codes.is_cuda:
            return adc.adc_distances(luts, self.codes[safe])
        table = self.transposed_codes().index_select(1, safe)
        return kernels.adc_scan(luts, table)

    def search_in(self, queries: torch.Tensor, k: int,
                  target_ids: torch.Tensor,
                  target_mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Target-restricted ADC top-k (``pq_search_in`` /
        ``pq_search_in_batch`` parity, the kNN-join baseline; JAX
        pq.py:534-541) → (sqdists, global int64 ids), −1 and +inf past the
        real targets. Float32 LUTs whatever the engine's ``pq_lut_dtype``,
        as in the JAX package. On the card the targets' codes are scored
        by K2 (:meth:`adc_in`); on the CPU by ``adc.adc_top_k_in``."""
        if target_mask is None:
            target_mask = torch.ones(target_ids.shape, dtype=torch.bool,
                                     device=target_ids.device)
        luts = lut.build_luts(self._rotate(queries), self.codebook.centroids)
        if not self.codes.is_cuda:
            return adc.adc_top_k_in(luts, self.codes, target_ids,
                                    target_mask, k)
        return adc.top_k_in(self.adc_in(luts, target_ids), target_ids,
                            target_mask, k)

    def add(self, new_vectors: torch.Tensor) -> "PQIndex":
        """Online insert: running-mean codebook update in the index's (OPQ)
        basis + appended codes (``insert_batch``'s PQ leg,
        freddy.c:1616-1629). Returns a new index; its transposed code table
        is built anew on the next kernel search, so the new rows are
        scanned."""
        cb, new_codes = online_codebook_update(self.codebook,
                                               self._rotate(new_vectors))
        codes = torch.cat([self.codes, new_codes.to(self.codes.dtype)])
        return PQIndex(cb, codes, rotation=self.rotation)

    # --------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        """Write the JAX package's ``pq.npz`` fields: ``centroids``,
        ``counts``, ``codes`` and, with OPQ, ``rotation``."""
        extra = {}
        if self.rotation is not None:
            extra["rotation"] = self.rotation.cpu().numpy()
        np.savez_compressed(
            path, centroids=self.codebook.centroids.cpu().numpy(),
            counts=self.codebook.counts.cpu().numpy(),
            codes=self.codes.cpu().numpy(), **extra)

    @classmethod
    def load(cls, path: str | Path, *,
             device: torch.device | str | None = None) -> "PQIndex":
        """An index saved by either package, on the card unless ``device``
        names another."""
        from postgres_word2vec_tpu_torch.utils.convert import pq_from_numpy

        with np.load(path, allow_pickle=False) as f:
            arrays = {name: f[name] for name in f.files}
        return pq_from_numpy(arrays, device)
