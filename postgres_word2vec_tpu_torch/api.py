"""FREDDY-compatible engine.

Counterpart of ``postgres_word2vec_tpu/api.py``, from a ``VectorStore``
through ``Freddy.build``:

- the ``knn`` façade over the whole store in five families: exact
  (``k_nearest_neighbour``), PQ (``k_nearest_neighbour_pq``), PQ with
  post-verification (``k_nearest_neighbour_pq_pv``), IVFADC
  (``k_nearest_neighbour_ivfadc``, widening search) and IVFADC with
  post-verification (``k_nearest_neighbour_ivfadc_pv``), plus the batch
  façade ``knn_batch`` (IVFADC by default);
- the kNN-join: ``knn_join`` / ``knn_in_ivpq_batch`` / ``knn_in_ivpq`` over
  the IVPQ index with ``alpha``, ``method``, ``confidence``, ``pvf``,
  statistics tables (``create_statistics``) and reusable target handles
  (``prepare_targets``), and the exact join baseline
  ``knn_search_in_batch``;
- the int8 configuration: ``pq_lut_dtype="int8"`` (the PQ scans and the
  join's budget round over int8 LUTs, kernels K3, K5 and K8 on the card)
  and ``exact_dtype="int8"``;
- online insert, ``insert_batch``: new multi-word terms appended to the
  store and to every built index;
- the in-set family ``knn_in`` (exact, PQ through K2 on the card) with its
  batched matrix cores and the PQ join baseline ``knn_in_pq_batch``, and
  the TRACK stage breakdown (``set_track_stages``);
- analogy (3CosAdd, 3CosMul, pair direction; PQ-, IVFADC- and
  IVPQ-accelerated and in-set variants), grouping (exact and on PQ codes),
  clustering (exact, PQ, IVPQ joins), ``tokenize`` / ``tokenize_raw``;
- ``autotune``, ``autotune_join`` and ``warmup``;
- row sharding, ``enable_sharding`` (or ``mesh=`` in ``build`` / ``load``):
  the vector, PQ code and IVFADC tables split over the rows of a device
  mesh (``parallel/sharding.py``) and the kNN, in-set and join cores
  routed through the sharded searches.

The dispatch registry (sql:78-132), runtime parameters (sql:188-202),
result shapes (``(word, similarity)`` rows, ``(query, word, similarity)``
for batches and joins, similarity = 1 − d²/2, sql:511) and the on-disk
engine directory are the JAX engine's, so a directory saved by the JAX
``Freddy.save`` loads here and the other way round. Every method of the
JAX engine is ported (:data:`NOT_PORTED` is empty).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex, PQ_CALC,
                                                     PreparedJoin,
                                                     build_statistics)
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import kernels, lut
from postgres_word2vec_tpu_torch.ops import vector_ops as vo
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32
from postgres_word2vec_tpu_torch.parallel import sharding
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils import convert
from postgres_word2vec_tpu_torch.utils.device import resolve_device
from postgres_word2vec_tpu_torch.utils.tracker import (GLOBAL_TRACKER, host,
                                                       host_reads)


@dataclasses.dataclass
class RuntimeParams:
    """Runtime-settable parameters with the reference defaults (sql:188-202).
    Same fields as the JAX engine's, so ``engine.json`` round-trips."""

    pvf: int = 20                       # post-verification factor
    w: int = 3                          # IVFADC probe width (PARAM_W)
    alpha: int = 3                      # IVPQ selectivity
    method: int = PQ_CALC               # IVPQ distance method flag
    use_targetlist: bool = True
    confidence: float = 0.8
    long_codes_threshold: float = 1e7
    statistics_table: str | None = None
    pq_lut_dtype: str = "bf16"          # "bf16" | "int8"
    pv_shortlist: str = "auto"          # "auto" | "exact" | "approx"


#: Default dispatch registry (sql:188-202).
DEFAULT_DISPATCH = {
    "knn": "k_nearest_neighbour",
    "knn_in": "knn_in_exact",
    "knn_batch": "k_nearest_neighbour_ivfadc_batch",
    "knn_join": "knn_search_in_batch",
    "analogy": "analogy_3cosadd",
    "analogy_in": "analogy_3cosadd_in",
    "groups": "grouping_func",
    "cluster": "cluster_exact",
}

class NoMatrixCore(LookupError):
    """The dispatched ``knn_in`` impl has no fixed-shape batched matrix
    core (JAX api.py:79-84). A sentinel of its own, so a caller's
    fallback cannot swallow an unrelated ``KeyError``."""


class Freddy:
    """The engine: vocabulary + vector store + index families + config, on
    the store's device."""

    #: ``build(preset=...)`` bundles (explicit keyword arguments win).
    PRESETS = {
        "reference": dict(opq_iters=0),
        "quality": dict(pq_m=60, pq_k=16, opq_iters=10, ivfadc_m=60,
                        ivfadc_k=16, ivpq_m=60, ivpq_k=16, iters=25,
                        init="kmeans++"),
    }

    def __init__(self, store: VectorStore, *, pq: PQIndex | None = None,
                 ivfadc: IVFADCIndex | None = None,
                 ivpq: IVPQIndex | None = None,
                 params: RuntimeParams | None = None,
                 exact_dtype: str = "float32",
                 exact_approx: bool = False) -> None:
        self.store = store
        self.pq = pq
        self.ivfadc = ivfadc
        self.ivpq = ivpq
        self.params = params or RuntimeParams()
        self.set_pq_lut_dtype(self.params.pq_lut_dtype)
        self.dispatch = dict(DEFAULT_DISPATCH)
        #: named per-cell frequency tables (:meth:`create_statistics`)
        self.statistics: dict[str, torch.Tensor] = {}
        #: named join-target handles (:meth:`prepare_targets`)
        self.prepared_targets: dict[str, PreparedJoin] = {}
        self.tracker = GLOBAL_TRACKER
        #: emit the full 5-stage TRACK breakdown (:meth:`set_track_stages`)
        self.track_stages = False
        self.exact = ExactIndex(store.vectors_norm, exact_dtype,
                                approx=exact_approx)
        #: the device mesh of :meth:`enable_sharding`, None unsharded
        self.mesh: sharding.Mesh | None = None
        self._shard: dict = {}

    # ------------------------------------------------------------ sharding
    def enable_sharding(self, mesh: sharding.Mesh) -> None:
        """Sharded mode (JAX api.py:157-178): the normalized vectors
        (zero-padded to a multiple of the mesh's rows, padding masked), the
        PQ codes and the IVFADC inverted lists are split over the mesh's
        "rows" axis (``parallel/sharding.py``), and the exact, PQ, PQ-PV,
        IVFADC and IVFADC-PV kNN cores, the in-set cores (and so the exact
        join) and the IVPQ join route through the sharded searches. The
        other methods keep the unsharded indexes. A mesh of R entries of
        one card runs R shards on it."""
        rows = mesh.shape[sharding.ROWS_AXIS]
        vpad, n_valid = sharding.pad_rows(self.store.vectors_norm, rows)
        self._shard = {"vectors": sharding.shard_rows(vpad, mesh),
                       "valid": n_valid}
        if self.pq is not None:
            cpad, _ = sharding.pad_rows(self.pq.codes, rows)
            self._shard["pq_codes"] = sharding.shard_codes(cpad, mesh)
        if self.ivfadc is not None:
            self._shard["ivf_bundle"] = sharding.shard_ivfadc(self.ivfadc,
                                                              mesh)
        self.mesh = mesh

    # ------------------------------------------------------------- builders
    @classmethod
    def build(cls, store: VectorStore, *, seed: int = 0,
              preset: str | None = None,
              with_pq: bool = True, with_ivfadc: bool = True,
              with_ivpq: bool = True, pq_m: int | None = None,
              pq_k: int | None = None, ivfadc_m: int | None = None,
              ivfadc_k: int | None = None, k_coarse: int = 1000,
              ivpq_m: int | None = None, ivpq_k: int | None = None,
              ivpq_k_coarse: int = 32, ivpq_coarse_positions: int = 2,
              train_size: int | None = 100_000, iters: int | None = None,
              init: str | None = None, restarts: int = 1,
              opq_iters: int | None = None,
              aniso_eta: float | None = None, mesh=None,
              exact_dtype: str = "float32",
              exact_approx: bool = False) -> "Freddy":
        """Train every requested index family on the store's normalized
        vectors (build scripts pq_index.py / ivfadc.py / ivpq.py parity;
        defaults from index_creation/config/*.json; the default PQ build
        applies OPQ). ``ivpq_coarse_positions=1`` is the flat coarse
        quantizer. Each family draws from its own generator seeded from
        ``seed``. ``mesh``: the engine comes up sharded over it
        (:meth:`enable_sharding`)."""
        base = dict(pq_m=12, pq_k=256, ivfadc_m=12, ivfadc_k=256,
                    ivpq_m=30, ivpq_k=32, iters=10, init="sample",
                    opq_iters=10)
        if preset is not None:
            if preset not in cls.PRESETS:
                raise ValueError(f"unknown preset {preset!r}; "
                                 f"one of {sorted(cls.PRESETS)}")
            base.update(cls.PRESETS[preset])
        given = dict(pq_m=pq_m, pq_k=pq_k, ivfadc_m=ivfadc_m,
                     ivfadc_k=ivfadc_k, ivpq_m=ivpq_m, ivpq_k=ivpq_k,
                     iters=iters, init=init, opq_iters=opq_iters)
        cfg = {key: base[key] if v is None else v for key, v in given.items()}
        vecs = store.vectors_norm
        n = vecs.shape[0]
        eff_train = None if train_size is None else min(train_size, n)
        common = dict(train_size=eff_train, iters=cfg["iters"],
                      init=cfg["init"], restarts=restarts)

        def gen(offset: int) -> torch.Generator:
            return torch.Generator(device=store.device).manual_seed(
                seed + offset)

        pq = PQIndex.build(gen(0), vecs, m=cfg["pq_m"], k=cfg["pq_k"],
                           opq_iters=cfg["opq_iters"], aniso_eta=aniso_eta,
                           **common) if with_pq else None
        ivf = IVFADCIndex.build(
            gen(1), vecs, m=cfg["ivfadc_m"], k=cfg["ivfadc_k"],
            k_coarse=min(k_coarse, max(n // 2, 1)),
            **common) if with_ivfadc else None
        ivpq = IVPQIndex.build(
            gen(2), vecs, m=cfg["ivpq_m"], k=cfg["ivpq_k"],
            k_coarse=ivpq_k_coarse, coarse_positions=ivpq_coarse_positions,
            **common) if with_ivpq else None
        eng = cls(store, pq=pq, ivfadc=ivf, ivpq=ivpq,
                  exact_dtype=exact_dtype, exact_approx=exact_approx)
        if mesh is not None:
            eng.enable_sharding(mesh)
        return eng

    # ----------------------------------------------------- config setters
    # (sql:21-75: plain attribute writes kept as methods for API parity.)
    def set_pvf(self, pvf: int) -> None:
        self.params.pvf = int(pvf)

    def set_w(self, w: int) -> None:
        self.params.w = int(w)

    def set_alpha(self, alpha: int) -> None:
        self.params.alpha = int(alpha)

    def set_method_flag(self, method: int) -> None:
        self.params.method = int(method)

    def set_use_targetlist(self, flag: bool) -> None:
        self.params.use_targetlist = bool(flag)

    def set_confidence_value(self, confidence: float) -> None:
        self.params.confidence = float(confidence)

    def set_long_codes_threshold(self, threshold: float) -> None:
        self.params.long_codes_threshold = float(threshold)

    def set_pq_lut_dtype(self, dtype: str) -> None:
        """Select the LUT arithmetic of the PQ scans and the join's budget
        probe: "bf16" (the float path; this port keeps those LUTs float32)
        or "int8" (per-query int8 LUTs, exact int32 sums: kernels K3 and
        K5 for PQ, K8 for the join). It applies on a CUDA engine; the CPU
        path has no quantized variant and ignores it, as the JAX engine
        does off the TPU."""
        if dtype not in kernels.LUT_DTYPES:
            raise ValueError(f"pq_lut_dtype must be 'bf16' or 'int8', "
                             f"got {dtype!r}")
        self.params.pq_lut_dtype = dtype

    def set_pv_shortlist(self, policy: str) -> None:
        """Select the post-verification shortlist policy: "auto" (bin
        survivors of the binned scan on the kernel path when k·pvf ≥ 100,
        exact otherwise), "exact", or "approx". The final re-rank is exact
        either way (:meth:`models.pq.PQIndex.search_pv`). Sharded PQ-PV
        always takes the exact per-shard shortlist, so under a mesh a
        policy other than "auto" warns that it has no effect there."""
        if policy not in ("auto", "exact", "approx"):
            raise ValueError(f"pv_shortlist must be auto|exact|approx, "
                             f"got {policy!r}")
        if policy != "auto" and self.mesh is not None:
            import warnings
            warnings.warn(
                "pv_shortlist has no effect on mesh-sharded PQ paths "
                "(the sharded PV program always uses the per-shard exact "
                "shortlist); it applies when sharding is disabled.",
                stacklevel=2)
        self.params.pv_shortlist = policy

    def set_statistics_table(self, name: str | None) -> None:
        if name is not None and name not in self.statistics:
            raise KeyError(f"no statistics table {name!r}; call "
                           "create_statistics first")
        self.params.statistics_table = name

    def set_track_stages(self, flag: bool) -> None:
        """Emit the full 5-stage TRACK breakdown (precomputation / query
        construction / data retrieval / computation / total,
        freddy.c:527-651, ivpq_search_in.c:233-697). The LUT build and the
        target-code gather are run and timed a second time on their own
        (the search paths fuse them), so it is off by default."""
        self.track_stages = bool(flag)

    def _timed(self, metric: str, fn) -> None:
        """Time ``fn()`` into ``metric``, waiting for the card's work."""
        t0 = time.perf_counter()
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.tracker.track(metric, time.perf_counter() - t0)

    def _track_precompute(self, queries: torch.Tensor,
                          centroids: torch.Tensor) -> None:
        """TRACK ``precomputation_time``: the per-query LUT build
        (freddy.c:519-527, ivpq_search_in.c:261-291), run on its own."""
        self._timed("precomputation_time",
                    lambda: lut.build_luts(queries, centroids))

    def _track_data_retrieval(self, codes: torch.Tensor,
                              tids: torch.Tensor) -> None:
        """TRACK ``data_retrieval_time``: the (T, m) target-code gather,
        the reference's SPI fetch (freddy.c:527-651), run on its own."""
        self._timed("data_retrieval_time",
                    lambda: codes[torch.clamp_min(tids.long(), 0)])

    # -------------------------------------------------- dispatch setters
    def _set_dispatch(self, op: str, impl_name: str) -> None:
        if not hasattr(self, impl_name):
            raise KeyError(f"unknown implementation {impl_name!r}")
        self.dispatch[op] = impl_name

    def set_knn_function(self, name: str) -> None:
        self._set_dispatch("knn", name)

    def set_knn_in_function(self, name: str) -> None:
        self._set_dispatch("knn_in", name)

    def set_knn_batch_function(self, name: str) -> None:
        self._set_dispatch("knn_batch", name)

    def set_knn_join_function(self, name: str) -> None:
        self._set_dispatch("knn_join", name)

    def set_analogy_function(self, name: str) -> None:
        self._set_dispatch("analogy", name)

    def set_analogy_in_function(self, name: str) -> None:
        self._set_dispatch("analogy_in", name)

    def set_groups_function(self, name: str) -> None:
        self._set_dispatch("groups", name)

    def set_cluster_function(self, name: str) -> None:
        self._set_dispatch("cluster", name)

    # ------------------------------------------------------------ helpers
    def _query_matrix(self, query) -> torch.Tensor:
        """Token / token list / vector / batch → normalized (B, d) query
        matrix on the store's device."""
        if isinstance(query, str):
            return self.store.vector_for(query)[None, :]
        if isinstance(query, (list, tuple)) and query and isinstance(
                query[0], str):
            return self.store.vectors_for(list(query))
        q = torch.as_tensor(np.asarray(query, np.float32),
                            device=self.store.device)
        if q.ndim == 1:
            q = q[None, :]
        return vo.vec_normalize(q)

    def _target_ids(self, targets) -> tuple[torch.Tensor, torch.Tensor]:
        """Word set / id set → (ids int64, mask) on the store's device;
        unknown words are dropped, as the reference's SQL join drops
        them."""
        if len(targets) == 0:
            raise ValueError("empty target set")
        if isinstance(targets, torch.Tensor):
            ids = targets.to(self.store.device, torch.int64)
        elif isinstance(targets[0], str):
            ids = torch.as_tensor(self.store.get_ids(targets, strict=False),
                                  dtype=torch.int64, device=self.store.device)
        else:
            ids = torch.as_tensor(np.asarray(targets, np.int64),
                                  device=self.store.device)
        return ids, torch.ones(ids.shape, dtype=torch.bool, device=ids.device)

    def _format_knn(self, dists: torch.Tensor, ids: torch.Tensor
                    ) -> list[list[tuple]]:
        """(B, k) results → per-query [(word, similarity), …]. One small
        device → host copy of the distances (:func:`host`; the join paths
        pass ids already read), then host numpy math."""
        sims = vo.sim_from_sqdist(host(dists.detach()).numpy())
        ids_np = ids.detach().cpu().numpy()
        out = []
        for b in range(ids_np.shape[0]):
            out.append([(self.store.words[i], float(s))
                        for i, s in zip(ids_np[b], sims[b]) if i >= 0])
        return out

    def _format_join(self, queries: Sequence[str], dists: torch.Tensor,
                     ids: torch.Tensor) -> list[tuple]:
        per_query = self._format_knn(dists, ids)
        return [(q, w, s) for q, rows in zip(queries, per_query)
                for (w, s) in rows]

    def _require(self, index, name: str):
        if index is None:
            raise RuntimeError(f"{name} index not built — pass it to the "
                               f"constructor or use Freddy.build()")
        return index

    def _active_statistics(self) -> torch.Tensor | None:
        if self.params.statistics_table is None:
            return None
        return self.statistics[self.params.statistics_table]

    # ========================================================== kNN family
    def knn(self, query, k: int) -> list[tuple]:
        """Generic kNN façade (sql:204-214) → [(word, similarity), …]."""
        return getattr(self, self.dispatch["knn"])(query, k)

    def _pad_q(self, q: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The query batch zero-padded to a multiple of the mesh's q axis
        → (padded, the batch size)."""
        qx = self.mesh.shape[sharding.Q_AXIS]
        b = q.shape[0]
        pad = (-b) % qx
        if pad:
            q = torch.cat([q, q.new_zeros(pad, q.shape[1])])
        return q, b

    def _mesh_luts(self, pq: PQIndex, qp: torch.Tensor) -> torch.Tensor:
        """LUTs for the sharded ADC searches, the OPQ rotation applied."""
        return lut.build_luts(pq._rotate(qp), pq.codebook.centroids)

    def _mesh_lut_dtype(self) -> str:
        """LUT arithmetic of the sharded ADC scans: ``pq_lut_dtype`` on a
        CUDA engine (K3 for "int8"), float LUTs on the CPU, which has no
        quantized variant — :meth:`_pq_impl`'s rule."""
        return "int8" if self._pq_impl() == "kernel_int8" else "bf16"

    # Per-family batched cores: (B, d) query matrix → (dists, ids), through
    # the sharded searches under a mesh.
    def _exact_knn_core(self, q: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            d, i = sharding.sharded_exact_top_k(
                self.mesh, qp, self._shard["vectors"], k,
                valid_rows=self._shard["valid"])
            return d[:b], i[:b]
        return self.exact.search(q, k)

    def _pq_impl(self) -> str | None:
        """Scan impl from ``pq_lut_dtype``: "kernel_int8" on a CUDA engine
        set to int8 (the JAX engine's "pallas_int8" on the TPU); None keeps
        ``PQIndex``'s own choice, which is also what the CPU gets."""
        if (self.params.pq_lut_dtype == "int8"
                and self.store.device.type == "cuda"):
            return "kernel_int8"
        return None

    def _pq_knn_core(self, q: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        pq = self._require(self.pq, "PQ")
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            d, i = sharding.sharded_adc_top_k(
                self.mesh, self._mesh_luts(pq, qp), self._shard["pq_codes"],
                k, valid_rows=pq.size, lut_dtype=self._mesh_lut_dtype())
            return d[:b], i[:b]
        return pq.search(q, k, impl=self._pq_impl())

    def _pq_pv_knn_core(self, q: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        pq = self._require(self.pq, "PQ")
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            cd, ci = sharding.sharded_adc_top_k(
                self.mesh, self._mesh_luts(pq, qp), self._shard["pq_codes"],
                k * self.params.pvf, valid_rows=pq.size,
                lut_dtype=self._mesh_lut_dtype())
            d, i = sharding.sharded_post_verify(
                self.mesh, qp, cd, ci, self._shard["vectors"], k)
            return d[:b], i[:b]
        return pq.search_pv(q, k, self.params.pvf, self.store.vectors_norm,
                            impl=self._pq_impl(),
                            shortlist=self.params.pv_shortlist)

    def _ivfadc_knn_core(self, q: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        ivf = self._require(self.ivfadc, "IVFADC")
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            d, i = sharding.sharded_ivfadc_adaptive(
                self.mesh, qp, self._shard["ivf_bundle"], k=k,
                w=self.params.w)
            return d[:b], i[:b]
        return ivf.search_adaptive(q, k, w=self.params.w)

    def _ivfadc_pv_knn_core(self, q: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        ivf = self._require(self.ivfadc, "IVFADC")
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            cd, ci = sharding.sharded_ivfadc_adaptive(
                self.mesh, qp, self._shard["ivf_bundle"],
                k=k * self.params.pvf, w=self.params.w)
            d, i = sharding.sharded_post_verify(
                self.mesh, qp, cd, ci, self._shard["vectors"], k)
            return d[:b], i[:b]
        return ivf.search_pv(q, k, self.params.pvf, self.store.vectors_norm,
                             w=self.params.w)

    _KNN_CORES = {
        "k_nearest_neighbour": "_exact_knn_core",
        "k_nearest_neighbour_pq": "_pq_knn_core",
        "k_nearest_neighbour_pq_pv": "_pq_pv_knn_core",
        "k_nearest_neighbour_ivfadc": "_ivfadc_knn_core",
        "k_nearest_neighbour_ivfadc_pv": "_ivfadc_pv_knn_core",
    }

    def knn_matrix(self, q: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched kNN over a prepared (B, d) matrix, honoring the
        ``dispatch['knn']`` family."""
        impl = self.dispatch["knn"]
        core = self._KNN_CORES.get(impl)
        if core is None:
            raise NotImplementedError(
                f"no batched core for knn impl {impl!r} in this port yet")
        return getattr(self, core)(q, k)

    def _knn_one(self, core: str, query, k: int) -> list[tuple]:
        q = self._query_matrix(query)
        with self.tracker.stage("total_time"):
            d, i = getattr(self, core)(q, k)
        return self._format_knn(d, i)[0]

    def k_nearest_neighbour(self, query, k: int) -> list[tuple]:
        """Exact full-scan kNN (sql:426-454)."""
        return self._knn_one("_exact_knn_core", query, k)

    def k_nearest_neighbour_pq(self, query, k: int) -> list[tuple]:
        """PQ ADC kNN (sql:593-622 → pq_search)."""
        return self._knn_one("_pq_knn_core", query, k)

    def k_nearest_neighbour_pq_pv(self, query, k: int) -> list[tuple]:
        """PQ + post-verification (sql:625-662)."""
        return self._knn_one("_pq_pv_knn_core", query, k)

    def k_nearest_neighbour_ivfadc(self, query, k: int) -> list[tuple]:
        """IVFADC kNN with widening semantics (sql:503-532 →
        ivfadc_search)."""
        return self._knn_one("_ivfadc_knn_core", query, k)

    def k_nearest_neighbour_ivfadc_pv(self, query, k: int) -> list[tuple]:
        """IVFADC + post-verification (sql:556-591)."""
        return self._knn_one("_ivfadc_pv_knn_core", query, k)

    # ------------------------------------------------------------- batches
    def knn_batch(self, queries: Sequence[str], k: int) -> list[tuple]:
        """Generic batch façade (sql:216-230) → [(query, word, sim), …]."""
        return getattr(self, self.dispatch["knn_batch"])(queries, k)

    def k_nearest_neighbour_ivfadc_batch(self, queries: Sequence[str],
                                         k: int) -> list[tuple]:
        """Batched IVFADC (sql:535-554 → ivfadc_batch_search)."""
        q = self._query_matrix(list(queries))
        with self.tracker.stage("total_time"):
            d, i = self._ivfadc_knn_core(q, k)
        return self._format_join(list(queries), d, i)

    def knn_batch_exact(self, queries: Sequence[str], k: int) -> list[tuple]:
        """Exact batch (the plpgsql loop of knn_search_in_batch over the
        full table, done as one matmul) → [(query, word, sim), …]."""
        q = self._query_matrix(list(queries))
        with self.tracker.stage("total_time"):
            d, i = self.exact.search(q, k)
        return self._format_join(list(queries), d, i)

    # -------------------------------------------------------------- in-set
    def knn_in(self, query, k: int, targets) -> list[tuple]:
        """Generic restricted façade (sql:232-246)."""
        return getattr(self, self.dispatch["knn_in"])(query, k, targets)

    def _exact_in_core(self, q: torch.Tensor, k: int, tids: torch.Tensor,
                       tmask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            d, i = sharding.sharded_exact_in(
                self.mesh, qp, self._shard["vectors"], tids, tmask, k)
            return d[:b], i[:b]
        return self.exact.search_in(q, k, tids, tmask)

    def _pq_in_core(self, q: torch.Tensor, k: int, tids: torch.Tensor,
                    tmask: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        pq = self._require(self.pq, "PQ")
        if self.mesh is not None:
            qp, b = self._pad_q(q)
            d, i = sharding.sharded_adc_in(
                self.mesh, self._mesh_luts(pq, qp), self._shard["pq_codes"],
                tids, tmask, k, lut_dtype=self._mesh_lut_dtype())
            return d[:b], i[:b]
        return pq.search_in(q, k, tids, tmask)

    #: dispatch impl → batched matrix core of the in-set family; IVPQ has
    #: none (its round count depends on the data).
    _KNN_IN_CORES = {
        "knn_in_exact": "_exact_in_core",
        "knn_in_pq": "_pq_in_core",
    }

    def knn_in_matrix(self, q: torch.Tensor, k: int, tids: torch.Tensor,
                      tmask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched in-set kNN over a prepared (B, d) matrix and target
        id / mask tensors, honoring ``dispatch['knn_in']``. Raises
        :class:`NoMatrixCore` for an impl without one."""
        impl = self.dispatch["knn_in"]
        core = self._KNN_IN_CORES.get(impl)
        if core is None:
            raise NoMatrixCore(f"no matrix core for knn_in impl {impl!r}")
        return getattr(self, core)(q, k, tids, tmask)

    def _knn_in_one(self, core: str, query, k: int, targets) -> list[tuple]:
        q = self._query_matrix(query)
        tids, tmask = self._target_ids(targets)
        with self.tracker.stage("total_time"):
            d, i = getattr(self, core)(q, k, tids, tmask)
        return self._format_knn(d, i)[0]

    def knn_in_exact(self, query, k: int, targets) -> list[tuple]:
        """Exact in-set kNN — the reference's four overloads (token or
        vector × words or ids), sql:991-1084."""
        return self._knn_in_one("_exact_in_core", query, k, targets)

    def knn_in_pq(self, query, k: int, targets) -> list[tuple]:
        """PQ in-set kNN (sql:664-680 → pq_search_in); K2 on the card."""
        return self._knn_in_one("_pq_in_core", query, k, targets)

    def knn_in_ivpq(self, query, k: int, targets) -> list[tuple]:
        """IVPQ in-set kNN (sql:682-718 → ivpq_search_in, B=1)."""
        rows = self.knn_in_ivpq_batch([query] if isinstance(query, str)
                                      else query, k, targets)
        return [(w, s) for (_q, w, s) in rows]

    # --------------------------------------------------------------- joins
    def knn_join(self, queries: Sequence[str], k: int,
                 targets) -> list[tuple]:
        """Generic kNN-join façade (sql:248-266) → [(query, target, sim)]."""
        return getattr(self, self.dispatch["knn_join"])(queries, k, targets)

    @staticmethod
    def _chunked_q(q: torch.Tensor, fn, chunk: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run a (B, d)-batched search in query chunks, bounding the
        (B, T) intermediates of large joins."""
        outs = [fn(qc) for qc in torch.split(q, chunk)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def knn_search_in_batch(self, queries: Sequence[str], k: int,
                            targets) -> list[tuple]:
        """Exact kNN-join (sql:456-501): one masked matmul per query chunk
        instead of a plpgsql loop over knn_in_exact."""
        q = self._query_matrix(list(queries))
        ph = self._resolve_prepared(targets)
        tids, tmask = ((ph.target_ids, ph.target_mask) if ph is not None
                       else self._target_ids(targets))
        with self.tracker.stage("total_time"):
            d, i = self._chunked_q(
                q, lambda qc: self._exact_in_core(qc, k, tids, tmask))
        return self._format_join(list(queries), d, i)

    def knn_in_pq_batch(self, queries: Sequence[str], k: int,
                        targets) -> list[tuple]:
        """PQ kNN-join baseline (sql:846-901 → pq_search_in_batch), in
        chunks of 512 queries, each one K2 launch on the card.

        TRACK stages (freddy.c:519-651): query construction (query and
        target resolution), precomputation (the LUT build) and data
        retrieval (the target-code gather), the last two timed on their
        own under ``track_stages`` (the search fuses them), and
        computation (gather, ADC scan, top-k)."""
        pq = self._require(self.pq, "PQ")
        with self.tracker.stage("total_time"):
            with self.tracker.stage("query_construction_time"):
                q = self._query_matrix(list(queries))
                ph = self._resolve_prepared(targets)
                tids, tmask = ((ph.target_ids, ph.target_mask)
                               if ph is not None
                               else self._target_ids(targets))
            if self.track_stages:
                self._track_precompute(pq._rotate(q), pq.codebook.centroids)
                self._track_data_retrieval(pq.codes, tids)
            else:
                self.tracker.track("data_retrieval_time", 0.0)
            with self.tracker.stage("computation_time"):
                d, i = self._chunked_q(
                    q, lambda qc: self._pq_in_core(qc, k, tids, tmask),
                    chunk=512)
                ids_host = i.cpu()            # wait for the device
        return self._format_join(list(queries), d, ids_host)

    def prepare_targets(self, targets, *, name: str | None = None
                        ) -> PreparedJoin:
        """A reusable join-target handle (words or ids) — the
        repeated-target-set path of :meth:`knn_in_ivpq_batch`
        (:meth:`models.ivpq.IVPQIndex.prepare_join`). Pass the handle, or
        its ``name``, as the ``targets`` of ``knn_in_ivpq_batch`` /
        ``knn_join``."""
        ivpq = self._require(self.ivpq, "IVPQ")
        tids, tmask = self._target_ids(targets)
        ph = ivpq.prepare_join(tids, target_mask=tmask,
                               vectors=self.store.vectors_norm)
        if name is not None:
            self.prepared_targets[name] = ph
        return ph

    def _resolve_prepared(self, targets) -> PreparedJoin | None:
        if isinstance(targets, PreparedJoin):
            return targets
        if isinstance(targets, str):
            if targets not in self.prepared_targets:
                raise KeyError(f"no prepared target set {targets!r}; call "
                               "prepare_targets(..., name=...) first")
            return self.prepared_targets[targets]
        return None

    def knn_in_ivpq_batch(self, queries, k: int, targets) -> list[tuple]:
        """IVPQ kNN-join (sql:797-828 → ivpq_search_in), honoring the
        alpha / pvf / method / confidence / targetlist / long-codes
        parameters and the active statistics table.

        ``targets``: words or ids, a :class:`PreparedJoin`, or the name of
        a registered one. TRACK stages as in the reference
        (ivpq_search_in.c:233-697): query construction, data retrieval
        (the target tiling build; 0 on a prepared handle) and computation,
        plus per-query ``retrieved`` and ``target_count`` and, one value a
        statement, ``join_host_reads``, ``join_short_codes`` (1 where a
        round scanned fused-pair codes), ``join_graph_rounds`` (1 where the
        first round replayed its captured graphs, 0 where it ran eager) and
        ``join_scan_slots`` (candidate slots a query). Under a mesh the
        join runs sharded over the targets
        (:func:`parallel.sharding.sharded_ivpq_join`, the dense round; a
        prepared handle gives its targets) and reports no per-query counts,
        as in the JAX engine."""
        ivpq = self._require(self.ivpq, "IVPQ")
        if isinstance(queries, (list, tuple)) and queries and isinstance(
                queries[0], str):
            names = list(queries)
        else:
            n = np.asarray(queries).shape[0] if np.ndim(queries) > 1 else 1
            names = [f"q{i}" for i in range(n)]
        p = self.params
        tr = self.tracker
        with tr.span("total_time"):
            ph = self._resolve_prepared(targets)
            with tr.span("query_construction_time"):
                q = self._query_matrix(queries)
                if ph is None:
                    tids, tmask = self._target_ids(targets)
            if self.track_stages:
                self._track_precompute(q, ivpq.codebook.centroids)
            reads = host_reads()
            with tr.span("join_search_time") as search:
                if self.mesh is not None:
                    if ph is not None:
                        tids, tmask = ph.target_ids, ph.target_mask
                    qp, b = self._pad_q(q)
                    d, i = sharding.sharded_ivpq_join(
                        self.mesh, ivpq, qp, k, tids, target_mask=tmask,
                        vectors=self.store.vectors_norm,
                        statistics=self._active_statistics(),
                        alpha=p.alpha, pvf=p.pvf, method=p.method,
                        confidence=p.confidence)
                    d, i, info = d[:b], i[:b], None
                else:
                    d, i, info = ivpq.search_join(
                        q, k, None if ph is not None else tids, prepared=ph,
                        target_mask=None if ph is not None else tmask,
                        vectors=(None if ph is not None
                                 else self.store.vectors_norm),
                        statistics=self._active_statistics(), alpha=p.alpha,
                        pvf=p.pvf, method=p.method, confidence=p.confidence,
                        long_codes_threshold=p.long_codes_threshold,
                        use_targetlists=p.use_targetlist,
                        lut_dtype=p.pq_lut_dtype, return_info=True)
            with tr.span("join_read_time") as read:
                ids_host = host(i)            # wait for the device
            elapsed = search.seconds + read.seconds
            dr = 0.0 if info is None else info["data_retrieval_s"]
            tr.track("data_retrieval_time", dr)
            tr.track("computation_time", max(elapsed - dr, 0.0))
            if info is not None:
                for r in host(info["retrieved"]).tolist():
                    tr.track("retrieved", float(r))
                for t in host(info["target_count"]).tolist():
                    tr.track("target_count", float(t))
        with tr.span("join_format_time"):
            rows = self._format_join(names, d, ids_host)
        if info is not None:
            tr.track("join_host_reads", host_reads() - reads)
            tr.track("join_short_codes", float(info["short_codes"]))
            tr.track("join_graph_rounds", float(info["graph_rounds"]))
            tr.track("join_scan_slots", info["scan_slots"])
        return rows

    # ============================================================= analogy
    def analogy(self, w1: str, w2: str, w3: str) -> str:
        """Generic analogy façade (sql:268-280)."""
        return getattr(self, self.dispatch["analogy"])(w1, w2, w3)

    def analogy_in(self, w1: str, w2: str, w3: str, targets) -> str:
        """Generic in-set analogy façade (sql:282-296)."""
        return getattr(self, self.dispatch["analogy_in"])(w1, w2, w3,
                                                          targets)

    def _exclude(self, scores: torch.Tensor, words: Sequence[str]
                 ) -> torch.Tensor:
        """``scores`` with the known ``words``' rows set to −inf."""
        ids = self.store.get_ids(words, strict=False)
        if ids:
            scores[torch.as_tensor(ids, device=scores.device)] = -float("inf")
        return scores

    def _analogy_vec(self, w1: str, w2: str, w3: str) -> torch.Tensor:
        """3CosAdd query vector v3 − v1 + v2 on normalized vectors
        (sql:1270-1288, "w3 - w1 + w2")."""
        v1, v2, v3 = (self.store.vector_for(w) for w in (w1, w2, w3))
        return v3 - v1 + v2

    def _argmax_word(self, scores: torch.Tensor) -> str:
        return self.store.words[int(torch.argmax(scores))]

    @no_tf32()
    def analogy_3cosadd(self, w1: str, w2: str, w3: str) -> str:
        """Default analogy: argmax cos(v3 − v1 + v2, v), the inputs
        excluded (sql:1270-1288); float32 scores, TF32 off."""
        scores = self.store.vectors_norm @ self._analogy_vec(w1, w2, w3)
        return self._argmax_word(self._exclude(scores, (w1, w2, w3)))

    @no_tf32()
    def analogy_3cosadd_in(self, w1: str, w2: str, w3: str, targets) -> str:
        """In-set 3CosAdd (sql:1290-1314): the best-scoring target that is
        not an input word."""
        q = self._analogy_vec(w1, w2, w3)
        tids, _ = self._target_ids(targets)
        scores = self.store.vectors_norm[tids] @ q
        banned = {w1, w2, w3}
        # the best few from the card; all of them only if those are banned
        for n in sorted({min(16, len(tids)), len(tids)}):
            pos = torch.topk(scores, n).indices
            for w in self.store.get_words(tids[pos].tolist()):
                if w not in banned:
                    return w
        raise ValueError("no admissible analogy result in target set")

    @no_tf32()
    def analogy_3cosmul(self, w1: str, w2: str, w3: str) -> str:
        """3CosMul with the reference's shifted-cosine form ((cos+1)/2
        ratios, ε = 0.001; sql:1231-1248)."""
        v = self.store.vectors_norm
        c1, c2, c3 = (v @ self.store.vector_for(w) for w in (w1, w2, w3))
        scores = (((c3 + 1.0) / 2.0) * ((c2 + 1.0) / 2.0)) / (
            ((c1 + 1.0) / 2.0) + 0.001)
        return self._argmax_word(self._exclude(scores, (w1, w2, w3)))

    #: rows of the raw table normalized at once by the pair-direction
    #: analogy (its (N, d) temporary would double the table)
    _PAIR_CHUNK = 262144

    @no_tf32()
    def analogy_pair_direction(self, w1: str, w2: str, w3: str) -> str:
        """argmax cos(norm(v1 − v2), norm(v3 − v4)) over v4, on RAW vectors
        (sql:1212-1229), in row chunks."""
        raw = self.store.vectors
        v1, v2, v3 = (self.store.vector_for(w, normalized=False)
                      for w in (w1, w2, w3))
        dir_q = vo.vec_normalize(v1 - v2)
        c = self._PAIR_CHUNK
        scores = torch.cat([vo.vec_normalize(v3[None, :] - raw[s:s + c])
                            @ dir_q for s in range(0, raw.shape[0], c)])
        return self._argmax_word(self._exclude(scores, (w1, w2, w3)))

    def _analogy_query(self, w1: str, w2: str, w3: str) -> torch.Tensor:
        return vo.vec_normalize(self._analogy_vec(w1, w2, w3))[None, :]

    def analogy_3cosadd_pq(self, w1: str, w2: str, w3: str) -> str:
        """PQ-accelerated 3CosAdd: an exact ADC shortlist of pvf+3, then an
        exact re-rank (sql:1317-1346)."""
        pq = self._require(self.pq, "PQ")
        _, i = pq.search_pv(self._analogy_query(w1, w2, w3),
                            self.params.pvf + 3, 1, self.store.vectors_norm,
                            shortlist="exact")
        return self._pick_not_banned(i[0], (w1, w2, w3))

    def analogy_3cosadd_ivfadc(self, w1: str, w2: str, w3: str) -> str:
        """IVFADC-accelerated 3CosAdd (sql:1428-1459)."""
        ivf = self._require(self.ivfadc, "IVFADC")
        _, i = ivf.search_pv(self._analogy_query(w1, w2, w3),
                             self.params.pvf + 3, 1, self.store.vectors_norm,
                             w=self.params.w)
        return self._pick_not_banned(i[0], (w1, w2, w3))

    def analogy_3cosadd_in_pq(self, w1: str, w2: str, w3: str,
                              targets) -> str:
        """In-set PQ-accelerated 3CosAdd (sql:1348-1381)."""
        pq = self._require(self.pq, "PQ")
        tids, tmask = self._target_ids(targets)
        _, i = pq.search_in(self._analogy_query(w1, w2, w3),
                            min(self.params.pvf + 3, tids.shape[0]), tids,
                            tmask)
        return self._pick_not_banned(i[0], (w1, w2, w3))

    def analogy_3cosadd_in_ivpq(self, w1: str, w2: str, w3: str,
                                targets) -> str:
        """In-set IVPQ-accelerated 3CosAdd (sql:1383-1425)."""
        ivpq = self._require(self.ivpq, "IVPQ")
        tids, tmask = self._target_ids(targets)
        p = self.params
        _, i = ivpq.search_join(
            self._analogy_query(w1, w2, w3), min(p.pvf + 3, tids.shape[0]),
            tids, target_mask=tmask, vectors=self.store.vectors_norm,
            statistics=self._active_statistics(), alpha=p.alpha, pvf=p.pvf,
            method=p.method, confidence=p.confidence,
            long_codes_threshold=p.long_codes_threshold,
            lut_dtype=p.pq_lut_dtype)
        return self._pick_not_banned(i[0], (w1, w2, w3))

    def _pick_not_banned(self, ids: torch.Tensor, banned_words) -> str:
        banned = set(banned_words)
        for i in ids.tolist():
            if i >= 0 and self.store.words[i] not in banned:
                return self.store.words[i]
        raise ValueError("analogy shortlist exhausted — raise pvf")

    # ============================================================ grouping
    def groups(self, tokens: Sequence[str],
               group_tokens: Sequence[str]) -> list[tuple]:
        """Generic grouping façade (sql:298-312)."""
        return getattr(self, self.dispatch["groups"])(tokens, group_tokens)

    def grouping_func(self, tokens: Sequence[str],
                      group_tokens: Sequence[str]) -> list[tuple]:
        """Exact grouping: each known token → its nearest group token
        (sql:1462-1484, a loop of knn_in(token, 1, groups); one batched
        in-set search here)."""
        toks = [t for t in tokens if t in self.store]
        tids, tmask = self._target_ids(list(group_tokens))
        _, i = self.exact.search_in(self.store.vectors_for(toks), 1, tids,
                                    tmask)
        return [(t, self.store.words[g]) for t, g in zip(toks, i[:, 0].tolist())
                if g >= 0]

    def grouping_func_pq(self, tokens: Sequence[str],
                         group_tokens: Sequence[str]) -> list[tuple]:
        """PQ-code grouping (sql:1487-1509 → grouping_pq,
        freddy.c:1176-1401): the tokens' PQ codes scored against one LUT
        per group word, K2 on the card (:meth:`PQIndex.adc_in`); each token
        takes the nearest group. The group vectors are rotated into an OPQ
        index's basis before the LUTs are built (the JAX engine builds them
        unrotated)."""
        pq = self._require(self.pq, "PQ")
        toks = [t for t in tokens if t in self.store]
        token_ids = torch.as_tensor(self.store.get_ids(toks),
                                    device=self.store.device)
        gids, gmask = self._target_ids(list(group_tokens))
        luts = lut.build_luts(pq._rotate(self.store.vectors_norm[gids]),
                              pq.codebook.centroids)        # (G, m, k)
        dists = pq.adc_in(luts, token_ids)                   # (G, T)
        dists = torch.where(gmask[:, None], dists, float("inf"))
        best = gids[torch.argmin(dists, dim=0)].tolist()
        return [(t, self.store.words[g]) for t, g in zip(toks, best)]

    # ========================================================== clustering
    def cluster(self, tokens: Sequence[str], k: int) -> list[tuple]:
        """Generic clustering façade (sql:314-332) → [(word, cluster), …]."""
        return getattr(self, self.dispatch["cluster"])(tokens, k)

    def _generic_cluster(self, tokens: Sequence[str], k: int,
                         join_fn: Callable, *, seed: int = 0,
                         iters: int = 10) -> list[tuple]:
        """k-means over a token set (``generic_cluster``, sql:1086-1170):
        k random token vectors as the first centroids, then ``iters``
        rounds of assignment through a kNN-join and centroids of ≤10
        sampled members (with replacement, sql:1131-1151); an empty
        cluster keeps its centroid; ids are 1-based. The draws and the
        centroid updates run on the host with numpy's ``default_rng(seed)``,
        as in the JAX engine; one (T,) assignment comes back per round."""
        toks = [t for t in tokens if t in self.store]
        vecs = self.store.vectors_for(toks).cpu().numpy()
        rng = np.random.default_rng(seed)
        centroids = vecs[rng.integers(0, len(toks), size=k)]
        assign = np.zeros(len(toks), np.int64)
        for it in range(iters):
            d, i = join_fn(torch.as_tensor(centroids,
                                           device=self.store.device),
                           len(toks))
            assign_new = _cluster_assign(d, i, len(toks)).cpu().numpy()
            assign = np.where(assign_new >= 0, assign_new, assign)
            if it < iters - 1:
                for c in range(k):
                    members = np.flatnonzero(assign == c)
                    if len(members) == 0:
                        continue
                    sample = members[rng.integers(0, len(members), size=10)]
                    centroids[c] = vecs[sample].mean(0)
        return [(t, int(c) + 1) for t, c in zip(toks, assign)]

    def _make_join_fn(self, impl: str, toks: list[str]):
        """The assignment join of one clustering family: centroids (k, d)
        and a width kk → (dists, token positions, −1 past the results)."""
        dev = self.store.device
        tids = torch.as_tensor(self.store.get_ids(toks), device=dev)

        def exact_join(centroids: torch.Tensor, kk: int):
            idx = ExactIndex(self.store.vectors_norm[tids],
                             self.exact.compute_dtype)
            return idx.search(vo.vec_normalize(centroids), kk)

        def pq_join(centroids: torch.Tensor, kk: int):
            pq = self._require(self.pq, "PQ")
            d, i = pq.search_in(vo.vec_normalize(centroids), kk, tids)
            return d, _globals_to_locals(i, tids)

        def ivpq_join(centroids: torch.Tensor, kk: int):
            ivpq = self._require(self.ivpq, "IVPQ")
            p = self.params
            d, i = ivpq.search_join(
                vo.vec_normalize(centroids), kk, tids,
                vectors=self.store.vectors_norm,
                statistics=self._active_statistics(), alpha=p.alpha,
                pvf=p.pvf, method=p.method, confidence=p.confidence,
                long_codes_threshold=p.long_codes_threshold,
                lut_dtype=p.pq_lut_dtype)
            return d, _globals_to_locals(i, tids)

        return {"exact": exact_join, "pq": pq_join, "ivpq": ivpq_join}[impl]

    def _cluster_with(self, impl: str, tokens: Sequence[str], k: int
                      ) -> list[tuple]:
        toks = [t for t in tokens if t in self.store]
        return self._generic_cluster(toks, k, self._make_join_fn(impl, toks))

    def cluster_exact(self, tokens: Sequence[str], k: int) -> list[tuple]:
        """(sql:1172-1182)"""
        return self._cluster_with("exact", tokens, k)

    def cluster_pq(self, tokens: Sequence[str], k: int) -> list[tuple]:
        """(sql:1198-1209)"""
        return self._cluster_with("pq", tokens, k)

    def cluster_ivpq(self, tokens: Sequence[str], k: int) -> list[tuple]:
        """(sql:1185-1196)"""
        return self._cluster_with("ivpq", tokens, k)

    # ============================================================ tokenize
    def tokenize(self, text: str) -> np.ndarray | None:
        """Normalized centroid of the known words' normalized vectors
        (sql:1513-1524); None when no word is known (SQL NULL)."""
        words = [w for w in text.split(" ") if w in self.store]
        if not words:
            return None
        c = vo.centroid(self.store.vectors_for(words))
        return vo.vec_normalize(c).cpu().numpy()

    def tokenize_raw(self, text: str) -> np.ndarray | None:
        """Unnormalized centroid of the known words' RAW vectors
        (sql:1527-1536)."""
        words = [w for w in text.split(" ") if w in self.store]
        if not words:
            return None
        return vo.centroid(self.store.vectors_for(
            words, normalized=False)).cpu().numpy()

    # ========================================================== statistics
    def create_statistics(self, name: str, domain_words: Sequence[str]
                          ) -> None:
        """Build and activate a named per-cell frequency table for a word
        domain (sql:150-171 ``create_statistics`` and its auto-set DO
        block, sql:173-186); IVPQ probing reads it."""
        ivpq = self._require(self.ivpq, "IVPQ")
        ids = torch.as_tensor(self.store.get_ids(domain_words, strict=False),
                              dtype=torch.int64, device=ivpq.cell_of.device)
        self.statistics[name] = build_statistics(ivpq.cell_of, ids,
                                                 ivpq.num_cells)
        self.params.statistics_table = name

    # ============================================================ autotune
    def _tune_queries(self, rng: np.random.Generator, sample: int
                      ) -> torch.Tensor:
        n = self.store.size
        sel = rng.choice(n, size=min(sample, n), replace=False)
        return self.store.vectors_norm[torch.as_tensor(
            sel, device=self.store.device)]

    @staticmethod
    def _install(report: list[dict], params: RuntimeParams,
                 set_function) -> None:
        """Mark and install the fastest candidate that meets the target,
        else the one with the highest recall."""
        ok = [r for r in report if r["meets_target"]]
        best = ok[0] if ok else max(report, key=lambda r: r["recall"])
        best["chosen"] = True
        set_function(best["name"])
        for p, v in best["params"].items():
            setattr(params, p, v)

    def autotune(self, *, target_recall: float = 0.9, k: int = 10,
                 sample: int = 256, seed: int = 0,
                 apply: bool = True) -> list[dict]:
        """Measure every built kNN family on ``sample`` random store rows
        and pick the fastest configuration meeting ``target_recall``
        (recall@k against this engine's exact float32 scan). Candidates:
        exact, PQ, PQ+PV (pvf 10, 20, 50, 100), IVFADC (w 1, 3, 5, 10),
        IVFADC+PV, each through its batched core, timed by
        ``benchutil.timeit``. ``apply=True`` installs the winner's
        ``dispatch["knn"]`` and its pvf / w (engine-wide parameters, as in
        the reference). Returns the report sorted fastest first: ``name``,
        ``params``, ``recall``, ``seconds``, ``meets_target``, and
        ``chosen`` on the installed winner (JAX api.py:1174-1245)."""
        from postgres_word2vec_tpu_torch.evaluation.benchutil import (
            recall_at_k, timeit)

        q = self._tune_queries(np.random.default_rng(seed), sample)
        _, gt = self.exact.search(q, k, approx=False)
        gt_h = gt.cpu().numpy()

        def measure(impl: str, **param_over):
            saved = {p: getattr(self.params, p) for p in param_over}
            for p, v in param_over.items():
                setattr(self.params, p, v)
            core = getattr(self, self._KNN_CORES[impl])
            try:
                dt, (_, ids) = timeit(lambda qq: core(qq, k), q)
            finally:
                for p, v in saved.items():
                    setattr(self.params, p, v)
            rec = float(recall_at_k(ids, gt_h))
            return {"name": impl, "params": dict(param_over),
                    "recall": rec, "seconds": dt,
                    "meets_target": rec >= target_recall}

        report = [measure("k_nearest_neighbour")]
        if self.pq is not None:
            report.append(measure("k_nearest_neighbour_pq"))
            for pvf in (10, 20, 50, 100):
                report.append(measure("k_nearest_neighbour_pq_pv", pvf=pvf))
        if self.ivfadc is not None:
            for w in (1, 3, 5, 10):
                report.append(measure("k_nearest_neighbour_ivfadc", w=w))
            report.append(measure("k_nearest_neighbour_ivfadc_pv",
                                  w=self.params.w, pvf=self.params.pvf))
        report.sort(key=lambda r: r["seconds"])
        if apply:
            self._install(report, self.params, self.set_knn_function)
        return report

    def autotune_join(self, *, target_recall: float = 0.9, k: int = 5,
                      sample: int = 256, targets=None,
                      target_sample: int = 10_000, seed: int = 0,
                      alphas: Sequence[int] = (50, 100, 200, 400),
                      pvfs: Sequence[int] = (10, 20),
                      apply: bool = True) -> list[dict]:
        """Sweep the IVPQ join's alpha / pvf / method grid against in-set
        exact ground truth and pick the fastest configuration meeting
        ``target_recall`` (evaluation/time_precision_eval.py:49's knobs;
        JAX api.py:1247-1339). ``targets``: the target set (words or ids),
        or None for ``target_sample`` random store rows. The sweep runs on
        one :meth:`models.ivpq.IVPQIndex.prepare_join` handle, as a
        repeated target set is served. Candidates: method 0 and method 2
        (× ``pvfs``) at each alpha, method 1 at the largest, and the exact
        join ``knn_search_in_batch``. ``apply=True`` sets alpha / pvf /
        method and ``dispatch["knn_join"]``."""
        from postgres_word2vec_tpu_torch.evaluation.benchutil import (
            recall_at_k, timeit)

        n = self.store.size
        rng = np.random.default_rng(seed)
        q = self._tune_queries(rng, sample)
        if targets is None:
            tids = torch.as_tensor(
                np.sort(rng.choice(n, size=min(target_sample, n),
                                   replace=False)), device=self.store.device)
            tmask = torch.ones(tids.shape, dtype=torch.bool,
                               device=tids.device)
        else:
            tids, tmask = self._target_ids(targets)
        _, gt = self._exact_in_core(q, k, tids, tmask)
        gt_h = gt.cpu().numpy()
        report = []

        def measure(name, fn, **params):
            dt, (_, ids) = timeit(fn, q)
            rec = float(recall_at_k(ids, gt_h))
            report.append({"name": name, "params": params, "recall": rec,
                           "seconds": dt,
                           "meets_target": rec >= target_recall})

        measure("knn_search_in_batch",
                lambda qq: self._exact_in_core(qq, k, tids, tmask))
        if self.ivpq is not None:
            stats = self._active_statistics()
            ph = self.ivpq.prepare_join(tids, target_mask=tmask,
                                        vectors=self.store.vectors_norm)

            def join(qq, **kw):
                return self.ivpq.search_join(
                    qq, k, prepared=ph, statistics=stats,
                    confidence=self.params.confidence,
                    long_codes_threshold=self.params.long_codes_threshold,
                    lut_dtype=self.params.pq_lut_dtype, **kw)

            for alpha in alphas:
                measure("knn_in_ivpq_batch",
                        lambda qq, a=alpha: join(qq, alpha=a, method=0),
                        alpha=alpha, method=0)
                for pvf in pvfs:
                    measure("knn_in_ivpq_batch",
                            lambda qq, a=alpha, p=pvf: join(
                                qq, alpha=a, method=2, pvf=p),
                            alpha=alpha, method=2, pvf=pvf)
            measure("knn_in_ivpq_batch",
                    lambda qq, a=max(alphas): join(qq, alpha=a, method=1),
                    alpha=max(alphas), method=1)
        report.sort(key=lambda r: r["seconds"])
        if apply:
            self._install(report, self.params, self.set_knn_join_function)
        return report

    def warmup(self, *, k: int = 5, join_targets: int = 1024,
               query_chunk: int = 1024) -> None:
        """Run one tiny query through each built index family's search
        paths (serving cold-start hygiene, JAX api.py:1341-1375). On the
        card the first call builds the kernels from source and fills the
        per-table caches (the PQ transposed codes, the IVFADC tiles, K1's
        TMA descriptor); ``pq_lut_dtype`` is honored, so an int8 engine
        warms its int8 kernels."""
        q = self.store.vectors_norm[:1]
        self.exact.search(q, k)
        tids = torch.arange(min(join_targets, self.store.size),
                            device=self.store.device)
        self.exact.search_in(q, k, tids)
        if self.pq is not None:
            self.pq.search(q, k, impl=self._pq_impl())
            self.pq.search_pv(q, k, self.params.pvf, self.store.vectors_norm,
                              impl=self._pq_impl(),
                              shortlist=self.params.pv_shortlist)
            self.pq.search_in(q, k, tids)
        if self.ivfadc is not None:
            self.ivfadc.search(q, k, w=self.params.w)
            self.ivfadc.search_pv(q, k, self.params.pvf,
                                  self.store.vectors_norm, w=self.params.w)
        if self.ivpq is not None:
            p = self.params
            self.ivpq.search_join(
                q, k, tids, vectors=self.store.vectors_norm,
                statistics=self._active_statistics(), alpha=p.alpha,
                pvf=p.pvf, method=p.method, confidence=p.confidence,
                long_codes_threshold=p.long_codes_threshold,
                query_chunk=query_chunk, lut_dtype=p.pq_lut_dtype)

    # ========================================================= persistence
    def save(self, directory) -> None:
        """Persist store, every built index, statistics tables, runtime
        params and dispatch registry in the JAX engine's directory
        layout."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self.store.save(d / "store.npz")
        for name, idx in (("pq", self.pq), ("ivfadc", self.ivfadc),
                          ("ivpq", self.ivpq)):
            if idx is not None:
                idx.save(d / f"{name}.npz")
        np.savez(d / "statistics.npz",
                 **{k: v.cpu().numpy() for k, v in self.statistics.items()})
        meta = {"params": dataclasses.asdict(self.params),
                "dispatch": self.dispatch,
                "exact_dtype": self.exact.compute_dtype,
                "exact_approx": self.exact.approx}
        (d / "engine.json").write_text(json.dumps(meta, indent=2))

    # ============================================================== insert
    def insert_batch(self, terms: Sequence[str]) -> int:
        """Online insertion (freddy.c:1403-1658; JAX api.py:1433-1488):
        skip terms already in the store and terms whose every word is
        unknown, then append each new term — the mean of its known words'
        vectors — to the store and to every built index (running-mean
        codebook updates, no rebuild). Returns the number of inserted
        terms.

        The indexes get the renormalized mean of the words' normalized
        rows; the store's normalized table gets the normalized mean of
        their raw rows (``extend_inplace``), as in the JAX engine. A fused
        exact index is rebuilt (its tiled layout does not extend); any
        other exact index grows in place (:meth:`ExactIndex.extended`)."""
        new_words: list[str] = []
        id_lists: list[list[int]] = []
        seen: set[str] = set()
        for term in terms:
            if term in self.store or term in seen:
                continue  # freddy.c:1498-1514 skips existing words
            seen.add(term)
            ids = [self.store.word_to_id[w] for w in term.split(" ")
                   if w in self.store]
            if not ids:
                continue  # every word OOV → NULL vector in the reference
            new_words.append(term)
            id_lists.append(ids)
        if not new_words:
            return 0
        norm_new, raw_new = _tokenize_terms_batch(
            self.store.vectors, self.store.vectors_norm, id_lists)
        self.store = self.store.extend_inplace(new_words, raw_new)
        if self.exact.fused:
            self.exact = ExactIndex(self.store.vectors_norm,
                                    self.exact.compute_dtype,
                                    approx=self.exact.approx, fused=True)
        else:
            self.exact = self.exact.extended(self.store.vectors_norm,
                                             norm_new)
        if self.pq is not None:
            self.pq = self.pq.add(norm_new)
        if self.ivfadc is not None:
            self.ivfadc = self.ivfadc.add(norm_new)
        if self.ivpq is not None:
            self.ivpq = self.ivpq.add(norm_new)
        if self.mesh is not None:
            # the whole re-shard of the JAX engine (api.py:1483-1487): a
            # per-shard append would break the owner rule id // shard_size
            # of the in-set and post-verify paths
            self.enable_sharding(self.mesh)
        return len(new_words)

    @classmethod
    def load(cls, directory, *, device: torch.device | str | None = None,
             mesh=None) -> "Freddy":
        """Load an engine directory written by this port's or the JAX
        package's ``Freddy.save`` onto ``device``: the card unless another
        is named (``device="cpu"`` for the CPU); without a card and without
        ``device`` it raises. ``mesh``: the engine comes up sharded over it
        (:meth:`enable_sharding`)."""
        device = resolve_device(device)
        d = Path(directory)
        with np.load(d / "store.npz", allow_pickle=False) as f:
            store = convert.store_from_numpy([str(w) for w in f["words"]],
                                             f["vectors"], device)
        indexes = {}
        for name, from_numpy in (("pq", convert.pq_from_numpy),
                                 ("ivfadc", convert.ivfadc_from_numpy),
                                 ("ivpq", convert.ivpq_from_numpy)):
            if (d / f"{name}.npz").exists():
                with np.load(d / f"{name}.npz", allow_pickle=False) as f:
                    indexes[name] = from_numpy({n: f[n] for n in f.files},
                                               device)
        meta = convert.engine_meta(
            json.loads((d / "engine.json").read_text()))
        eng = cls(store, params=RuntimeParams(**meta["params"]),
                  exact_dtype=meta["exact_dtype"],
                  exact_approx=meta["exact_approx"], **indexes)
        eng.dispatch = meta["dispatch"]
        if (d / "statistics.npz").exists():
            with np.load(d / "statistics.npz", allow_pickle=False) as f:
                eng.statistics = {n: torch.as_tensor(f[n], device=device)
                                  for n in f.files}
        if mesh is not None:
            eng.enable_sharding(mesh)
        return eng


def _tokenize_segments(vectors: torch.Tensor, vectors_norm: torch.Tensor,
                       flat_ids: torch.Tensor, seg_ids: torch.Tensor,
                       n_seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-term centroids for a whole insert batch (JAX api.py:1491-1506):
    gather the member rows, take the mean per term, renormalize the mean
    of the normalized rows (tokenize semantics, sql:1513-1536) →
    (normalized centroids (n_seg, d), raw centroids (n_seg, d))."""
    d = vectors.shape[1]
    sum_n = torch.zeros(n_seg, d, device=vectors.device).index_add_(
        0, seg_ids, vectors_norm[flat_ids].float())
    sum_r = torch.zeros(n_seg, d, device=vectors.device).index_add_(
        0, seg_ids, vectors[flat_ids].float())
    cnt = torch.clamp_min(torch.bincount(seg_ids, minlength=n_seg).float(),
                          1.0)[:, None]
    return vo.vec_normalize(sum_n / cnt), sum_r / cnt


def _tokenize_terms_batch(vectors: torch.Tensor, vectors_norm: torch.Tensor,
                          id_lists: Sequence[Sequence[int]]
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten the per-term word-id lists and resolve every term's
    centroids in one :func:`_tokenize_segments` call (JAX
    api.py:1509-1529, without its padding to power-of-two sizes, which
    exists for XLA's compile cache)."""
    flat = [i for ids in id_lists for i in ids]
    seg = [t for t, ids in enumerate(id_lists) for _ in ids]
    dev = vectors.device
    return _tokenize_segments(
        vectors, vectors_norm, torch.as_tensor(flat, device=dev),
        torch.as_tensor(seg, device=dev), len(id_lists))


def _cluster_assign(dists: torch.Tensor, ids: torch.Tensor,
                    n_tokens: int) -> torch.Tensor:
    """Each token's nearest centroid from the per-centroid join results
    (k, kk) (JAX api.py:1532-1545): a scatter-min into a dense (k, T)
    table, then the first argmin over k; a token no centroid's join
    returned gets −1 (keep its previous cluster)."""
    vals = torch.where(ids >= 0, dists.float(), float("inf"))
    table = torch.full((dists.shape[0], n_tokens), float("inf"),
                       device=dists.device)
    table.scatter_reduce_(1, torch.clamp_min(ids, 0).long(), vals, "amin")
    mins, best = torch.min(table, dim=0)
    return torch.where(torch.isfinite(mins), best, -1)


def _globals_to_locals(ids: torch.Tensor, tids: torch.Tensor
                       ) -> torch.Tensor:
    """Global row ids → their positions in ``tids`` (−1 passes through),
    by binary search over the sorted target ids (JAX api.py:1548-1561)."""
    sorted_t, order = torch.sort(tids, stable=True)
    pos = torch.clamp_max(
        torch.searchsorted(sorted_t, torch.clamp_min(ids, 0)),
        sorted_t.shape[0] - 1)
    hit = sorted_t[pos] == ids
    return torch.where((ids >= 0) & hit, order[pos], -1)


#: Methods of the JAX engine not ported to this one: none.
NOT_PORTED: dict[str, str] = {}
