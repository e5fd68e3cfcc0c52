"""FREDDY-compatible engine — slices 1 to 3 of the port.

Counterpart of ``postgres_word2vec_tpu/api.py`` for these paths from a
``VectorStore`` through ``Freddy.build``:

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
  store and to every built index.

The dispatch registry (sql:78-132), runtime parameters (sql:188-202),
result shapes (``(word, similarity)`` rows, ``(query, word, similarity)``
for batches and joins, similarity = 1 − d²/2, sql:511) and the on-disk
engine directory are the JAX engine's, so a directory saved by the JAX
``Freddy.save`` loads here and the other way round.

Every other method of the JAX engine exists here and raises
``NotImplementedError`` naming the ROADMAP.md item that ports it. None
falls back to something else.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex, PQ_CALC,
                                                     PreparedJoin,
                                                     build_statistics)
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import kernels
from postgres_word2vec_tpu_torch.ops import vector_ops as vo
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils import convert
from postgres_word2vec_tpu_torch.utils.device import resolve_device
from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER


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

_ENGINE = "ROADMAP.md queue 1, item 8 (engine)"
_SHARDING = "ROADMAP.md queue 1, item 11 (multi-GPU sharding)"


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
        self.exact = ExactIndex(store.vectors_norm, exact_dtype,
                                approx=exact_approx)

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
        ``seed``. ``mesh`` (sharding) is not ported and raises."""
        if mesh is not None:
            raise NotImplementedError(f"mesh: {_SHARDING}")
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
        return cls(store, pq=pq, ivfadc=ivf, ivpq=ivpq,
                   exact_dtype=exact_dtype, exact_approx=exact_approx)

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
        either way (:meth:`models.pq.PQIndex.search_pv`)."""
        if policy not in ("auto", "exact", "approx"):
            raise ValueError(f"pv_shortlist must be auto|exact|approx, "
                             f"got {policy!r}")
        self.params.pv_shortlist = policy

    def set_statistics_table(self, name: str | None) -> None:
        if name is not None and name not in self.statistics:
            raise KeyError(f"no statistics table {name!r}; call "
                           "create_statistics first")
        self.params.statistics_table = name

    # -------------------------------------------------- dispatch setters
    def _set_dispatch(self, op: str, impl_name: str) -> None:
        if not hasattr(self, impl_name):
            raise KeyError(f"unknown implementation {impl_name!r}")
        self.dispatch[op] = impl_name

    def set_knn_function(self, name: str) -> None:
        self._set_dispatch("knn", name)

    def set_knn_batch_function(self, name: str) -> None:
        self._set_dispatch("knn_batch", name)

    def set_knn_join_function(self, name: str) -> None:
        self._set_dispatch("knn_join", name)

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
        device → host copy, then host numpy math."""
        sims = vo.sim_from_sqdist(dists.detach().cpu().numpy())
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

    # Per-family batched cores: (B, d) query matrix → (dists, ids).
    def _exact_knn_core(self, q: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
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
        return self._require(self.pq, "PQ").search(q, k,
                                                   impl=self._pq_impl())

    def _pq_pv_knn_core(self, q: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        pq = self._require(self.pq, "PQ")
        return pq.search_pv(q, k, self.params.pvf, self.store.vectors_norm,
                            impl=self._pq_impl(),
                            shortlist=self.params.pv_shortlist)

    def _ivfadc_knn_core(self, q: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        ivf = self._require(self.ivfadc, "IVFADC")
        return ivf.search_adaptive(q, k, w=self.params.w)

    def _ivfadc_pv_knn_core(self, q: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        ivf = self._require(self.ivfadc, "IVFADC")
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
                q, lambda qc: self.exact.search_in(qc, k, tids, tmask))
        return self._format_join(list(queries), d, i)

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
        plus per-query ``retrieved`` and ``target_count``."""
        ivpq = self._require(self.ivpq, "IVPQ")
        if isinstance(queries, (list, tuple)) and queries and isinstance(
                queries[0], str):
            names = list(queries)
        else:
            n = np.asarray(queries).shape[0] if np.ndim(queries) > 1 else 1
            names = [f"q{i}" for i in range(n)]
        p = self.params
        with self.tracker.stage("total_time"):
            ph = self._resolve_prepared(targets)
            with self.tracker.stage("query_construction_time"):
                q = self._query_matrix(queries)
                if ph is None:
                    tids, tmask = self._target_ids(targets)
            t0 = time.perf_counter()
            d, i, info = ivpq.search_join(
                q, k, None if ph is not None else tids, prepared=ph,
                target_mask=None if ph is not None else tmask,
                vectors=None if ph is not None else self.store.vectors_norm,
                statistics=self._active_statistics(), alpha=p.alpha,
                pvf=p.pvf, method=p.method, confidence=p.confidence,
                long_codes_threshold=p.long_codes_threshold,
                use_targetlists=p.use_targetlist, lut_dtype=p.pq_lut_dtype,
                return_info=True)
            ids_host = i.cpu()            # wait for the device
            elapsed = time.perf_counter() - t0
            dr = info["data_retrieval_s"]
            self.tracker.track("data_retrieval_time", dr)
            self.tracker.track("computation_time", max(elapsed - dr, 0.0))
            for r in info["retrieved"].tolist():
                self.tracker.track("retrieved", float(r))
            for t in info["target_count"].tolist():
                self.tracker.track("target_count", float(t))
        return self._format_join(names, d, ids_host)

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
        return len(new_words)

    @classmethod
    def load(cls, directory, *, device: torch.device | str | None = None,
             mesh=None) -> "Freddy":
        """Load an engine directory written by this port's or the JAX
        package's ``Freddy.save`` onto ``device``: the card unless another
        is named (``device="cpu"`` for the CPU); without a card and without
        ``device`` it raises."""
        if mesh is not None:
            raise NotImplementedError(f"mesh: {_SHARDING}")
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


#: Methods of the JAX engine that later items of ROADMAP.md port. Each is
#: present on :class:`Freddy` and raises ``NotImplementedError``.
NOT_PORTED = {
    **dict.fromkeys(
        ("set_track_stages", "set_knn_in_function", "set_analogy_function",
         "set_analogy_in_function", "set_groups_function",
         "set_cluster_function", "knn_in", "knn_in_matrix", "knn_in_exact",
         "knn_in_pq", "knn_in_pq_batch", "analogy", "analogy_in",
         "analogy_3cosadd", "analogy_3cosadd_in", "analogy_3cosmul",
         "analogy_pair_direction", "analogy_3cosadd_pq",
         "analogy_3cosadd_in_pq", "analogy_3cosadd_ivfadc",
         "analogy_3cosadd_in_ivpq", "groups", "grouping_func",
         "grouping_func_pq", "cluster", "cluster_exact", "cluster_pq",
         "cluster_ivpq", "tokenize", "tokenize_raw", "autotune",
         "autotune_join", "warmup"), _ENGINE),
    "enable_sharding": _SHARDING,
}


def _not_ported(name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"Freddy.{name} is not ported to PyTorch yet: {item}")
    method.__name__ = name
    method.__doc__ = f"Not ported yet: {item}."
    return method


for _name, _item in NOT_PORTED.items():
    setattr(Freddy, _name, _not_ported(_name, _item))
