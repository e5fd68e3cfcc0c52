"""Entry points of the driver contract: one forward step, and a dry run of
every sharded path on a mesh.

The port's ``__graft_entry__.py``.

- :func:`entry` returns a forward step on the flagship path, the IVPQ
  batched kNN-join round (the reference's ``ivpq_search_in``: multi-index
  cell selection, confidence-driven probing, ADC distances, masked
  top-k), over a tiny seeded index, with its example arguments. The round
  is the dense one (``models.ivpq._ivpq_round``): on the card its ADC is
  one launch of K2 (``kernels.adc_scan``), on the CPU the plain gather.
- :func:`dryrun_multichip` builds an ``n_devices``-entry ``(rows, q)``
  mesh and runs the seven sections of the JAX dry run: a data-parallel
  k-means step, the sharded exact and PQ ADC scans, the IVFADC probe and
  the target-sharded IVPQ join round, the multi-round join in both
  target layouts, and a whole engine held to its unsharded self.

On the card the mesh's entries are the visible cards in turn, so on one
card they repeat it: R shards of one card measure the shard-and-merge
overhead, not multi-GPU scaling. On the CPU (``device="cpu"``) they are
CPU entries. The JAX dry run selects its platform from the environment
first; the port has no platform to select.

    python -m postgres_word2vec_tpu_torch.graft_entry [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _tiny_index(device: torch.device, seed: int = 0, n: int = 512,
                d: int = 32):
    """The JAX dry run's tiny IVPQ index: ``n`` seeded unit rows of width
    ``d`` (numpy's ``default_rng(seed)``, as in JAX), m 8, k 16, k_coarse 8,
    4 iterations → (index, rows)."""
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    v = torch.from_numpy(vecs).to(device)
    idx = IVPQIndex.build(torch.Generator(device).manual_seed(seed), v, m=8,
                          k=16, k_coarse=8, train_size=None, iters=4)
    return idx, v


def forward_step(index, vecs: torch.Tensor):
    """The forward step over ``index`` with every second row of ``vecs`` as
    the target set: ``fn(queries, confidence) → (vals (B, 5), ids (B, 5),
    retrieved (B,))``, one dense round at k 5, alpha 8, pvf 10, method
    ``PQ_CALC`` and the uniform statistics. The target codes, cells and
    rows are gathered once, as ``IVPQIndex.prepare_join`` does; the round
    scans the (m, T) code table. ``fn.index`` and ``fn.vecs`` are the index
    and rows it runs over."""
    from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod

    n = vecs.shape[0]
    target_ids = torch.arange(0, n, 2, device=index.codes.device)
    prepared = index.prepare_join(target_ids, vectors=vecs[target_ids],
                                  with_tiles=False, vecs_pregathered=True)
    codes_t = prepared.codes_t()
    stats = ivpq_mod.uniform_statistics(index.coarse.cell_counts)
    coarse_cent = index.coarse.centroids
    cb_cent = index.codebook.centroids

    def forward(queries: torch.Tensor, confidence: float):
        vals, ids, retrieved, _, _ = ivpq_mod._ivpq_round(
            queries, coarse_cent, cb_cent, codes_t, prepared.target_cells,
            prepared.target_ids, prepared.target_mask, stats,
            prepared.vectors, k=5, alpha=8, pvf=10,
            method=ivpq_mod.PQ_CALC, confidence=confidence,
            use_double=False, pregathered=True)
        return vals, ids, retrieved

    forward.index, forward.vecs = index, vecs
    return forward


def entry(device: torch.device | str | None = None):
    """→ (fn, example_args): the IVPQ kNN-join forward step over the tiny
    index on ``device`` (the card unless another is named; without one
    it raises), with ``(vecs[:16], 0.8)``."""
    idx, vecs = _tiny_index(resolve_device(device))
    return forward_step(idx, vecs), (vecs[:16], 0.8)


def _mesh_entries(n_devices: int, device: torch.device | str | None
                  ) -> list[torch.device]:
    """``n_devices`` mesh entries: ``device`` repeated, or without one the
    visible cards in turn (it raises without a card)."""
    if device is not None:
        return [torch.device(device)] * n_devices
    resolve_device(None)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(n_devices)]


def _agree(got: list, want: list, what: str, tol: float = 1e-5) -> None:
    """Two ranked answers ``[(word, score), …]`` agree up to ties: the
    same scores in order within ``tol``, and every word whose score is not
    tied with the last one kept is in both. (The JAX dry run compares the
    words themselves; its top-k keeps the lowest of tied ids on both sides,
    ``torch.topk`` promises no order among ties, and PQ codes tie often.)
    Raises ``AssertionError`` naming ``what``."""
    gs, ws = [s for _, s in got], [s for _, s in want]
    assert len(gs) == len(ws) and all(
        abs(a - b) <= tol for a, b in zip(gs, ws)), \
        f"{what} disagrees with single-device: {got} vs {want}"
    last = ws[-1] if ws else 0.0
    for side, other in ((got, want), (want, got)):
        strict = {w for w, s in side if abs(s - last) > tol}
        assert strict <= {w for w, _ in other}, \
            f"{what} disagrees with single-device: {got} vs {want}"


def _by_query(rows: list) -> dict:
    """A join's ``(query, word, score)`` rows → ``{query: [(word, score),
    …]}`` in their order."""
    g: dict = {}
    for q, w, s in rows:
        g.setdefault(q, []).append((w, s))
    return g


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> None:
    """Run one sharded training step, every sharded search path and a
    sharded engine against its unsharded self on an ``n_devices``-entry
    mesh (rows × q: database rows over ``rows``, the query batch over
    ``q``), with the JAX dry run's shapes and checks. Raises
    ``AssertionError`` where a check fails."""
    from postgres_word2vec_tpu_torch import Freddy, VectorStore
    from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
    from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
    from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
    from postgres_word2vec_tpu_torch.ops import lut
    from postgres_word2vec_tpu_torch.parallel import sharding

    entries = _mesh_entries(n_devices, device)
    q_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = sharding.make_mesh(entries, rows=n_devices // q_axis, q=q_axis)
    rows = mesh.shape[sharding.ROWS_AXIS]
    dev = mesh.lead

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(dev).manual_seed(seed)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    rng = np.random.default_rng(0)
    n, d, kq = 64 * rows, 16, 4
    x_full = put(rng.normal(size=(n, d)).astype(np.float32))
    x = sharding.shard_rows(x_full, mesh)
    queries = put(rng.normal(size=(4 * q_axis, d)).astype(np.float32))
    nq = queries.shape[0]

    # 1. training step: a data-parallel Lloyd iteration (assignment matmul
    #    on every shard, per-cluster sums added on the lead device)
    new_c, counts = sharding.sharded_kmeans_step(mesh, x, x_full[:8])
    assert new_c.shape == (8, d)
    assert int(counts.sum()) == n

    # 2. sharded exact search (rows-sharded table, q-sharded queries, the
    #    shards' top-k merged)
    dists, ids = sharding.sharded_exact_top_k(mesh, queries, x, kq)
    assert dists.shape == (nq, kq)
    assert int(ids.max()) < n

    # 3. sharded PQ ADC search over a rows-sharded code table
    codes = sharding.shard_codes(
        put(rng.integers(0, 16, size=(n, 4)).astype(np.uint8)), mesh)
    cb = put(rng.normal(size=(4, 16, 4)).astype(np.float32))
    luts = lut.build_luts(queries, cb)
    dists2, _ = sharding.sharded_adc_top_k(mesh, luts, codes, kq)
    assert dists2.shape == (nq, kq)

    # 4. sharded IVFADC probe (cell-partitioned inverted lists) and the
    #    target-sharded IVPQ join round
    vecs = put(rng.normal(size=(64 * rows * 4, d)).astype(np.float32))
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    ivf = IVFADCIndex.build(gen(1), vecs, m=4, k=8, k_coarse=8,
                            train_size=None, iters=3)
    bundle = sharding.shard_ivfadc(ivf, mesh)
    d3, _ = sharding.sharded_ivfadc_probe(mesh, queries, bundle, w=2, k=kq)
    assert d3.shape == (nq, kq)

    ivpq = IVPQIndex.build(gen(2), vecs, m=4, k=8, k_coarse=4,
                           train_size=None, iters=3)
    t = (vecs.shape[0] // rows) * rows
    tids = torch.arange(t, device=dev)
    targets = sharding.shard_join_targets(
        ivpq, tids, torch.ones(t, dtype=torch.bool, device=dev), vecs[tids],
        mesh)
    d4, _, _ = sharding.sharded_ivpq_join_round(
        mesh, queries, ivpq.coarse.centroids, ivpq.codebook.centroids,
        statistics=ivpq_mod.uniform_statistics(ivpq.coarse.cell_counts),
        k=kq, alpha=8, **targets)
    assert d4.shape == (nq, kq)

    # 5. the multi-round (alpha-escalating) sharded IVPQ join in both
    #    target layouts: the dense per-shard scan and the tiled budget
    #    probe
    for impl in ("dense", "budget"):
        d5, _ = sharding.sharded_ivpq_join(
            mesh, ivpq, queries, kq, tids, vectors=vecs, alpha=2, method=2,
            pvf=4, max_rounds=3, impl=impl)
        assert d5.shape == (nq, kq), impl

    # 6. the whole engine on the mesh: one engine's answers before and
    #    after enable_sharding
    n_eng = vecs.shape[0]
    words = [f"w{i}" for i in range(n_eng)]
    store = VectorStore.from_arrays(words, vecs, normalized=True)
    eng = Freddy.build(store, seed=0, pq_m=4, pq_k=8, ivfadc_m=4,
                       ivfadc_k=8, k_coarse=8, ivpq_m=4, ivpq_k=8,
                       ivpq_k_coarse=4, train_size=None, iters=3)
    eng.set_knn_join_function("knn_in_ivpq_batch")
    target_rows = list(range(t))
    base_knn = eng.knn(words[5], 4)
    base_pq = eng.k_nearest_neighbour_pq(words[5], 4)
    base_join = eng.knn_join(words[:4], 3, target_rows)
    base_in = eng.knn_in(words[5], 4, target_rows[:100])
    base_pv = eng.k_nearest_neighbour_pq_pv(words[5], 4)

    eng.enable_sharding(sharding.make_mesh(entries, rows=n_devices, q=1))
    shard_knn = eng.knn(words[5], 4)
    shard_pq = eng.k_nearest_neighbour_pq(words[5], 4)
    shard_join = eng.knn_join(words[:4], 3, target_rows)
    shard_batch = eng.knn_batch(words[:4], 3)

    _agree(shard_knn, base_knn, "sharded exact kNN")
    _agree(shard_pq, base_pq, "sharded PQ kNN")
    base_by, shard_by = _by_query(base_join), _by_query(shard_join)
    assert shard_by.keys() == base_by.keys(), \
        "sharded IVPQ join disagrees with single-device"
    for q_, rows_ in base_by.items():
        _agree(shard_by[q_], rows_, f"sharded IVPQ join of {q_}")
    assert len(shard_batch) == 12 and all(w in store.word_to_id
                                          for _q, w, _s in shard_batch)

    # 7. the remaining mesh families: in-set exact and PQ, both PV
    #    families, the adaptive IVFADC batch
    _agree(eng.knn_in(words[5], 4, target_rows[:100]), base_in,
           "sharded in-set exact")
    assert len(eng.knn_in_pq(words[5], 4, target_rows[:100])) == 4
    _agree(eng.k_nearest_neighbour_pq_pv(words[5], 4), base_pv,
           "sharded PQ+PV")
    assert eng.k_nearest_neighbour_ivfadc_pv(words[5], 4)[0][0] == words[5]

    distinct = sorted({str(e) for e in entries})
    print(f"dryrun_multichip ok: mesh={dict(mesh.shape)} — sharded k-means "
          f"train step, exact scan, PQ ADC scan, IVFADC probe (+adaptive), "
          f"single- and multi-round IVPQ join (dense + tiled-budget target "
          f"layouts), in-set exact/PQ, both PV families, and an end-to-end "
          f"sharded Freddy engine (knn/pq/join/in/pv parity vs "
          f"single-device) all ran on {n_devices} mesh entries of "
          f"{len(distinct)} device(s) {distinct}", flush=True)
    if len(distinct) < n_devices:
        print(f"{n_devices} mesh entries share {len(distinct)} device(s): "
              "the shard-and-merge overhead, not multi-GPU scaling",
              flush=True)


def main(argv: list[str] | None = None) -> None:
    """Run the forward step once and print its output shapes, then the dry
    run on a mesh of the visible cards, or with ``--device`` of 8 entries
    of that device (the JAX tests' 8-device virtual mesh)."""
    from postgres_word2vec_tpu_torch.cli._common import arg_parser

    args = arg_parser(__doc__).parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry forward:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(8 if args.device is not None
                     else torch.cuda.device_count(), args.device)


if __name__ == "__main__":
    main()
