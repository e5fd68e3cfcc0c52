"""Multi-device walkthrough on a mesh of torch devices.

The port's ``examples/multichip.py``, through ``parallel/sharding.py``.

    python -m postgres_word2vec_tpu_torch.cli.examples.multichip \\
        [--rows 4] [--q 1] [--device cpu]

Shows the sharded paths: data-parallel codebook training, rows-sharded
exact and PQ-ADC search, cell-partitioned IVFADC probing and the
target-sharded IVPQ join round. The mesh has ``rows × q`` entries, taken
in turn from the visible cards (or ``--device``), so on one card it
repeats the card, as ``chip_smoke.py``'s sharding phase does: R shards of
one card measure the shard-and-merge overhead, not multi-GPU scaling.
``--device cpu --rows 4 --q 2`` is the JAX tests' 4 × 2 virtual mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.models import ivpq as ivpq_mod
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.ops import lut
from postgres_word2vec_tpu_torch.parallel import sharding
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _self_match(ids: torch.Tensor) -> float:
    return float((ids[:, 0].cpu().numpy() == np.arange(8)).mean())


def main(rows: int = 4, q: int = 1,
         device: torch.device | str | None = None) -> dict:
    """→ each sharded path's self-match@1 on 8 probes."""
    if device is None:
        resolve_device(None)                 # raises without a card
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [torch.device(device)]
    entries = [cards[i % len(cards)] for i in range(rows * q)]
    mesh = sharding.make_mesh(entries, rows=rows, q=q)
    dev = mesh.lead
    print(f"mesh: {dict(mesh.shape)} over {len(set(entries))} distinct "
          f"device(s) {sorted({str(e) for e in entries})}")
    if len(set(entries)) < len(entries):
        print(f"{len(entries)} mesh entries share {len(set(entries))} "
              "device(s): the times of these paths are the shard-and-merge "
              "overhead, not multi-GPU scaling")

    rng = np.random.default_rng(0)
    n, d, k = 1024 * rows, 32, 5
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    vt = torch.from_numpy(vecs).to(dev)
    queries = vt[:8]

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(dev).manual_seed(seed)

    out = {}
    # 1. data-parallel codebook training
    xs = sharding.shard_rows(vt, mesh)
    cents, counts = sharding.sharded_kmeans(mesh, gen(0), xs, k=16, iters=5)
    print(f"sharded k-means: {tuple(cents.shape)} centroids, "
          f"{int(counts.sum())} rows assigned")

    # 2. rows-sharded exact search
    _, i1 = sharding.sharded_exact_top_k(mesh, queries, xs, k)
    out["exact"] = _self_match(i1)
    print(f"sharded exact:   self-match@1 = {out['exact']:.2f}")

    # 3. rows-sharded PQ ADC scan
    pq = PQIndex.build(gen(1), vt, m=4, k=16, train_size=None, iters=5)
    luts = lut.build_luts(queries, pq.codebook.centroids)
    _, i2 = sharding.sharded_adc_top_k(
        mesh, luts, sharding.shard_codes(pq.codes, mesh), k)
    out["pq"] = _self_match(i2)
    print(f"sharded PQ ADC:  self-match@1 = {out['pq']:.2f}")

    # 4. cell-partitioned IVFADC probe
    ivf = IVFADCIndex.build(gen(2), vt, m=4, k=16, k_coarse=12,
                            train_size=None, iters=5)
    bundle = sharding.shard_ivfadc(ivf, mesh)
    _, i3 = sharding.sharded_ivfadc_probe(mesh, queries, bundle, w=3, k=k)
    out["ivfadc"] = _self_match(i3)
    print(f"sharded IVFADC:  self-match@1 = {out['ivfadc']:.2f}")

    # 5. target-sharded IVPQ join round
    iv = IVPQIndex.build(gen(3), vt, m=4, k=8, k_coarse=4, train_size=None,
                         iters=5)
    t = (n // rows) * rows
    tids = torch.arange(t, device=dev)
    targets = sharding.shard_join_targets(
        iv, tids, torch.ones(t, dtype=torch.bool, device=dev), vt[tids],
        mesh)
    _, i4, retrieved = sharding.sharded_ivpq_join_round(
        mesh, queries, iv.coarse.centroids, iv.codebook.centroids,
        statistics=ivpq_mod.uniform_statistics(iv.coarse.cell_counts),
        k=k, alpha=20, **targets)
    out["ivpq"] = _self_match(i4)
    print(f"sharded IVPQ:    self-match@1 = {out['ivpq']:.2f}, "
          f"mean retrieved = {float(retrieved.float().mean()):.0f}")
    return out


if __name__ == "__main__":
    p = arg_parser(__doc__)
    p.add_argument("--rows", type=int, default=4,
                   help="shards of the database axis (default 4)")
    p.add_argument("--q", type=int, default=1,
                   help="shards of the query batch (default 1)")
    args = p.parse_args()
    main(args.rows, args.q, device=args.device)
