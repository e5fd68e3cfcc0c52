"""Re-import a built index artifact and sanity-check it against a store.

The port's ``index_creation/load_index.py``: loads an index saved by
either package (no recomputation) and prints a self-query check on the
first four rows.

    python -m postgres_word2vec_tpu_torch.cli.index_creation.load_index \\
        <store.npz> <index.npz> <type> [--device cpu]

``type`` ∈ {pq, ivfadc, ivpq}: PQ ``search``, IVFADC ``search_adaptive``,
IVPQ ``search_join`` over the first 1000 rows at alpha 100.
"""

from __future__ import annotations

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.device import resolve_device

LOADERS = {"pq": PQIndex.load, "ivfadc": IVFADCIndex.load,
           "ivpq": IVPQIndex.load}


def main(store_path: str, index_path: str, index_type: str,
         device: torch.device | str | None = None) -> float:
    """→ the self-match@1 of the four probes."""
    device = resolve_device(device)
    store = VectorStore.load(store_path, device=device)
    index = LOADERS[index_type](index_path, device=device)
    if index.size != store.size:
        raise SystemExit(f"index rows ({index.size}) != store rows "
                         f"({store.size})")
    q = store.vectors_norm[:4]
    if index_type == "pq":
        _, ids = index.search(q, 3)
    elif index_type == "ivfadc":
        _, ids = index.search_adaptive(q, 3)
    else:
        _, ids = index.search_join(q, 3, torch.arange(
            min(store.size, 1000), dtype=torch.int32, device=device),
            alpha=100)
    hit = float((ids[:, 0].cpu().numpy() == np.arange(4)).mean())
    print(f"loaded {index_type} index: {index.size} rows; "
          f"self-match@1 on 4 probes: {hit:.2f}")
    return hit


if __name__ == "__main__":
    p = arg_parser(__doc__)
    p.add_argument("store_path")
    p.add_argument("index_path")
    p.add_argument("index_type", choices=sorted(LOADERS))
    args = p.parse_args()
    main(args.store_path, args.index_path, args.index_type,
         device=args.device)
