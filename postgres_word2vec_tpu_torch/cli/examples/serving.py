"""Serving walkthrough: save an engine, serve it over HTTP, query it.

The port's ``examples/serving.py``.

    python -m postgres_word2vec_tpu_torch.cli.examples.serving [--device cpu]

Builds a small engine, persists it with ``Freddy.save``, loads it back as
``python -m postgres_word2vec_tpu_torch.server <dir>`` does, starts the
threaded ``QueryServer`` in-process and exercises the endpoints,
including the micro-batched ``/knn`` path, which coalesces concurrent
single-query clients into one device call.
"""

from __future__ import annotations

import json
import tempfile
import threading
import urllib.request

import numpy as np
import torch

from postgres_word2vec_tpu_torch.api import Freddy
from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.server import QueryServer
from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())["result"]


def main(device: torch.device | str | None = None) -> dict:
    """→ the /health body at the end."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(2000)]
    store = VectorStore.from_arrays(
        words, rng.normal(size=(2000, 32)).astype(np.float32),
        device=device)
    eng = Freddy.build(store, seed=0, pq_m=8, pq_k=16, ivfadc_m=8,
                       ivfadc_k=16, k_coarse=20, ivpq_m=8, ivpq_k=16,
                       ivpq_k_coarse=8, train_size=None, iters=6)

    with tempfile.TemporaryDirectory() as d:
        eng.save(d)                                  # the engine artifact
        eng2 = Freddy.load(d, device=device)         # as the server CLI does
        eng2.warmup(join_targets=256)

        srv = QueryServer(eng2, port=0, batch_window_ms=5.0).start()
        print(f"serving on :{srv.port}")
        try:
            print("knn:", post(srv.port, "/knn", {"query": "w7", "k": 3}))

            # concurrent single-query clients, coalesced into one device
            # call by the /knn micro-batcher
            results = [None] * 8

            def one(j):
                results[j] = post(srv.port, "/knn",
                                  {"query": f"w{j}", "k": 2})
            threads = [threading.Thread(target=one, args=(j,))
                       for j in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if not all(r[0][0] == f"w{j}" for j, r in enumerate(results)):
                raise RuntimeError(f"a coalesced /knn answer is not its "
                                   f"query's own word first: {results}")

            print("join:", post(srv.port, "/knn_join",
                                {"queries": ["w1", "w2"], "k": 2,
                                 "targets": [f"w{i}" for i in range(100)]}))
            post(srv.port, "/config", {"set_pvf": 10, "set_alpha": 5})
            print("insert:", post(srv.port, "/insert",
                                  {"terms": ["w1 w2"]}))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health") as r:
                h = json.loads(r.read())
            print("health:", {kk: h[kk] for kk in
                              ("vocab", "requests", "knn_batched_calls",
                               "knn_max_coalesced")})
        finally:
            srv.stop()
    print("serving example OK")
    return h


if __name__ == "__main__":
    args = arg_parser(__doc__).parse_args()
    main(device=args.device)
