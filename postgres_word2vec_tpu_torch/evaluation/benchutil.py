"""Measurement helpers the engine uses (``Freddy.autotune`` /
``autotune_join``).

Counterpart of the part of ``postgres_word2vec_tpu/evaluation/benchutil.py``
the engine needs: :func:`timeit` with :func:`last_timing`,
:func:`recall_at_k` and :func:`log`. On the card every timed call is
bracketed by ``torch.cuda.synchronize()`` (the JAX package materializes a
slice of the output instead), so a time covers the device work the call
queued. The rest of that module is ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync() -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


#: the most recent :func:`timeit` call's samples (its spread)
_LAST_TIMING = {"seq": 0, "samples": ()}


def timeit(fn, *args, iters: int = 5):
    """Median wall time of ``fn(*args)`` over ``iters`` reps after one
    warm-up call outside the timed window → (seconds, last output)."""
    out = fn(*args)
    _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    _LAST_TIMING["seq"] += 1
    _LAST_TIMING["samples"] = tuple(ts)
    return float(np.median(ts)), out


def last_timing() -> dict:
    """(seq, min_s, max_s, n) of the most recent :func:`timeit` call."""
    s = _LAST_TIMING["samples"]
    if not s:
        return {}
    return {"seq": _LAST_TIMING["seq"], "min_s": float(min(s)),
            "max_s": float(max(s)), "n": len(s)}


def recall_at_k(ids, exact_ids) -> float:
    """Share of the exact top-k ids (cut to ``ids``' width) found in
    ``ids``, row by row; tensors or arrays."""
    ids = _host(ids)
    exact_ids = _host(exact_ids)[:, :ids.shape[1]]
    hits = sum(len(set(a.tolist()) & set(e.tolist()))
               for a, e in zip(ids, exact_ids))
    return hits / exact_ids.size


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
