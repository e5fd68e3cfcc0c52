"""postgres_word2vec_tpu_torch — the PyTorch/CUDA port of
``postgres_word2vec_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``parallel/``, ``utils/``, ``evaluation/``,
``store.py``, ``api.py``, ``server.py``, ``server_async.py``) so each
counterpart sits at the same path. It imports torch and numpy and never JAX. Importing it
initialises no CUDA context and builds or loads no kernel: the
hand-written Hopper kernels (``csrc/``) are built at their first launch.

The names below are imported on first use, so a process that needs only a
torch-free module (the load driver's client processes,
``evaluation/serving_bench.py``) does not import torch by importing the
package.

Ported: the vector store (arrays, word2vec text and binary files); the
exact, PQ (with anisotropic refinement), IVFADC and IVPQ index families
with the int8 configuration, online insert and the streaming builders
(``models/builders.py``); the whole ``Freddy`` engine — kNN, batch, in-set
kNN and joins, analogy, grouping, clustering, tokenize, statistics,
autotune, warmup, save and load, row sharding over a device mesh
(``parallel/sharding.py``); FREDDY dump import and export
(``utils/migrate.py``); the serving runtime (``server.py``,
``server_async.py``) and the evaluation harness (``evaluation/``).
"""

import importlib

__version__ = "0.1.0"

#: public name → the module that defines it
_EXPORTS = {
    "VectorStore": "store",
    "ExactIndex": "models.exact",
    "PQIndex": "models.pq",
    "PQCodebook": "models.pq",
    "IVFADCIndex": "models.ivfadc",
    "IVPQIndex": "models.ivpq",
    "Freddy": "api",
    "RuntimeParams": "api",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value
