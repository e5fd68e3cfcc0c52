"""postgres_word2vec_tpu_torch — the PyTorch/CUDA port of
``postgres_word2vec_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``utils/``, ``evaluation/``, ``store.py``,
``api.py``) so each counterpart sits at the same path. It imports torch and
numpy and never JAX. Importing it initialises no CUDA context and builds
or loads no kernel: the hand-written Hopper kernels (``csrc/``) are built
at their first launch.

Ported: the vector store (arrays, word2vec text and binary files); the
exact, PQ, IVFADC and IVPQ index families with the int8 configuration and
online insert; the whole ``Freddy`` engine — kNN, batch, in-set kNN and
joins, analogy, grouping, clustering, tokenize, statistics, autotune,
warmup, save and load — but sharding; FREDDY dump import and export
(``utils/migrate.py``).
"""

from postgres_word2vec_tpu_torch.store import VectorStore
from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex, PQCodebook
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.api import Freddy, RuntimeParams

__version__ = "0.1.0"

__all__ = [
    "VectorStore",
    "ExactIndex",
    "PQIndex",
    "PQCodebook",
    "IVFADCIndex",
    "IVPQIndex",
    "Freddy",
    "RuntimeParams",
    "__version__",
]
