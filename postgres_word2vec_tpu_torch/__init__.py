"""postgres_word2vec_tpu_torch — the PyTorch/CUDA port of
``postgres_word2vec_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout (``ops/``, ``models/``, ``utils/``, ``evaluation/``, ``store.py``,
``api.py``) so each counterpart sits at the same path. It imports torch and
numpy and never JAX. Importing it initialises no CUDA context and builds
or loads no kernel: the hand-written Hopper kernels (``csrc/``) are built
at their first launch.

Slices 1 and 2 are ported: the vector store; the exact, PQ, IVFADC and
IVPQ index families; the engine's ``knn`` façade in its exact, PQ, PQ +
post-verify, IVFADC and IVFADC + post-verify families, the ``knn_batch``
façade, and the IVPQ kNN-join with statistics and prepared target sets.
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
