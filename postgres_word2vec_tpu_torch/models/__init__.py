"""Index model families ported so far: exact, PQ, IVFADC and IVPQ."""

from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.ivfadc import IVFADCIndex
from postgres_word2vec_tpu_torch.models.ivpq import IVPQIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex, PQCodebook

__all__ = ["ExactIndex", "IVFADCIndex", "IVPQIndex", "PQIndex",
           "PQCodebook"]
