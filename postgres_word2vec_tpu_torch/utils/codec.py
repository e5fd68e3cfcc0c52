"""Binary vector codecs — wire/storage compatibility with FREDDY.

The reference stores every vector and code row as a little-endian packed
``bytea`` (float4 / int4 / int2 arrays) and converts at the SQL boundary
with ``vec_to_bytea`` / ``read_bytea`` / ``read_bytea_int16`` /
``read_bytea_float`` (freddy.c:1660-1826, converters index_utils.c:
1078-1124). Inside this framework arrays are native, but these codecs make
migration possible: a FREDDY Postgres dump's vector/code columns decode
directly into store/index arrays, and our arrays encode back into blobs a
FREDDY instance can ingest.

The port's own copy of ``postgres_word2vec_tpu/utils/codec.py`` (numpy
only), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def vec_to_bytes(values, kind: str = "float4") -> bytes:
    """Pack a 1-D array as a little-endian blob (``vec_to_bytea`` parity;
    kinds: float4 | int4 | int2)."""
    dtype = {"float4": "<f4", "int4": "<i4", "int2": "<i2"}[kind]
    return np.ascontiguousarray(np.asarray(values), dtype=dtype).tobytes()


def bytes_to_float4(blob: bytes) -> np.ndarray:
    """``read_bytea_float`` parity."""
    return np.frombuffer(blob, dtype="<f4").copy()


def bytes_to_int4(blob: bytes) -> np.ndarray:
    """``read_bytea`` parity."""
    return np.frombuffer(blob, dtype="<i4").copy()


def bytes_to_int2(blob: bytes) -> np.ndarray:
    """``read_bytea_int16`` parity — the reference's code-row storage type
    (codes serialized as int2[], pq_index.py:106)."""
    return np.frombuffer(blob, dtype="<i2").copy()


def decode_vector_column(blobs, kind: str = "float4") -> np.ndarray:
    """Decode an iterable of equal-length blobs into an (n, d) array — the
    bulk path for importing a dumped FREDDY table."""
    decoder = {"float4": bytes_to_float4, "int4": bytes_to_int4,
               "int2": bytes_to_int2}[kind]
    rows = [decoder(b) for b in blobs]
    return np.stack(rows) if rows else np.zeros((0, 0))


def encode_vector_column(array, kind: str = "float4") -> list[bytes]:
    """Encode an (n, d) array into per-row blobs (bulk export)."""
    return [vec_to_bytes(row, kind) for row in np.asarray(array)]
