"""ctypes bindings to the native IO library (native/fastio.cpp).

The port's own copy of ``postgres_word2vec_tpu/utils/native_io.py``: the
same C parser (``native/fastio.cpp``, plain C ABI + ctypes), compiled on
first use with ``native/Makefile``'s flags into this package's build
directory (``_build/``, beside the CUDA kernels), never into ``native/``,
so the JAX package's ``native/libfastio.so`` is left alone. Each process
compiles to a name of its own and renames it into place, so processes
that build at once never load a half-written library.
``VectorStore.from_text_file`` treats any failure here as "use the numpy
parser"; ``VectorStore.from_binary_file`` has no other parser and raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastio.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "_build" / "libfastio.so"
#: native/Makefile's CXXFLAGS
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")
_lib = None


def _build() -> None:
    _LIB_PATH.parent.mkdir(exist_ok=True)
    tmp = _LIB_PATH.with_name(f"libfastio.{os.getpid()}.so")
    subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                    str(_SOURCE)], check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    for name in ("fastio_parse_text", "fastio_parse_binary"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
    lib.fastio_free.restype = None
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _parse(fn_name: str, path: Path, max_words: int | None
           ) -> tuple[list[str], np.ndarray]:
    lib = _load()
    vecs_p = ctypes.POINTER(ctypes.c_float)()
    words_p = ctypes.c_char_p()
    words_len = ctypes.c_long()
    n = ctypes.c_long()
    d = ctypes.c_long()
    rc = getattr(lib, fn_name)(
        str(path).encode(), ctypes.c_long(max_words or 0),
        ctypes.byref(vecs_p), ctypes.byref(words_p),
        ctypes.byref(words_len), ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise OSError(f"{fn_name} failed with code {rc} for {path}")
    try:
        count, dim = n.value, d.value
        vecs = np.ctypeslib.as_array(vecs_p, shape=(count, dim)).copy()
        blob = ctypes.string_at(words_p, words_len.value)
        words = blob.decode("utf-8", errors="replace").split("\n")[:count]
    finally:
        lib.fastio_free(ctypes.cast(vecs_p, ctypes.c_void_p))
        lib.fastio_free(ctypes.cast(words_p, ctypes.c_void_p))
    return words, vecs


def load_text_embeddings(path: Path, max_words: int | None = None
                         ) -> tuple[list[str], np.ndarray]:
    """word2vec text format via the native parser."""
    return _parse("fastio_parse_text", path, max_words)


def load_binary_embeddings(path: Path, max_words: int | None = None
                           ) -> tuple[list[str], np.ndarray]:
    """word2vec .bin format via the native parser (replaces the reference's
    gensim conversion step, transform_vecs.py)."""
    return _parse("fastio_parse_binary", path, max_words)
