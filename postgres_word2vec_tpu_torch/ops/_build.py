"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds them in seconds: one ``nvcc -c`` per source, all started
together, then one link. The library is built at first use into
``postgres_word2vec_tpu_torch/_build/``; its file name carries a hash of
the sources and flags, so an edited source rebuilds and a stale library is
never loaded. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              # ptxas reports registers, shared memory and spills per
              # kernel into BuildResult.compiler_output.
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry points and their argument types (every pointer and the stream
#: as c_void_p, sizes as c_int / c_int64). Each returns a cudaError_t.
SIGNATURES = {
    "pw2v_adc_scan": (_P, _P, _I, _P, _I, _I, _I, _I64, _P),
    "pw2v_adc_scan_qb": (_P, _P, _I, _P, _I, _I, _I, _I64, _I, _P),
    "pw2v_adc_scan_binned": (_P, _P, _I, _P, _P, _I, _I, _I, _I64, _I, _I,
                             _P),
    "pw2v_adc_scan_binned_qb": (_P, _P, _I, _P, _P, _I, _I, _I, _I64, _I,
                                _I, _I, _P),
    "pw2v_fused_exact_scan": (_P, _P, _P, _P, _P, _I, _I, _I64, _I, _P),
    "pw2v_budget_adc": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I64, _I, _I,
                        _P),
    "pw2v_budget_adc_grouped": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                                _I64, _I, _I, _I, _P),
    "pw2v_budget_exact": (_P, _P, _P, _P, _P, _I, _I, _I64, _I, _I, _P),
    "pw2v_budget_exact_grouped": (_P, _P, _P, _P, _P, _P, _I, _I, _I64, _I,
                                  _I, _I, _P),
    "pw2v_budget_exact_grouped_parts": (_P, _P, _P, _P, _P, _P, _I, _I,
                                        _I64, _I, _I, _I, _I, _P),
    "pw2v_adc_scan_int8": (_P, _P, _P, _I, _P, _I, _I, _I, _I64, _P),
    "pw2v_adc_scan_int8_qb": (_P, _P, _P, _I, _P, _I, _I, _I, _I64, _I, _P),
    "pw2v_adc_scan_binned_int8": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I64,
                                  _I, _I, _P),
    "pw2v_adc_scan_binned_int8_qb": (_P, _P, _P, _I, _P, _P, _I, _I, _I,
                                     _I64, _I, _I, _I, _P),
    "pw2v_budget_adc_grouped_int8": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                     _I, _I64, _I, _I, _I, _P),
}


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float          # compile time; 0.0 when the library was cached
    compiler_output: str    # nvcc/ptxas report of a fresh build


_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpw2v_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put "
                           "nvcc on PATH to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side and wait for every one; raise with
    the failing commands' output. → their stdout + stderr."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"{' '.join(c)}\n{o}" for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for the current sources
    and flags exists."""
    path = library_path()
    if path.exists():
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in srcs]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                           for p, o in zip(srcs, objs)])
        lib = str(Path(tmp) / "lib.so")
        report += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, path)      # atomic: a reader never sees half a file
    return BuildResult(path, time.perf_counter() - t0, report)


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.pw2v_error_string.argtypes = [ctypes.c_int]
        lib.pw2v_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
