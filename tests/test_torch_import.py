"""The port never imports JAX (nor the JAX package), aiohttp or
matplotlib at import time, and importing it initialises no CUDA context
and builds no kernel; the load driver's client module imports no torch."""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import postgres_word2vec_tpu_torch

REPO = Path(__file__).resolve().parent.parent
#: the command-line drivers, one for each script of the repository's
#: index_creation/, evaluation/ and examples/ directories that is ported
#: (the research drivers of evaluation/ with their shared module)
CLI_MODULES = tuple(
    f"cli.{group}.{name}" for group, names in (
        ("index_creation", ("vec2database", "transform_vecs", "pq_index",
                            "ivfadc", "ivpq", "load_index",
                            "import_freddy")),
        ("evaluation", ("time_measurement", "time_precision_eval",
                        "step_wise_time_measurement", "confidence_eval",
                        "target_counts", "flexible_pq_eval",
                        "vec_distr", "recall_ceiling", "synth_calibrate",
                        "join_nq_sweep", "join_method_diag",
                        "scale_capacity", "scale_join_10M", "roofline",
                        "_research")),
        ("examples", ("quickstart", "serving", "multichip")))
    for name in names) + ("cli._common",)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        postgres_word2vec_tpu_torch.__path__, "postgres_word2vec_tpu_torch."))


def test_the_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("store", "api", "ops.vector_ops", "ops.topk", "ops.kmeans",
                 "ops.lut", "ops.adc", "ops.kernels", "ops._build",
                 "models.exact", "models.pq", "models.ivfadc",
                 "models.ivpq", "utils.shapes",
                 "utils.tracker", "utils.convert", "utils.codec",
                 "utils.native_io", "utils.migrate", "utils.config",
                 "utils.profiling", "models.builders", "server",
                 "server_async", "evaluation.synth", "evaluation.join_wall",
                 "evaluation.benchutil", "evaluation.bounds",
                 "evaluation.harness",
                 "evaluation.plots", "evaluation.html_report",
                 "evaluation.serving_bench", "parallel.sharding",
                 *CLI_MODULES):
        assert f"postgres_word2vec_tpu_torch.{name}" in mods, name


def test_every_port_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, sys
        # any `import jax` (aiohttp, matplotlib) now fails
        for blocked in ("jax", "aiohttp", "matplotlib"):
            sys.modules[blocked] = None
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        import torch
        from postgres_word2vec_tpu_torch.ops import _build
        assert "postgres_word2vec_tpu" not in sys.modules
        assert not any(m.split(".")[0] in ("jax", "aiohttp", "matplotlib")
                       for m, v in sys.modules.items() if v is not None)
        assert not torch.cuda.is_initialized()
        assert _build._lib is None         # no kernel built or loaded
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_every_cli_module_imports_with_jax_blocked():
    """Each driver imports with ``jax``, ``aiohttp`` and ``matplotlib``
    blocked, and imports nothing of the JAX package nor of the root
    ``evaluation/`` and ``index_creation/`` directories."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "aiohttp", "matplotlib"):
            sys.modules[blocked] = None
        for name in {CLI_MODULES!r}:
            importlib.import_module("postgres_word2vec_tpu_torch." + name)
        import torch
        assert not any(m.split(".")[0] in (
            "jax", "aiohttp", "matplotlib", "postgres_word2vec_tpu",
            "evaluation", "index_creation", "_common")
            for m, v in sys.modules.items() if v is not None)
        assert not torch.cuda.is_initialized()
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_the_load_drivers_client_module_imports_no_torch():
    """A spawned client process imports only this module: no torch, so it
    starts fast and touches no CUDA."""
    code = textwrap.dedent("""
        import sys
        import postgres_word2vec_tpu_torch.evaluation.serving_bench as sb
        assert callable(sb.client_window)
        assert "torch" not in sys.modules, "torch imported"
        print("light")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "light"


def test_the_build_is_keyed_by_the_sources():
    from postgres_word2vec_tpu_torch.ops import _build
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libpw2v_kernels_") and path.suffix == ".so"
    assert {p.name for p in _build._sources()} >= {
        "adc_scan.cu", "adc_scan_binned.cu", "fused_exact_scan.cu",
        "adc_common.cuh", "budget_adc.cu", "budget_adc_grouped.cu",
        "budget_exact.cu", "budget_exact_grouped.cu", "budget_common.cuh",
        "bf16.cuh", "cp_async.cuh"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_every_c_entry_point_has_its_signature():
    """Each ``extern "C" int pw2v_*`` of ``csrc/`` is bound in
    ``_build.SIGNATURES`` with as many argument types as it has
    parameters (ctypes would cut a pointer passed without one)."""
    import re
    from postgres_word2vec_tpu_torch.ops import _build
    found = {}
    for src in _build._sources():
        for name, params in re.findall(
                r'extern "C" int (pw2v_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = params.count(",") + 1
    assert found.keys() == _build.SIGNATURES.keys()
    for name, n in found.items():
        assert len(_build.SIGNATURES[name]) == n, name
