"""The benchmark's command: one run of one cell.

    python -m freddy_bench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``: each compared number beside its limit, also the last
lines on standard error). This module imports nothing heavy: the client
processes, started with ``spawn``, import it again.
"""

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    # the build and kernel caches of anything the run loads stay inside
    # the checkout, at fixed paths
    _cache = Path.cwd() / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(_cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(_cache / "torch_extensions"))
    from freddy_bench.harness import main

    sys.exit(main())
