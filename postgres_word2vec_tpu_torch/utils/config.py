"""JSON configuration + leveled logger — parity with the reference's
index_creation/config.py and logger.py (without logger.py's undefined-``f``
file-write bug).

The port's own copy of ``Configuration`` and ``Logger`` from
``postgres_word2vec_tpu/utils/config.py``; that module's
``apply_platform_from_env`` is a workaround for JAX's TPU container and has
no counterpart here.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class Configuration:
    """JSON config reader (config.py:5-12 parity): ``get_value(key)`` with
    a ``has_key`` helper and defaulting variant."""

    def __init__(self, path: str | Path):
        with open(path) as f:
            self._values = json.load(f)

    def get_value(self, key: str):
        return self._values[key]

    def get_value_or(self, key: str, default):
        return self._values.get(key, default)

    def has_key(self, key: str) -> bool:
        return key in self._values


INFO, WARNING, ERROR = "INFO", "WARNING", "ERROR"


class Logger:
    """Leveled logger to stdout or a file (logger.py:9-41 parity)."""

    def __init__(self, log_to_file: bool = False,
                 path: str | Path | None = None):
        self._fh = open(path, "a") if (log_to_file and path) else None

    def log(self, level: str, message: str) -> None:
        line = (f"{time.strftime('%Y-%m-%d %H:%M:%S')} {level}: {message}")
        out = self._fh if self._fh else sys.stdout
        print(line, file=out, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
