"""FREDDY database migration: Postgres dump ↔ engine directory.

The port's ``index_creation/import_freddy.py``. The reference's index
state lives in 10 Postgres tables; dump them with ``COPY <table> TO
'<dir>/<table>.copy'`` and this tool loads everything (vocabulary,
vectors, all three quantizers' codebooks and code tables, statistics
tables) verbatim, with no retraining, into a saved engine directory:

    python -m postgres_word2vec_tpu_torch.cli.index_creation.import_freddy \\
        import <dump_dir> <engine_dir> [--device cpu]

The reverse writes an engine back out as COPY files a FREDDY instance
restores with ``COPY <table> FROM``:

    python -m postgres_word2vec_tpu_torch.cli.index_creation.import_freddy \\
        export <engine_dir> <dump_dir> [--device cpu]

Custom table names: pass ``role=table`` pairs after the directories (roles:
``postgres_word2vec_tpu_torch.utils.migrate.DEFAULT_TABLES``).
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.api import Freddy
from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.utils import migrate
from postgres_word2vec_tpu_torch.utils.config import INFO, Logger
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(argv: list[str], device: torch.device | str | None = None
         ) -> Freddy:
    """``argv``: mode, source, destination, then ``role=table`` pairs →
    the engine imported or exported."""
    device = resolve_device(device)
    mode, src, dst = argv[0], Path(argv[1]), Path(argv[2])
    tables = dict(pair.split("=", 1) for pair in argv[3:])
    log = Logger()
    t0 = time.perf_counter()
    if mode == "import":
        eng = migrate.import_engine(src, tables=tables or None,
                                    device=device)
        built = [n for n, i in (("pq", eng.pq), ("ivfadc", eng.ivfadc),
                                ("ivpq", eng.ivpq)) if i is not None]
        log.log(INFO, f"imported {eng.store.size} x {eng.store.dim} "
                      f"vectors, indexes: {built or 'none'}, statistics: "
                      f"{sorted(eng.statistics) or 'none'} in "
                      f"{time.perf_counter() - t0:.1f}s")
        eng.save(dst)
        log.log(INFO, f"engine written to {dst}")
    elif mode == "export":
        eng = Freddy.load(src, device=device)
        migrate.export_engine(eng, dst, tables=tables or None)
        log.log(INFO, f"dump written to {dst} in "
                      f"{time.perf_counter() - t0:.1f}s")
    else:
        raise SystemExit(f"unknown mode {mode!r} (import|export)")
    return eng


if __name__ == "__main__":
    p = arg_parser(__doc__)
    p.add_argument("mode", choices=("import", "export"))
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("tables", nargs="*", metavar="role=table")
    args = p.parse_args()
    main([args.mode, args.src, args.dst, *args.tables], device=args.device)
