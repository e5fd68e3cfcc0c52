"""Shared pieces of the research drivers (``recall_ceiling``,
``synth_calibrate``, ``join_nq_sweep``, ``join_method_diag``,
``scale_capacity``, ``scale_join_10M``, ``roofline``): parsing their
command line (built with ``cli._common.arg_parser``), the scan names,
the chunked word-like table and their JSON output.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.evaluation import synth
from postgres_word2vec_tpu_torch.utils.device import resolve_device

#: the repository's ``reports/`` directory
REPORTS = Path(__file__).resolve().parents[3] / "reports"

#: the JAX scripts' ``--impl`` names → the port's PQ scan names
#: (``PQIndex._IMPLS``); the port's own names are taken as they are
IMPL_NAMES = {"pallas_binned": "kernel_binned", "pallas": "kernel",
              "xla": "plain", "kernel_binned": "kernel_binned",
              "kernel": "kernel", "plain": "plain"}


def parse(p: argparse.ArgumentParser, argv: list[str] | None,
          device: torch.device | str | None
          ) -> tuple[argparse.Namespace, torch.device]:
    """Parse ``argv`` (the command line when None); ``device``, when
    given, wins over ``--device``. Without a card and without a device it
    raises before any work."""
    args = p.parse_args(argv)
    return args, resolve_device(device if device is not None
                                else args.device)


def scan_impl(name: str) -> str:
    """A PQ scan name (the port's, or the JAX script's) → the port's."""
    if name not in IMPL_NAMES:
        raise ValueError(f"--impl must be one of {'|'.join(IMPL_NAMES)}, "
                         f"got {name!r}")
    return IMPL_NAMES[name]


def wordlike_table(n: int, d: int, chunk: int, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scale drivers' table: ``⌈n / chunk⌉`` chunks of word-like rows,
    chunk ``i`` drawn from its own seed ``1000 + i``, their norms taken in
    float32, then cast to bfloat16 into one ``(n, d)`` table on
    ``device`` → (table bf16, norms float32)."""
    table = torch.empty(n, d, dtype=torch.bfloat16, device=device)
    norms = torch.empty(n, dtype=torch.float32, device=device)
    for i, start in enumerate(range(0, n, chunk)):
        rows = min(chunk, n - start)
        gen = torch.Generator(device).manual_seed(1000 + i)
        vf = synth.generate_wordlike(gen, rows, d)
        norms[start:start + rows] = torch.sum(vf * vf, dim=-1)
        table[start:start + rows] = vf.to(torch.bfloat16)
        del vf
    return table, norms


def write_json(path: str | Path, obj, indent: int) -> str:
    """Write ``obj`` to ``path`` (its directory made) → the absolute
    path."""
    out = Path(path).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(obj, indent=indent))
    return str(out)
