"""Confidence-model validation: sweep the configured confidence and
report the fraction of queries whose probed cells held at least k·alpha
targets.

The port's ``evaluation/confidence_eval.py`` (the reference's
``confidence_eval.py``).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.confidence_eval \\
        evaluation/config/confidence_eval.json [--device cpu]
"""

from __future__ import annotations

import json

import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.evaluation.harness import confidence_eval
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(config_path: str,
         device: torch.device | str | None = None) -> list[dict]:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    eng.set_alpha(cfg.get_value_or("alpha", 10))
    queries = sample_words(eng, cfg.get_value_or("query_sample", 50),
                           cfg.get_value_or("seed", 0))
    targets = sample_words(eng, cfg.get_value_or("target_sample", 5000),
                           cfg.get_value_or("seed", 0) + 1)
    out = confidence_eval(
        eng, queries, cfg.get_value_or("k", 5), targets,
        confidences=tuple(cfg.get_value_or(
            "confidences", [0.05, 0.2, 0.4, 0.6, 0.8, 0.95])))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    config_cli(main, __doc__)
