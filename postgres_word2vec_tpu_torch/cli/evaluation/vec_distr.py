"""Dataset geometry study: the distribution of angles to the nearest and
the farthest neighbour, from the engine's own exact search.

The port's ``evaluation/vec_distr.py`` (the reference's ``vec_distr.py``,
faiss and brute force replaced by the exact index and one
``torch.matmul`` over the whole table).

    python -m postgres_word2vec_tpu_torch.cli.evaluation.vec_distr \\
        evaluation/config/time_measurement.json [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import (config_cli,
                                                     engine_from_config,
                                                     sample_words)
from postgres_word2vec_tpu_torch.utils.config import Configuration
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def _spread(x: np.ndarray) -> dict:
    return {"mean": float(x.mean()), "p10": float(np.percentile(x, 10)),
            "p90": float(np.percentile(x, 90))}


def _angle_deg(x: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip(x, -1, 1))).mean())


def main(config_path: str,
         device: torch.device | str | None = None) -> dict:
    device = resolve_device(device)
    cfg = Configuration(config_path)
    eng = engine_from_config(cfg, device)
    sample = sample_words(eng, cfg.get_value_or("query_sample", 100),
                          cfg.get_value_or("seed", 0))
    q = eng._query_matrix(sample)
    # nearest (excluding self) and farthest cosine per sampled word
    d, _ = eng.exact.search(q, 2)
    nearest = (1.0 - d / 2.0)[:, 1].cpu().numpy()  # rank 0: the word itself
    scores = torch.matmul(q, eng.store.vectors_norm.T)
    farthest = torch.amin(scores, dim=-1).cpu().numpy()
    out = {
        "sample": len(sample),
        "nearest_cos": _spread(nearest),
        "farthest_cos": _spread(farthest),
        "nearest_angle_deg": _angle_deg(nearest),
        "farthest_angle_deg": _angle_deg(farthest),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    config_cli(main, __doc__)
