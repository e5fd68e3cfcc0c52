"""Evaluation harness — the reference's evaluation/ directory, in-process.

Precision-vs-exact methodology, stage timing ("TRACK"), time/precision
sweeps, confidence validation, target-count prediction (``harness``), the
plots and the HTML report, the measurement helpers (``benchutil``), the
synthetic data generator (``synth``), the serving load driver
(``serving_bench``) and the join's wall-time spread (``join_wall``).

The harness's names are imported on first use, so importing this package
(as the load driver's client processes do) imports no torch.
"""

import importlib

_HARNESS = ("calculate_precision", "get_exact_results", "measurement",
            "batch_measurement", "create_track_statistics",
            "time_precision_sweep", "confidence_eval", "target_count_eval")

__all__ = list(_HARNESS)


def __getattr__(name: str):
    if name not in _HARNESS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.harness"), name)
