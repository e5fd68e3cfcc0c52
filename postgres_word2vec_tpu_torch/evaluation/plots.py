"""Report plotting — the reference's plotly renderers, in matplotlib.

The port's copy of ``postgres_word2vec_tpu/evaluation/plots.py``.
matplotlib is optional: it is imported on the first plot, never at import
time (the HTML report, :mod:`html_report`, needs nothing).

Parity targets: the time-vs-precision scatter and bar renderers in
evaluation_utils.py:240-344 / ivpq_evaluation.py:178-204 and the stage
breakdown of step_wise_time_measurement.py. Output is PNG (or any extension
matplotlib supports) instead of plotly HTML.
"""

from __future__ import annotations

from pathlib import Path


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


METHOD_NAMES = {0: "PQ (ADC)", 1: "Exact", 2: "PQ + postverify",
                "baseline_pq_in_batch": "Baseline (PQ in-batch)"}


def plot_time_precision(records: list[dict], path: str | Path) -> Path:
    """Time/precision trade-off curves, one series per method (the README
    kNN-join figure, time_precision_eval_gn.png)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 5))
    by_method: dict = {}
    for r in records:
        by_method.setdefault(r["method"], []).append(r)
    for method, rows in sorted(by_method.items(), key=lambda kv: str(kv[0])):
        rows = sorted(rows, key=lambda r: r["precision"])
        ax.plot([r["precision"] for r in rows],
                [r["time_s"] for r in rows], marker="o",
                label=METHOD_NAMES.get(method, str(method)))
    ax.set_xlabel("precision@k vs exact")
    ax.set_ylabel("time (s)")
    ax.set_title("kNN-join time / precision trade-off")
    ax.legend()
    ax.grid(True, alpha=0.3)
    path = Path(path)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_stage_breakdown(records: list[dict], path: str | Path) -> Path:
    """Stacked wall-vs-inner time per workload size
    (step_wise_time_measurement.py's figure)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 5))
    xs = [str(r["queries"]) for r in records]
    inner = [r["inner_s"] for r in records]
    overhead = [r["interface_overhead_s"] for r in records]
    ax.bar(xs, inner, label="inner (kernel) time")
    ax.bar(xs, overhead, bottom=inner, label="interface overhead")
    ax.set_xlabel("queries")
    ax.set_ylabel("time (s)")
    ax.set_title("stage breakdown")
    ax.legend()
    path = Path(path)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_measurement_bars(times: dict[str, float], path: str | Path,
                          title: str = "response time") -> Path:
    """Bar chart of per-method times (evaluation_utils' bar renderer)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    names = list(times)
    ax.bar(names, [times[n] for n in names])
    ax.set_ylabel("time (s)")
    ax.set_title(title)
    ax.tick_params(axis="x", rotation=30)
    path = Path(path)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
