"""Helpers the metric readers share."""

import math


def p95_ms(latencies: list) -> float | None:
    """The 95th percentile (nearest rank) of every request's latency in
    ms; a failed request (None) counts as beyond any limit."""
    if not latencies:
        return None
    vals = sorted(math.inf if x is None else x for x in latencies)
    v = vals[max(0, math.ceil(0.95 * len(vals)) - 1)]
    return None if math.isinf(v) else v * 1e3


def is_knn(ctx) -> bool:
    return ctx.workload["endpoint"] == "/knn"


def is_join(ctx) -> bool:
    return ctx.workload["endpoint"] == "/knn_join"


def roofline_pct(ctx) -> float | None:
    """The least time of the cell's operation over the window's kernel
    time, in percent; None without a trace or a kernel."""
    from freddy_bench.manifest import work_function
    from freddy_bench.roofline import least_seconds

    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    nbytes, ops, kind = work_function(ctx.workload["operation"])(ctx)
    return 100.0 * least_seconds(nbytes, ops, kind) / ctx.trace.kernel_s


def idle_pct(ctx) -> float | None:
    """The share of the traced window in which nothing ran on the card."""
    if ctx.trace is None or not ctx.trace.events or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
