"""``device_idle.knn``: the share of the traced /knn window in which no
kernel, copy or set ran on the card (the profiler's timeline)."""

from freddy_bench.metrics._common import idle_pct, is_knn


def read(ctx):
    return idle_pct(ctx) if is_knn(ctx) else None
