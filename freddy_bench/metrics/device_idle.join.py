"""``device_idle.join``: the share of the traced /knn_join window in
which nothing ran on the card (the profiler's timeline)."""

from freddy_bench.metrics._common import idle_pct, is_join


def read(ctx):
    return idle_pct(ctx) if is_join(ctx) else None
