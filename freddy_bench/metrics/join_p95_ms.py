"""``join_p95_ms``: the 95th percentile of every /knn_join statement's
latency sent in the window, from the client's side."""

from freddy_bench.metrics._common import is_join, p95_ms


def read(ctx):
    return p95_ms(ctx.latencies) if is_join(ctx) else None
