"""``knn_p95_ms``: the 95th percentile of every /knn request's latency
sent in the window, from the client's side; a failed one counts as
beyond any limit."""

from freddy_bench.metrics._common import is_knn, p95_ms


def read(ctx):
    return p95_ms(ctx.latencies) if is_knn(ctx) else None
