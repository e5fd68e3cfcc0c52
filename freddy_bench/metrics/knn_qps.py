"""``knn_qps``: /knn answers with status 200 completed inside the window,
over the window's length (host clock, the clients' side)."""

from freddy_bench.metrics._common import is_knn


def read(ctx):
    return ctx.completed / ctx.seconds if is_knn(ctx) else None
