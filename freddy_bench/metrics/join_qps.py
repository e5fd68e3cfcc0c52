"""``join_qps``: query rows answered by the /knn_join statements
completed inside the window, over the window's length."""

from freddy_bench.metrics._common import is_join


def read(ctx):
    if not is_join(ctx):
        return None
    return ctx.completed * int(ctx.workload["query_words"]) / ctx.seconds
