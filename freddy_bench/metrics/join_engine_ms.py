"""``join_engine_ms``: the façade's time a /knn_join statement
(``Freddy.knn_in_ivpq_batch``'s ``total_time``, which ends in a host read
of the result and leaves out formatting)."""

from freddy_bench.metrics._common import is_join


def read(ctx):
    t = ctx.counters["tracker"].get("total_time", [])
    if not is_join(ctx) or not t:
        return None
    return 1e3 * sum(t) / len(t)
