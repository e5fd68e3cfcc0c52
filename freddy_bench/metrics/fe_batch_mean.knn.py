"""``fe_batch_mean.knn``: /knn requests a coalesced device batch in the
window (``server_async._LoopBatcher``'s items over its batched calls)."""

from freddy_bench.metrics._common import is_knn


def read(ctx):
    c = ctx.counters["batcher"]
    if not is_knn(ctx) or c["knn_batched_calls"] <= 0:
        return None
    return c["knn_items_done"] / c["knn_batched_calls"]
