"""``search_ms.knn``: the search's time a coalesced /knn batch
(``EngineRunner.stage_s``: search, the enqueue and any host read inside
it, + fetch, the wait for the batch's results)."""

from freddy_bench.metrics._common import is_knn


def read(ctx):
    c = ctx.counters
    calls = c["batcher"]["knn_batched_calls"]
    if not is_knn(ctx) or calls <= 0:
        return None
    s = c["stage_s"]
    return 1e3 * (s["search"] + s["fetch"]) / calls
