"""``runner_host_ms.knn``: the engine runner's host time a coalesced /knn
batch (``EngineRunner.stage_s``: resolve + gather + format)."""

from freddy_bench.metrics._common import is_knn


def read(ctx):
    c = ctx.counters
    calls = c["batcher"]["knn_batched_calls"]
    if not is_knn(ctx) or calls <= 0:
        return None
    s = c["stage_s"]
    return 1e3 * (s["resolve"] + s["gather"] + s["format"]) / calls
