"""The exact scan of the whole store by each coalesced /knn batch.

A batch of B query rows reads the table once, n rows of d bfloat16 values
and a float32 norm each, and makes 2·B·n·d bfloat16 operations; its
output, k rows a query, is negligible. The batches and their query rows
are the front end's counts in the window.
"""


def work(ctx):
    c = ctx.counters["batcher"]
    batches, queries = c["knn_batched_calls"], c["knn_items_done"]
    n, d = int(ctx.config["rows"]), int(ctx.config["dim"])
    return batches * n * (2 * d + 4), 2.0 * queries * n * d, "bf16"
