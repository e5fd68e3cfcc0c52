"""``join_format_ms``: the façade's formatting a /knn_join statement,
rows to (query, word, similarity) tuples after the result's read, its
copy of the distances included (the tracker's ``join_format_time``, its
mean over the window)."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    m = window_mean(ctx, "join_format_time")
    return None if m is None else 1e3 * m
