"""``join_reply_ms``: the front end's reply a /knn_join statement, from
the engine's return until the response is written: the loop's wake-up,
the JSON encode, the write and drain (the tracker's ``fe_reply_time``,
its mean over the window)."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    m = window_mean(ctx, "fe_reply_time")
    return None if m is None else 1e3 * m
