"""``join_queue_ms``: the front end's wait a /knn_join statement, from
its last byte read (the JSON decode included) until the engine thread
holds the device lock (the tracker's ``fe_queue_time``, its mean over the
window)."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    m = window_mean(ctx, "fe_queue_time")
    return None if m is None else 1e3 * m
