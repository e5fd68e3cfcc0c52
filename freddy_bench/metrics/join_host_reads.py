"""``join_host_reads``: device → host reads a /knn_join statement, each of
which drains the stream (the tracker's ``join_host_reads``, its mean over
the window)."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    return window_mean(ctx, "join_host_reads")
