"""``join_graph_share``: the share of the window's /knn_join statements
whose first budget round replayed its captured CUDA graphs (the tracker's
``join_graph_rounds``, 1 or 0 a statement), in percent."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    v = window_mean(ctx, "join_graph_rounds")
    return None if v is None else 100.0 * v
