"""``join_short_share``: the share of the window's /knn_join statements
whose rounds scanned fused-pair short codes (the tracker's
``join_short_codes``, 1 or 0 a statement), in percent."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    v = window_mean(ctx, "join_short_codes")
    return None if v is None else 100.0 * v
