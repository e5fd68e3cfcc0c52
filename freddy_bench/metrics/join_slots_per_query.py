"""``join_slots_per_query``: candidate slots the IVPQ join's rounds scored
a query row, padding included (the tracker's ``join_scan_slots``, one
value a statement, its mean over the window)."""

from freddy_bench.metrics._window import window_mean


def read(ctx):
    return window_mean(ctx, "join_scan_slots")
