"""``kernel_roofline.join``: the least time of the join statements' work
at the window's inputs over the device time of every kernel the window
ran, from the trace."""

from freddy_bench.metrics._common import is_join, roofline_pct


def read(ctx):
    return roofline_pct(ctx) if is_join(ctx) else None
