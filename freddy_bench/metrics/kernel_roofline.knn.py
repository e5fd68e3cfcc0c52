"""``kernel_roofline.knn``: the least time of the /knn search work at the
window's inputs (``roofline/<operation>.py``) over the device time of
every kernel the window ran, from the trace."""

from freddy_bench.metrics._common import is_knn, roofline_pct


def read(ctx):
    return roofline_pct(ctx) if is_knn(ctx) else None
