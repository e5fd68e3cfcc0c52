"""The mean of a tracker list over the window, for the /knn_join cells."""

from freddy_bench.metrics._common import is_join


def window_mean(ctx, name: str) -> float | None:
    """The mean of the tracker's list ``name`` in the window; None outside
    a /knn_join cell or where the program records no such list."""
    t = ctx.counters["tracker"].get(name, [])
    if not is_join(ctx) or not t:
        return None
    return sum(t) / len(t)
