"""``join_rows_per_query``: target rows the IVPQ join scanned a query row
(the tracker's ``retrieved``, its mean over the window)."""

from freddy_bench.metrics._common import is_join


def read(ctx):
    r = ctx.counters["tracker"].get("retrieved", [])
    if not is_join(ctx) or not r:
        return None
    return sum(r) / len(r)
