"""``idle_in_search.join``: the share of the traced /knn_join window in
which no device operation ran while the engine thread was inside a
statement's ``join_search_time`` or ``join_read_time`` span, with the
program's spans put on the device trace's clock (``freddy_bench/spans``).
Prints on standard error the window's idle seconds by the innermost
engine-thread span open during them."""

import json
import sys

from freddy_bench.metrics._common import is_join
from freddy_bench.spans import SEARCH_SPANS, idle_by_span, ring_records


def read(ctx):
    if not is_join(ctx):
        return None
    by = idle_by_span(ctx.trace, ring_records())
    if by is None:
        return None
    print("idle_in_search.join: idle s by engine-thread span "
          + json.dumps(by), file=sys.stderr, flush=True)
    return 100.0 * sum(by["seconds"].get(n, 0.0)
                       for n in SEARCH_SPANS) / ctx.trace.window_s
