"""The IVPQ kNN-join (PQ + PV) in short codes, of every statement sent in
the window.

As ``ivpq_join.py``, but each target row is scanned through fused pairs
of subquantizers (ivpq_search_in.c:262-291): for each query row, its d
float32 values, its m·ks LUT (built from the codebook) fused into the
(m/2)·ks² float32 pair table, the m/2 two-byte codes of the α·k target
rows that the cell selection must cover, and the k·pvf shortlisted rows'
d float32 values for the exact re-rank; the codebook is read once a
statement. Operations (float32): 2·m·ks·dsub for the LUT, (m/2)·ks² adds
for the pair table, m/2 adds a scanned row, 2·d a re-ranked row.
"""


def work(ctx):
    setup = {}
    for step in ctx.workload["setup"]:
        setup.update(step["body"])
    alpha = int(setup["set_alpha"])
    pvf = int(setup.get("set_pvf", 20))
    k = int(ctx.workload["body"]["k"])
    build = ctx.config["build"]
    m, ks = int(build["ivpq_m"]), int(build["ivpq_k"])
    d = int(ctx.config["dim"])
    dsub, pairs = d // m, m // 2
    statements = len(ctx.latencies)
    nq = statements * int(ctx.workload["query_words"])
    rows = nq * alpha * k
    nbytes = (statements * m * ks * dsub * 4 + rows * pairs * 2
              + nq * (d * 4 + pairs * ks * ks * 4 + k * pvf * d * 4)
              + nq * k * 12)
    ops = nq * (2.0 * m * ks * dsub + pairs * ks * ks + 2.0 * k * pvf * d) \
        + rows * pairs
    return nbytes, ops, "fp32"
