"""The IVPQ kNN-join (PQ + PV) of every statement sent in the window.

Defined by the cell's inputs and the stated α, not by what the program
counts: for each query row, its d float32 values, its LUT (m·ks float32,
built from the codebook), the m one-byte codes of the α·k target rows
that the statistics-driven cell selection must cover (the least a round
at α scans; the program scans whole cells, so more), and the k·pvf
shortlisted rows' d float32 values for the exact re-rank; the codebook
is read once a statement. Operations (float32): 2·m·ks·dsub for the LUT,
m adds a scanned row, 2·d a re-ranked row.
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
    dsub = d // m
    statements = len(ctx.latencies)
    nq = statements * int(ctx.workload["query_words"])
    rows = nq * alpha * k
    nbytes = (statements * m * ks * dsub * 4 + rows * m
              + nq * (d * 4 + k * pvf * d * 4) + nq * k * 12)
    ops = nq * (2.0 * m * ks * dsub + 2.0 * k * pvf * d) + rows * m
    return nbytes, ops, "fp32"
