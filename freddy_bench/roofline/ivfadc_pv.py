"""IVFADC with post-verification for each query row the window sent.

For a query: its squared distances to the C coarse centroids (read once
a batch), its LUT (m·ks float32, built from the codebook, read once a
batch), the m one-byte codes of every row in its w nearest cells, and
the k·pvf shortlisted rows' d float32 values for the exact re-rank.
Operations (float32): 2·C·d for the coarse distances, 2·m·ks·dsub for
the LUT, m adds a scanned row, 2·d a re-ranked row. The rows in each
query's cells are counted from the index's cell sizes and centroids.
"""

import torch


def work(ctx):
    ivf = ctx.engine.ivfadc
    setup = {}
    for step in ctx.workload["setup"]:
        setup.update(step["body"])
    w, pvf = int(setup.get("set_w", 3)), int(setup.get("set_pvf", 20))
    k = int(ctx.workload["body"]["k"])
    coarse = ivf.coarse.centroids.double()
    sizes = (ivf.cell_offsets[1:] - ivf.cell_offsets[:-1]).long()
    vecs = ctx.engine.store.vectors_norm
    ids = torch.as_tensor(ctx.sent_ids, dtype=torch.int64,
                          device=vecs.device)
    rows = 0
    for s in range(0, ids.shape[0], 4096):
        q = vecs[ids[s:s + 4096]].double()
        cd = torch.cdist(q, coarse)
        cells = torch.topk(cd, w, dim=1, largest=False).indices
        rows += int(sizes[cells].sum())
    c, d = coarse.shape
    m, ks, dsub = ivf.codebook.centroids.shape
    batches = ctx.counters["batcher"]["knn_batched_calls"]
    nq = ids.shape[0]
    nbytes = (batches * (c * d * 4 + m * ks * dsub * 4) + rows * m
              + nq * (d * 4 + k * pvf * d * 4) + nq * k * 12)
    ops = nq * (2.0 * c * d + 2.0 * m * ks * dsub + 2.0 * k * pvf * d) \
        + rows * m
    return nbytes, ops, "fp32"
