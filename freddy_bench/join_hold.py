"""One run of an IVPQ /knn_join cell, its sampled answers then held to the
IVPQ join's own plain reference (``reference/ivpq_join.py``) over the
program's tables, beside the harness's result line.

    python -m freddy_bench.join_hold --workload <cell> --seed <n> \
        --seconds <s> [--trace 1] [--max-queries 4096]

The benchmark's runs hold the answers to the exact join only (``check.py``,
which reads no table of the program); this holds them, step by step, to
the cell selection, the ADC shortlist in the cell's code form and the
exact re-rank. It prints one JSON line: the harness's result, then under
``hold`` the served rows outside the reference's loose shortlist
(``outside``; a row within 1e-5 of its edge counts as inside), the widest
gap of a served j-th best below the reference's (``gap``), the queries
left out for an ambiguous cell selection (``skipped``), and, from the
program's own join of the same queries, the queries whose scanned rows
fall short of their selected cells' rows (``cut_by_budget``). The
benchmark's own runs never run it.
"""

from __future__ import annotations

import json
import sys


def _setting(wl: dict, key: str, default):
    v = default
    for step in wl["setup"]:
        v = step["body"].get(key, v)
    return v


def hold_run(cell: str, seed: int, seconds: float, trace: bool, *,
             max_queries: int = 4096, device: str | None = None,
             overrides: dict | None = None) -> dict:
    import torch

    from freddy_bench import check, harness, manifest
    from freddy_bench.reference.ivpq_join import IVPQJoinReference, hold
    from freddy_bench.reference.knn import true_sims

    got: dict = {}
    build, compare = harness.build_engine, check.compare

    def keep_engine(cfg, vecs, s):
        got["eng"], got["vecs"] = build(cfg, vecs, s), vecs
        return got["eng"]

    def keep_answers(kind, answers, vectors, k, **kw):
        got["answers"], got["targets"] = answers, kw.get("targets")
        return compare(kind, answers, vectors, k, **kw)

    harness.build_engine, check.compare = keep_engine, keep_answers
    try:
        result = harness.run(cell, seed, seconds, trace, device=device,
                             overrides=overrides)
    finally:
        harness.build_engine, check.compare = build, compare

    wl = {**manifest.load_json("workloads", cell),
          **(overrides or {}).get("workload", {})}
    k = int(wl["body"]["k"])
    alpha = int(_setting(wl, "set_alpha", 3))
    pvf = int(_setting(wl, "set_pvf", 20))
    conf = float(_setting(wl, "set_confidence_value", 0.8))
    thr = float(_setting(wl, "set_long_codes_threshold", 1e7))
    eng, vecs, targets = got["eng"], got["vecs"], got["targets"]
    qids, ids, _, bad = got["answers"]
    ok = torch.nonzero(~bad).flatten()
    g = torch.Generator(device=ok.device).manual_seed(
        harness.seed64(seed) ^ 0x401D)
    pick = ok[torch.randperm(ok.shape[0], generator=g,
                             device=ok.device)[:max_queries]]
    qs, served = qids[pick], ids[pick]
    iv = eng.ivpq
    domain = (targets if wl["targets"].get("statistics")
              else torch.arange(vecs.shape[0], device=vecs.device))
    ref = IVPQJoinReference(vecs, iv.coarse.centroids,
                            iv.codebook.centroids, iv.codes, iv.cell_of,
                            targets, domain)
    lists = ref.shortlists(qs, k, alpha=alpha, pvf=pvf, confidence=conf,
                           long_codes_threshold=thr)
    h = hold(lists, served, true_sims(vecs, qs, served), k)
    # the program's join of the same queries: rows scanned against the
    # rows of the cells the reference selects
    ph = eng.prepared_targets[wl["targets"]["name"]]
    _, _, info = iv.search_join(
        vecs[qs], k, prepared=ph, statistics=eng._active_statistics(),
        alpha=alpha, pvf=pvf, method=int(_setting(wl, "set_method_flag", 0)),
        confidence=conf, long_codes_threshold=thr, return_info=True)
    cand = torch.tensor([-1 if sl is None else sl["candidates"]
                         for sl in lists], device=qs.device)
    seen = cand >= 0
    h.update(
        cut_by_budget=int((info["retrieved"][seen] < cand[seen]).sum()),
        candidates={"min": int(cand[seen].min()),
                    "mean": float(cand[seen].double().mean()),
                    "max": int(cand[seen].max())},
        short_codes=sorted({sl["short"] for sl in lists if sl}),
        scan_slots=info["scan_slots"], rounds=info["rounds"],
        queries=int(qs.shape[0]), sampled=int(qids.shape[0]))
    return {"result": result, "hold": h}


def main(argv=None, *, device: str | None = None,
         overrides: dict | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m freddy_bench.join_hold",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--max-queries", type=int, default=4096)
    args = ap.parse_args(argv)
    out = hold_run(args.workload, args.seed, args.seconds, bool(args.trace),
                   max_queries=args.max_queries, device=device,
                   overrides=overrides)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
