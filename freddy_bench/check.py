"""The comparison that decides ``correct``: the served answers (or the
control's) held to the plain reference, as numbers each with its limit.

Every number reads 0 for a perfect answer and grows with the fault:

- ``bad_rows``: answers that break a guarantee outright: not k rows, a row
  that is not a word of the store (or, in a join, of the target set), a
  row twice, rows not best first (by more than 1e-6);
- ``sim_err``: the widest gap between a served similarity and the float64
  similarity of the row served, its product of operands in the precision
  the configuration states (for the fused bfloat16 scan, the rows rounded
  to bfloat16; float32 elsewhere, taken as is);
- ``rank_gap``: the widest gap by which the served answer's j-th best row
  (by that similarity) lies below the reference's j-th best;
- ``outside_shortlist`` (IVFADC + PV): served rows that no IVFADC
  shortlist of these tables holds;
- ``build_miss`` (IVFADC): sampled rows whose cell or codes are not
  nearest, the stage the reference takes from the program;
- ``miss_rate`` (joins, IVFADC + PV): one less the recall@k against the
  exact answer over the same targets (the whole store for /knn); its
  limit is one less the cell's stated recall floor. For IVFADC it holds
  the trained tables, which the other numbers take from the program, to
  a quality of their own.
"""

from __future__ import annotations

import json

import torch

#: served similarities must be best first to within this
ORDER_TOL = 1e-6
#: a served row at most this far below the reference's k-th best is a hit
TIE_TOL = 1e-6


def parse(samples: list, k: int, n: int, join: bool
          ) -> tuple[list[int], list[list[int]], list[list[float]],
                     list[bool]]:
    """The sampled requests' answers → per query row: its id, the served
    row ids and similarities, and whether the answer is malformed."""
    qids, ids, sims, bad = [], [], [], []
    for asked, payload in samples:
        rows = json.loads(payload)["result"]
        pos = 0
        for q in asked:
            got_i, got_s, broken = [], [], False
            while pos < len(rows) and len(got_i) < k:
                row = rows[pos]
                if join and row[0] != f"w{q}":
                    break
                word, sim = (row[1], row[2]) if join else (row[0], row[1])
                pos += 1
                try:
                    rid = int(word[1:]) if word.startswith("w") else -1
                except ValueError:
                    rid = -1
                broken |= not 0 <= rid < n
                got_i.append(rid)
                got_s.append(float(sim))
            broken |= len(got_i) != k or len(set(got_i)) != len(got_i)
            broken |= any(b > a + ORDER_TOL for a, b in zip(got_s, got_s[1:]))
            pad = k - len(got_i)
            qids.append(q)
            ids.append(got_i[:k] + [-1] * pad)
            sims.append(got_s[:k] + [float("nan")] * pad)
            bad.append(broken)
        if pos != len(rows):
            bad[-1] = True
    return qids, ids, sims, bad


def as_tensors(qids, ids, sims, bad, dev):
    """:func:`parse`'s lists as the tensors :func:`compare` takes."""
    return (torch.as_tensor(qids, dtype=torch.int64, device=dev),
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            torch.as_tensor(sims, dtype=torch.float64, device=dev),
            torch.as_tensor(bad, dtype=torch.bool, device=dev))


def _gap(ref_s: torch.Tensor, served_true: torch.Tensor) -> torch.Tensor:
    """Per row, the widest j-th best shortfall (≥ 0) of the served rows'
    float64 similarities against the reference's, both best first."""
    srt = torch.sort(served_true, dim=1, descending=True).values
    return torch.clamp_min(torch.max(ref_s - srt, dim=1).values, 0.0)


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _miss_rate(vectors: torch.Tensor, qids: torch.Tensor,
               served_true: torch.Tensor, k: int,
               targets: torch.Tensor | None) -> float:
    """One less the recall@k of the served rows (their float64
    similarities ``served_true``, (B, k)) against the exact best k among
    ``targets`` (all rows when None); a row within ``TIE_TOL`` of the
    k-th best is a hit."""
    from freddy_bench.reference import knn

    _, ref_s = knn.exact_top_k(vectors, qids, k, targets=targets)
    hits = (served_true >= ref_s[:, k - 1:k] - TIE_TOL).sum(dim=1)
    return 1.0 - float(hits.sum()) / (max(qids.shape[0], 1) * k)


def compare(kind: str, answers: tuple, vectors: torch.Tensor, k: int, *,
            ivf=None, pvf: int = 20, w: int = 3,
            targets: torch.Tensor | None = None) -> dict:
    """The numbers of one cell's comparison (module docstring) for
    ``answers`` = (qids, ids, sims, bad) tensors. ``kind`` is the cell's
    reference: "exact_binned", "ivfadc_pv" or "join"; ``ivf`` the
    :class:`~freddy_bench.reference.ivfadc.IVFADCReference`, ``targets``
    a join's target row ids."""
    from freddy_bench.reference import knn

    qids, ids, sims, bad = answers
    n = vectors.shape[0]
    operand = torch.bfloat16 if kind == "exact_binned" else None
    if targets is not None:
        member = torch.zeros(n, dtype=torch.bool, device=vectors.device)
        member[targets] = True
        bad = bad | ~torch.all(member[ids.clamp_min(0)] & (ids >= 0), dim=1)
    ok = ~bad
    true = knn.true_sims(vectors, qids, ids, operand)
    out = {"bad_rows": int(bad.sum()),
           "sim_err": _max(torch.abs(sims - true)[ok])}
    if kind == "exact_binned":
        _, ref_s = knn.binned_top_k(vectors, qids[ok], k, operand=operand)
        out["rank_gap"] = _max(_gap(ref_s, true[ok]))
    elif kind == "ivfadc_pv":
        lists = ivf.shortlists(qids[ok], k, pvf, w)
        gaps, outside, skipped = [], 0, 0
        ids_ok, true_ok = ids[ok], true[ok]
        for b, sl in enumerate(lists):
            if sl is None:
                skipped += 1
                continue
            rows, s, strict = sl
            outside += int((~torch.isin(ids_ok[b], rows)).sum())
            st = torch.topk(s[strict], min(k, int(strict.sum()))).values
            st = torch.nn.functional.pad(st, (0, k - st.shape[0]),
                                         value=-float("inf"))
            gaps.append(_gap(st[None], true_ok[b:b + 1]))
        out["rank_gap"] = _max(torch.cat(gaps)) if gaps else 0.0
        out["outside_shortlist"] = outside
        out["tied_cells_skipped"] = skipped
        out["miss_rate"] = _miss_rate(vectors, qids[ok], true_ok, k, None)
    elif kind == "join":
        out["miss_rate"] = _miss_rate(vectors, qids[ok], true[ok], k,
                                      targets)
    else:
        raise ValueError(f"unknown reference {kind!r}")
    out["rows_checked"] = int(ok.sum())
    return out


def limits_of(check: dict) -> dict:
    """The cell's limits: its file's ``limits``, and a join's
    ``miss_rate`` from its stated recall floor."""
    lim = dict(check["limits"])
    if "recall_floor" in check:
        lim["miss_rate"] = round(1.0 - check["recall_floor"], 12)
    return lim


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit → (all within, the pairs)."""
    pairs = {name: {"value": numbers[name], "limit": lim}
             for name, lim in limits.items()}
    return all(p["value"] <= p["limit"] for p in pairs.values()), pairs
