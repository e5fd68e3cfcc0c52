"""The control: the reference's answers in the precision below the one the
configuration states, put in the program's place.

- ``int8`` (below the fused scan's bfloat16): rows and queries quantized
  symmetrically, one scale a row, exact integer products, exact norms;
- ``bfloat16`` (below float32, TF32 off): every operand rounded to
  bfloat16, sums in float32.

Each function answers like the served path: (ids (B, k) int64, sims
(B, k)), best first, the similarities as this precision computes them.
"""

from __future__ import annotations

import torch

from freddy_bench.reference import no_tf32


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 values (held in float64) and scales."""
    x = x.double()
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-30) / 127
    return torch.clamp(torch.round(x / scale), -127, 127), scale


def _merge(best_s, best_i, s, i, k):
    cs = torch.cat([best_s, s], dim=1)
    ci = torch.cat([best_i, i], dim=1)
    top, pos = torch.topk(cs, k, dim=1)
    return top, torch.gather(ci, 1, pos)


@no_tf32()
def top_k(vectors: torch.Tensor, qids: torch.Tensor, k: int, dtype: str, *,
          targets: torch.Tensor | None = None, q_block: int = 256,
          chunk: int = 262144) -> tuple[torch.Tensor, torch.Tensor]:
    """The best ``k`` rows of each query row among ``targets`` (all rows
    when None), scored in ``dtype`` ("int8" or "bfloat16")."""
    dev = vectors.device
    if targets is None:
        targets = torch.arange(vectors.shape[0], device=dev)
    B = qids.shape[0]
    best_s = torch.full((B, k), -float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    q_all = vectors[qids]
    qq = torch.sum(q_all.double() ** 2, -1, keepdim=True)
    if dtype == "int8":
        qv, qs = _quantize(q_all)
    else:
        qv = q_all.to(torch.bfloat16).float()
    for t0 in range(0, targets.shape[0], chunk):
        tid = targets[t0:t0 + chunk]
        v = vectors[tid]
        vv = torch.sum(v.double() ** 2, -1)
        if dtype == "int8":
            tv, ts = _quantize(v)
        else:
            tv = v.to(torch.bfloat16).float()
        for b0 in range(0, B, q_block):
            sl = slice(b0, b0 + q_block)
            if dtype == "int8":
                dot = (qv[sl] @ tv.t()) * qs[sl] * ts.t()
            else:
                dot = (qv[sl] @ tv.t()).double()
            s = 1.0 - torch.clamp_min(qq[sl] + vv[None] - 2.0 * dot,
                                      0.0) / 2.0
            top, pos = torch.topk(s, min(k, s.shape[1]), dim=1)
            best_s[sl], best_i[sl] = _merge(best_s[sl], best_i[sl], top,
                                            tid[pos], k)
    return best_i, best_s


def ivfadc_pv(ref, qids: torch.Tensor, k: int, pvf: int, w: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVFADC + PV from :class:`~freddy_bench.reference.ivfadc.
    IVFADCReference` with every operand in bfloat16: the best ``k`` of
    each shortlist by its bfloat16 similarities."""
    ids = torch.full((qids.shape[0], k), -1, dtype=torch.int64,
                     device=qids.device)
    sims = torch.full((qids.shape[0], k), float("nan"), dtype=torch.float64,
                      device=qids.device)
    for b, sl in enumerate(ref.shortlists(qids, k, pvf, w, eps=0.0,
                                          eps_cell=0.0,
                                          dtype=torch.bfloat16)):
        if sl is None:
            continue
        rows, s, _ = sl
        top, pos = torch.topk(s, min(k, s.shape[0]))
        ids[b, :top.shape[0]] = rows[pos]
        sims[b, :top.shape[0]] = top
    return ids, sims
