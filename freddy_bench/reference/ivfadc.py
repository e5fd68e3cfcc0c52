"""IVFADC with post-verification, followed step by step from the program's
trained tables.

The coarse centroids, the residual codebook and each row's cell and codes
come out of k-means, which the reference cannot redo to the same tables.
So it reads the program's tables and first checks them against the data
(:func:`build_misses`): every sampled row sits in a nearest coarse cell,
and each of its codes is a nearest centroid of its residual's subspace.
The tables' quality, which this reference takes as given, is held apart
by the recall of the served answers against the exact answer over the
whole store (``miss_rate`` in ``check.py``), which reads no table of the
program. From those tables it works out the rest itself, in float64:

1. the ``w`` coarse cells nearest each query;
2. the residual ADC distance ``Σ_j ‖(q − c)_j − cb_j[code_j]‖²`` of every
   row in them;
3. the ``k·pvf`` rows of least ADC distance, the shortlist;
4. the ``k`` rows of the shortlist with the best exact similarity.

Rounding in the program can swap rows whose ADC distances lie within
``eps`` at the shortlist's edge, so the reference keeps two shortlists:
the rows clearly inside (``< d_cut − eps``) and the rows that may be
inside (``≤ d_cut + eps``). A served row must come from the second; the
served answer must be at least as good as the best k of the first.
A query whose ``w``-th and next cell lie within ``eps_cell`` of each other
probes either one: it is left out, and counted.
"""

from __future__ import annotations

import torch

from freddy_bench.reference import no_tf32
from freddy_bench.reference.knn import sims_f64


def _prec(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, to be summed in float64 (the reference)
    or float32 (a lower precision)."""
    if dtype == torch.float64:
        return x.double()
    return x.to(dtype).float()


def _nearest_ok(d: torch.Tensor, chosen: torch.Tensor,
                eps: float) -> torch.Tensor:
    """True where the chosen column's distance is within ``eps`` of the
    row's least."""
    got = torch.gather(d, -1, chosen.long().unsqueeze(-1)).squeeze(-1)
    return got <= torch.min(d, dim=-1).values + eps


@no_tf32()
def build_misses(vectors: torch.Tensor, rows: torch.Tensor,
                 coarse: torch.Tensor, codebook: torch.Tensor,
                 assign: torch.Tensor, codes: torch.Tensor,
                 eps: float = 1e-5, block: int = 256) -> int:
    """Sampled ``rows`` whose cell is not a nearest coarse centroid, or
    one of whose codes is not a nearest centroid of the residual's
    subspace (``codebook`` (m, k, dsub); ``codes`` (n, m))."""
    c = coarse.double()
    cb = codebook.double()
    m, _, dsub = codebook.shape
    misses = 0
    for r0 in range(0, rows.shape[0], block):
        rb = rows[r0:r0 + block]
        x = vectors[rb].double()
        cd = (torch.sum(x * x, -1, keepdim=True)
              + torch.sum(c * c, -1)[None] - 2.0 * x @ c.t())
        ok = _nearest_ok(cd, assign[rb], eps)
        r = (x - c[assign[rb].long()]).reshape(-1, m, dsub)
        sd = torch.sum((r[:, :, None, :] - cb[None]) ** 2, dim=-1)
        ok &= torch.all(_nearest_ok(sd, codes[rb].long(), eps), dim=-1)
        misses += int((~ok).sum())
    return misses


class IVFADCReference:
    """The IVFADC + PV reference over the program's tables (see the module
    docstring): ``coarse`` (C, d), ``codebook`` (m, k, dsub), ``assign``
    (n,) cell of each row, ``codes`` (n, m) in row order."""

    def __init__(self, vectors, coarse, codebook, assign, codes):
        self.vectors = vectors
        self.coarse = coarse.double()
        self.codebook = codebook.double()
        self.codes = codes.long()
        a = assign.long()
        self.order = torch.sort(a, stable=True).indices
        sizes = torch.bincount(a, minlength=coarse.shape[0])
        self.offsets = torch.zeros(coarse.shape[0] + 1, dtype=torch.int64,
                                   device=a.device)
        self.offsets[1:] = torch.cumsum(sizes, 0)
        self.list_cap = int(sizes.max())

    @no_tf32()
    def shortlists(self, qids: torch.Tensor, k: int, pvf: int, w: int, *,
                   eps: float = 1e-5, eps_cell: float = 1e-5,
                   q_block: int = 16, dtype=torch.float64) -> list:
        """Per query row: None where its cells tie at the ``w``-th, else
        (ids of the loose shortlist (L,), their exact sims (L,) float64,
        mask (L,) of the rows in the strict one). ``dtype`` is the
        precision of the operands: float64 for the reference; the control
        rounds every operand to a lower one and sums in float32."""
        out = []
        m, ks, dsub = self.codebook.shape
        cb = _prec(self.codebook, dtype)
        coarse = _prec(self.coarse, dtype)
        L = self.list_cap
        lane = torch.arange(L, device=qids.device)
        j_off = torch.arange(m, device=qids.device) * ks
        for b0 in range(0, qids.shape[0], q_block):
            qi = qids[b0:b0 + q_block]
            q = _prec(self.vectors[qi], dtype)
            B = q.shape[0]
            cd = (torch.sum(q * q, -1, keepdim=True)
                  + torch.sum(coarse * coarse, -1)[None]
                  - 2.0 * q @ coarse.t())
            cdv, cells = torch.topk(cd, w + 1, dim=1, largest=False)
            tie = (cdv[:, w] - cdv[:, w - 1]) < eps_cell
            cells = cells[:, :w]
            resid = (q[:, None, :] - coarse[cells]).reshape(B, w, m, dsub)
            luts = torch.sum((resid[:, :, :, None, :] - cb[None, None]) ** 2,
                             dim=-1)                         # (B, w, m, ks)
            start = self.offsets[cells]
            pos = start[..., None] + lane                    # (B, w, L)
            valid = pos < self.offsets[cells + 1][..., None]
            rows = self.order[pos.clamp_max(self.order.shape[0] - 1)]
            idx = self.codes[rows] + j_off                   # (B, w, L, m)
            flat = luts.reshape(B, w, 1, m * ks).expand(B, w, L, m * ks)
            adc = torch.gather(flat, 3, idx).sum(-1)
            adc = torch.where(valid, adc, torch.full_like(adc, float("inf")))
            adc = adc.reshape(B, -1).double()
            rows = rows.reshape(B, -1)
            cut = torch.kthvalue(adc, min(k * pvf, adc.shape[1]),
                                 dim=1).values
            for b in range(B):
                if bool(tie[b]):
                    out.append(None)
                    continue
                loose = adc[b] <= cut[b] + eps
                ids = rows[b][loose]
                strict = adc[b][loose] < cut[b] - eps
                s = sims_f64(_prec(self.vectors[qi[b:b + 1]], dtype),
                             _prec(self.vectors[ids], dtype))[0]
                out.append((ids, s, strict))
        return out
