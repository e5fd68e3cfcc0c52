"""The IVPQ kNN-join (method 2, PQ + post-verification), followed round by
round from the program's trained tables, in both of its code forms.

The coarse centroids of the multi-index, the PQ codebook, each row's codes
and each row's cell come out of k-means, which the reference cannot redo
to the same tables, so it reads the program's (as ``ivfadc.py`` does).
From those and the target set it works out the rest itself, in float64
with TF32 off, one query at a time in blocks:

1. the distance of the query to every cell of the multi-index: per
   position ``‖q_i − c_i‖²`` over that position's part of the vector, the
   cell's distance their sum, cell id ``Σ c_i·k_cⁱ``;
2. the cells in order of distance, accumulated until
   ``getConfidenceHyp(k·α, |T|, Σp, N) ≥ confidence`` (the normal
   approximation of the hypergeometric tail, its spread times the
   finite-population correction ``(N − |T|)/(N − 1)``; ``p`` each cell's
   share of the statistics' domain, ``N`` the domain's size), then on
   until the cells hold at least min(k, |T|) targets;
3. while a query has fewer than k targets in its cells and cells are
   left, α doubles (at most ``max_rounds`` rounds);
4. the ADC distance of every target row in the selected cells: with long
   codes ``Σ_j L[j, c_j]`` over the m one-byte codes, where
   ``L[j, i] = ‖q_j − cb_j[i]‖²``; with short codes (α·k above
   ``long_codes_threshold``) ``Σ_p D[p, c_2p·ks + c_2p+1]`` over the m/2
   fused pairs, where ``D[p, a·ks + b] = L[2p, a] + L[2p+1, b]``;
5. the k·pvf rows of least ADC distance, the shortlist, and the k rows of
   the shortlist with the best exact similarity.

Departures from ivpq_search_in.c, all as the program has them: cells are
sorted by distance (upstream walks them in the same order with a
Multi-Sequence queue, index_utils.c:322-395); step 2's coverage floor is
the program's, which upstream lacks (there a query short of k targets is
left to α doubling); the target rows of the selected cells are scanned as
a set (upstream fetches them with one SPI query, in no fixed order), so
ties in ADC distance at the shortlist's edge are left open below.

Rounding in the program can swap rows whose ADC distances lie within
``eps`` at the shortlist's edge, so a query gets two shortlists: the rows
clearly inside (``< cut − eps``) and the rows that may be inside
(``≤ cut + eps``). A served row must come from the second; the served
answer must be as good as the best k of the first. A query whose cell
selection could fall otherwise under float32 rounding (two cells that
matter within ``eps_cell`` of each other at the selection's end, or the
confidence within ``eps_conf`` of its threshold there) is left out, and
counted.
"""

from __future__ import annotations

import math

import torch

from freddy_bench.reference import no_tf32
from freddy_bench.reference.knn import sims_f64


def cell_distances(queries: torch.Tensor, coarse: torch.Tensor
                   ) -> torch.Tensor:
    """``(B, d)`` float64 queries, ``(positions, k_c, d/positions)``
    centroids → ``(B, k_c**positions)`` squared distances, cell id
    ``Σ c_i·k_cⁱ``."""
    p, kc, dsub = coarse.shape
    B = queries.shape[0]
    parts = queries.reshape(B, p, dsub)
    sub = torch.sum((parts[:, :, None, :] - coarse[None]) ** 2, dim=-1)
    total = sub[:, 0]
    for i in range(1, p):
        total = (sub[:, i, :, None] + total[:, None, :]).reshape(
            B, kc ** (i + 1))
    return total


def confidence_hyp(expect: float, size: float, p: torch.Tensor,
                   stat_size: float) -> torch.Tensor:
    """``getConfidenceHyp`` (index_utils.c:673-682) in float64: the chance
    that cells holding a share ``p`` of the domain hold ``expect`` of the
    ``size`` targets or more."""
    mu = size * p
    fpc = (stat_size - size) / max(stat_size - 1.0, 1.0)
    sig = torch.sqrt(torch.clamp_min(size * p * (1.0 - p), 0.0)) * fpc
    num = expect - 0.5 - mu
    z = num / torch.clamp_min(sig, 1e-300) / math.sqrt(2.0)
    conf = 1.0 - 0.5 * (1.0 + torch.special.erf(z))
    conf = torch.where(sig <= 0.0, (num <= 0.0).double(), conf)
    if expect > size:
        conf = torch.zeros_like(conf)
    return conf


class IVPQJoinReference:
    """The IVPQ join of method 2 over the program's tables (module
    docstring): ``vectors`` (n, d) the store's rows, ``coarse``
    (positions, k_c, d/positions), ``codebook`` (m, ks, d/m), ``codes``
    (n, m), ``cell_of`` (n,), ``targets`` (T,) row ids; ``domain`` the
    rows the statistics count (the targets when None)."""

    def __init__(self, vectors, coarse, codebook, codes, cell_of, targets,
                 domain=None):
        self.vectors = vectors
        self.coarse = coarse.double()
        self.codebook = codebook.double()
        p, kc, _ = coarse.shape
        self.num_cells = kc ** p
        self.targets = targets.long()
        cells = cell_of[self.targets].long()
        self.t_cells = cells
        self.t_codes = codes[self.targets].long()
        self.counts = torch.bincount(cells, minlength=self.num_cells
                                     ).double()
        dom = self.targets if domain is None else domain.long()
        dc = torch.bincount(cell_of[dom].long(), minlength=self.num_cells
                            ).double()
        self.stat_size = max(float(dc.sum()), 1.0)
        self.stat_p = dc / self.stat_size
        # cells that change nothing when they move: no targets, no share
        self.null_cell = (self.counts == 0) & (self.stat_p == 0)

    def _select(self, cd: torch.Tensor, k: int, alpha: int,
                confidence: float, eps_cell: float, eps_conf: float):
        """Step 2 for a block of cell distances ``cd`` (B, C) → (selected
        cells (B, C) bool, exhausted (B,), ambiguous (B,))."""
        B, C = cd.shape
        T = float(self.targets.shape[0])
        order = torch.argsort(cd, dim=1, stable=True)
        dist = torch.gather(cd, 1, order)
        cum_p = torch.cumsum(self.stat_p[order], dim=1)
        conf = confidence_hyp(float(k * alpha), T, cum_p, self.stat_size)
        sat = conf >= confidence
        first = torch.argmax(sat.to(torch.uint8), dim=1) + 1
        n_sel = torch.where(sat.any(1), first, C)
        cum_n = torch.cumsum(self.counts[order], dim=1)
        cov = cum_n >= min(T, float(k))
        k_first = torch.argmax(cov.to(torch.uint8), dim=1) + 1
        n_sel = torch.maximum(n_sel, torch.where(cov.any(1), k_first, C))
        ranks = torch.arange(C, device=cd.device)
        sel_sorted = ranks[None] < n_sel[:, None]
        selected = torch.zeros_like(sel_sorted).scatter_(1, order,
                                                         sel_sorted)
        # Only a swap of the ranks (n_sel − 2, n_sel − 1) or (n_sel − 1,
        # n_sel) can change the selected rows: the prefixes before them do
        # not reach the threshold, with either cell in them.
        ambiguous = torch.zeros(B, dtype=torch.bool, device=cd.device)
        null = self.null_cell[order]
        for r_off in (2, 1):
            r = n_sel - r_off
            ok = (r >= 0) & (r + 1 < C)
            rc = r.clamp(0, C - 2)
            near = (torch.gather(dist, 1, (rc + 1)[:, None])
                    - torch.gather(dist, 1, rc[:, None]))[:, 0] <= eps_cell
            moves = ~(torch.gather(null, 1, rc[:, None])[:, 0]
                      | torch.gather(null, 1, (rc + 1)[:, None])[:, 0])
            ambiguous |= ok & near & moves
        # the threshold itself, at the selection's end and before it
        for r_off in (1, 2):
            j = (n_sel - r_off).clamp(0, C - 1)
            cj = torch.gather(conf, 1, j[:, None])[:, 0]
            mu = T * torch.gather(cum_p, 1, j[:, None])[:, 0]
            num = k * alpha - 0.5 - mu
            close = (cj - confidence).abs() <= eps_conf
            # degenerate spread: a step at mu, set by the float32 share
            # times |T| in the program (|T|·4e-6 covers its rounding)
            close |= (num.abs() <= 4e-6 * T) & ((cj == 0) | (cj == 1))
            ambiguous |= close & (n_sel - r_off >= 0)
        return selected, n_sel >= C, ambiguous

    def _adc(self, q: torch.Tensor, rows: torch.Tensor, short: bool
             ) -> torch.Tensor:
        """Step 4 for one query ``q`` (d,) over target positions ``rows``."""
        m, ks, dsub = self.codebook.shape
        lut = torch.sum((q.reshape(m, 1, dsub) - self.codebook) ** 2, -1)
        codes = self.t_codes[rows]
        if short:
            pair = (lut[0::2, :, None] + lut[1::2, None, :]).reshape(
                m // 2, ks * ks)
            fused = codes[:, 0::2] * ks + codes[:, 1::2]
            off = torch.arange(m // 2, device=q.device) * ks * ks
            return pair.reshape(-1)[fused + off].sum(-1)
        off = torch.arange(m, device=q.device) * ks
        return lut.reshape(-1)[codes + off].sum(-1)

    @no_tf32()
    def shortlists(self, qids: torch.Tensor, k: int, *, alpha: int,
                   pvf: int, confidence: float,
                   long_codes_threshold: float, max_rounds: int = 8,
                   eps: float = 1e-5, eps_cell: float = 1e-5,
                   eps_conf: float = 1e-5, q_block: int = 64) -> list:
        """Per query row: None where its cell selection is ambiguous, else a
        dict: ``ids`` the loose shortlist's row ids (L,), ``sims`` their
        exact similarities (L,) float64, ``strict`` mask (L,) of the rows
        in the strict one, ``short`` whether the query's last round took
        short codes, ``alpha`` its last round's α, ``candidates`` the
        target rows in its cells."""
        out = []
        for b0 in range(0, qids.shape[0], q_block):
            qi = qids[b0:b0 + q_block]
            q = self.vectors[qi].double()
            cd = cell_distances(q, self.coarse)
            done = torch.zeros(q.shape[0], dtype=torch.bool,
                               device=q.device)
            final = [None] * q.shape[0]
            a = int(alpha)
            for rnd in range(max_rounds):
                sel, exhausted, amb = self._select(
                    cd, k, a, confidence, eps_cell, eps_conf)
                cand = sel[:, self.t_cells]                  # (B, T)
                n_cand = cand.sum(1)
                stop = (n_cand >= k) | exhausted | (rnd == max_rounds - 1)
                for b in torch.nonzero(stop & ~done).flatten().tolist():
                    final[b] = (a, bool(amb[b]), cand[b])
                done |= stop
                if bool(done.all()):
                    break
                a += a
            for b, (a_b, amb_b, cand_b) in enumerate(final):
                if amb_b:
                    out.append(None)
                    continue
                out.append(self._shortlist(q[b], cand_b, k, a_b, pvf,
                                           long_codes_threshold, eps))
        return out

    def _shortlist(self, q, cand, k, alpha, pvf, threshold, eps) -> dict:
        short = alpha * k > threshold
        rows = torch.nonzero(cand).flatten()
        adc = self._adc(q, rows, short)
        kk = min(k * pvf, rows.shape[0])
        if kk < rows.shape[0]:
            cut = torch.kthvalue(adc, kk).values
            loose = adc <= cut + eps
            strict = adc[loose] < cut - eps
        else:
            loose = torch.ones_like(adc, dtype=torch.bool)
            strict = loose.clone()
        ids = self.targets[rows[loose]]
        sims = sims_f64(q[None], self.vectors[ids].double())[0]
        return {"ids": ids, "sims": sims, "strict": strict, "short": short,
                "alpha": alpha, "candidates": int(rows.shape[0])}


def hold(lists: list, ids: torch.Tensor, true_sims: torch.Tensor, k: int
         ) -> dict:
    """The served answers (``ids`` (B, k), their float64 similarities
    ``true_sims`` (B, k)) against :meth:`IVPQJoinReference.shortlists`:
    ``outside`` served rows in no loose shortlist, ``gap`` the widest
    shortfall of the served j-th best below the strict shortlist's j-th
    best, ``skipped`` queries left out, ``checked`` those held."""
    outside, gap, skipped = 0, 0.0, 0
    for b, sl in enumerate(lists):
        if sl is None:
            skipped += 1
            continue
        outside += int((~torch.isin(ids[b], sl["ids"])).sum())
        st = sl["sims"][sl["strict"]]
        ref = torch.topk(st, min(k, st.shape[0])).values
        got = torch.sort(true_sims[b], descending=True).values[:ref.shape[0]]
        if ref.numel():
            gap = max(gap, float(torch.clamp_min(ref - got, 0.0).max()))
    return {"outside": outside, "gap": gap, "skipped": skipped,
            "checked": len(lists) - skipped}
