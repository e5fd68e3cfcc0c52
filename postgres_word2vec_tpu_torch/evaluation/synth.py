"""Synthetic embeddings, drawn on the device.

Counterpart of ``postgres_word2vec_tpu/evaluation/synth.py``:
``generate_wordlike`` with the same calibrated V3 parameters (fringe tier
on) and the V2 parameters of the recall-ceiling control, and
``generate_mixture``, round 1's flat cluster mixture with planted
neighbours. Both draw from a ``torch.Generator``, so their numbers differ
from JAX's for the same seed; their geometry does not: the same power-law
spectrum, topic → concept → variant hierarchy, fringe tier and random
rotation, and the same mixture of 1024 centres with planted neighbours.
"""

from __future__ import annotations

import torch

#: round-2 calibration (scan-point parity only), kept for the
#: recall-ceiling control's "before" comparison; ``fringe_frac=0.0`` is
#: explicit, since the V3 defaults turn the fringe tier on.
V2_PARAMS = dict(group=8, beta=0.55, sigma_c=0.7, sigma_v=0.55,
                 fringe_frac=0.0)

#: round-3 calibration (= generate_wordlike defaults), as in the JAX
#: package: fringe-tier geometry whose reference-equivalent control clears
#: both published PQ points.
V3_PARAMS = dict(group=64, beta=0.55, sigma_c=0.7, sigma_v=0.5,
                 fringe_frac=0.875, sigma_f=0.65)


def _orthogonal(generator: torch.Generator, d: int) -> torch.Tensor:
    """Haar-random orthogonal (d, d): QR of a Gaussian with the signs of
    R's diagonal folded into Q."""
    z = torch.randn(d, d, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(z)
    return q * torch.sign(torch.diagonal(r))[None, :]


def generate_mixture(generator: torch.Generator, n: int, d: int = 300,
                     eval_q: int = 256) -> torch.Tensor:
    """Round-1 generator → ``(n, d)`` float32, L2-normed, on
    ``generator.device``: an isotropic mixture of 1024 Gaussian centres
    (noise 0.7), then 16 planted neighbours for each of the first
    ``eval_q`` rows, each its row plus 0.25 noise, renormalized, written
    over distinct rows drawn from ``eval_q..n-1``. Hard for PQ: the
    isotropic within-cluster noise swamps the neighbour gaps."""
    dev = generator.device
    n_plant = 16
    centers = torch.randn(1024, d, generator=generator, device=dev)
    assign = torch.randint(0, 1024, (n,), generator=generator, device=dev)
    v = centers[assign] + 0.7 * torch.randn(n, d, generator=generator,
                                            device=dev)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    plant_ids = torch.randperm(n - eval_q, generator=generator,
                               device=dev)[:eval_q * n_plant] + eval_q
    src = v[:eval_q].repeat_interleave(n_plant, dim=0)
    planted = src + 0.25 * torch.randn(src.shape, generator=generator,
                                       device=dev)
    v[plant_ids] = planted / torch.linalg.vector_norm(planted, dim=-1,
                                                      keepdim=True)
    return v


def generate_wordlike(generator: torch.Generator, n: int, d: int = 300, *,
                      n_topics: int = 1024, group: int = 64,
                      beta: float = 0.55, sigma_c: float = 0.7,
                      sigma_v: float = 0.5, fringe_frac: float = 0.875,
                      sigma_f: float = 0.65,
                      chunk_size: int = 262144) -> torch.Tensor:
    """GoogleNews-like synthetic embeddings → ``(n, d)`` float32, L2-normed,
    on ``generator.device``.

    1. per-dim scales ``s_i ∝ (i+1)^-beta``, normalized to mean-square 1;
    2. ``n_topics`` topic centers ``t = z ⊙ s``;
    3. ``n/group`` concepts ``c = t[topic] + sigma_c·(z ⊙ s)``;
    4. each row picks a random concept: ``v = c + sigma·(z ⊙ s)`` with
       ``sigma = sigma_f`` for a ``fringe_frac`` share of rows (the fringe
       tier) and ``sigma_v`` otherwise;
    5. rows are rotated by a random orthogonal Q and normalized.

    Rows are made in chunks of ``chunk_size`` so the noise tensors never
    exceed chunk_size×d.
    """
    dev = generator.device
    n_concepts = max(n // group, 1)
    s = torch.arange(1, d + 1, dtype=torch.float32, device=dev) ** (-beta)
    s = s / torch.sqrt(torch.mean(s * s))

    topics = torch.randn(n_topics, d, generator=generator, device=dev) * s
    topic_of = torch.randint(0, n_topics, (n_concepts,),
                             generator=generator, device=dev)
    concepts = topics[topic_of] + sigma_c * torch.randn(
        n_concepts, d, generator=generator, device=dev) * s
    concept_of = torch.randint(0, n_concepts, (n,), generator=generator,
                               device=dev)
    q_rot = _orthogonal(generator, d)

    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    for start in range(0, n, chunk_size):
        cof = concept_of[start:start + chunk_size]
        rows = cof.shape[0]
        noise = torch.randn(rows, d, generator=generator, device=dev)
        sig = torch.full((rows, 1), sigma_v, device=dev)
        if fringe_frac > 0.0:
            u = torch.rand(rows, generator=generator, device=dev)
            sig[u < fringe_frac] = sigma_f
        v = concepts[cof] + sig * noise * s
        v = v @ q_rot
        out[start:start + rows] = v / torch.linalg.vector_norm(
            v, dim=-1, keepdim=True)
    return out
