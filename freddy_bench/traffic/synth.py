"""The benchmark's data generator: GoogleNews-like word vectors from a seed.

A frozen copy of ``generate_wordlike`` (V3 parameters, fringe tier on) of
``postgres_word2vec_tpu_torch/evaluation/synth.py`` at commit abbb0ce, so
that a change to the program cannot move the data the benchmark serves.

1. per-dim scales ``s_i ∝ (i+1)^-beta``, normalized to mean-square 1;
2. ``n_topics`` topic centers ``t = z ⊙ s``;
3. ``n/group`` concepts ``c = t[topic] + sigma_c·(z ⊙ s)``;
4. each row picks a random concept: ``v = c + sigma·(z ⊙ s)`` with
   ``sigma = sigma_f`` for a ``fringe_frac`` share of rows (the fringe
   tier) and ``sigma_v`` otherwise;
5. rows are rotated by a random orthogonal Q and normalized.

Every draw comes from one ``torch.Generator`` on the device, in a few
large calls, so the same seed gives the same rows on the same device.
"""

from __future__ import annotations

import torch

#: the V3 calibration (= the defaults below)
V3_PARAMS = dict(group=64, beta=0.55, sigma_c=0.7, sigma_v=0.5,
                 fringe_frac=0.875, sigma_f=0.65)


def _orthogonal(generator: torch.Generator, d: int) -> torch.Tensor:
    """Haar-random orthogonal (d, d): QR of a Gaussian with the signs of
    R's diagonal folded into Q."""
    z = torch.randn(d, d, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(z)
    return q * torch.sign(torch.diagonal(r))[None, :]


def generate_wordlike(generator: torch.Generator, n: int, d: int = 300, *,
                      n_topics: int = 1024, group: int = 64,
                      beta: float = 0.55, sigma_c: float = 0.7,
                      sigma_v: float = 0.5, fringe_frac: float = 0.875,
                      sigma_f: float = 0.65,
                      chunk_size: int = 262144) -> torch.Tensor:
    """``(n, d)`` float32, L2-normed rows on ``generator.device``, made in
    chunks of ``chunk_size`` rows so the noise never exceeds chunk × d."""
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
