"""The card's published peaks, and the least time a piece of work needs.

A frozen copy of the HBM and peak-operation terms of
``postgres_word2vec_tpu_torch/evaluation/bounds.py`` at commit abbb0ce
(NVIDIA's data sheet for the H100 SXM, dense rates at 700 W); its
shared-memory term, which rests on a clock read from the card and not on
a published peak, is left out.

Each ``<operation>.py`` beside this file has ``work(ctx)`` → (bytes,
operations, kind): what the operation needs for the window's inputs, each
input byte read once and each output byte written once, whatever the
kernels that run it read again. It names the operation, not a kernel, so
a kernel replaced or fused later is read against the same work.
"""

#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: operations per second by kind: bf16 tensor cores, float32 CUDA cores
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}


def least_seconds(nbytes: float, ops: float, kind: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their kind."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])
