"""Where the port's entry points put their tensors.

The port runs on the card: an entry point that builds or loads state
(``VectorStore.from_arrays`` / ``from_text_file`` / ``load``, the
``utils.convert`` builders, the indexes' ``load``, ``Freddy.load``) puts it
on CUDA unless the caller names another device. Without a card it raises
and says how to ask for the CPU; it never carries on there silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card
    (``cuda``), which must be present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run it on the CPU")
    return torch.device("cuda")
