"""word2vec ``.bin`` → text conversion through the native parser.

The port's ``index_creation/transform_vecs.py``; its output is the same
text, byte for byte (each value as ``repr(float(x))``).

    python -m postgres_word2vec_tpu_torch.cli.index_creation.transform_vecs \\
        input.bin output.txt [max_words] [--device cpu]

The conversion is host work, but like every driver it resolves its
device first, so that it fails without a card unless ``--device`` is
given.
"""

from __future__ import annotations

from pathlib import Path

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.utils import native_io
from postgres_word2vec_tpu_torch.utils.device import resolve_device


def main(src: str, dst: str, max_words: int | None = None,
         device: torch.device | str | None = None) -> int:
    """Write ``src``'s first ``max_words`` rows to ``dst`` → the rows
    written."""
    resolve_device(device)
    words, vecs = native_io.load_binary_embeddings(Path(src), max_words)
    with open(dst, "w") as f:
        f.write(f"{len(words)} {vecs.shape[1]}\n")
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    print(f"wrote {len(words)} vectors to {dst}")
    return len(words)


if __name__ == "__main__":
    p = arg_parser(__doc__)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("max_words", nargs="?", type=int, default=None)
    args = p.parse_args()
    main(args.src, args.dst, args.max_words, device=args.device)
