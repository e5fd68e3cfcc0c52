"""The plain reference the benchmark holds the served answers to.

Plain PyTorch, with TF32 off and every score in float64. It imports
neither JAX nor any part of the program under test; it reads only the
vectors the benchmark itself made from the seed and, where it must follow
the program step by step (``ivfadc.py``), the program's trained tables,
which it checks against the vectors first.

- ``knn.py``: exact similarities, the fused scan's binned top-k and the
  exact top-k over a target set (the exact kNN-join);
- ``ivfadc.py``: the IVFADC + post-verification shortlist and the check
  of the index build it follows;
- ``lowp.py``: the same answers computed in the precision below the
  configuration's, the control that the comparison has to reject.
"""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the enclosed block, the previous settings restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
