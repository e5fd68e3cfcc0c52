"""Evaluation helpers ported so far: the synthetic data generator, the
measurement helpers the engine's autotune uses (``benchutil``), and the
join's wall-time spread (``join_wall.py``)."""
