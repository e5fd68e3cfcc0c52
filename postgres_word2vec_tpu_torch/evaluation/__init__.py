"""Evaluation helpers ported so far: the synthetic data generator and the
join's wall-time spread (``join_wall.py``)."""
