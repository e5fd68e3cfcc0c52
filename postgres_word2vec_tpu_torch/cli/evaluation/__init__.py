"""The evaluation drivers (``evaluation/*.py``): query-family timings, the
kNN-join time / precision figure, the TRACK stage breakdown, the
confidence and target-count validations, short vs long codes and the
dataset's geometry."""
