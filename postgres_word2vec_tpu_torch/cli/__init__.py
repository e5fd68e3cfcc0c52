"""The port's command-line drivers: the repository's ``index_creation/``,
``evaluation/`` and ``examples/`` scripts on the port's engine.

Each driver is a module of a subpackage named after the script's
directory, run with ``python -m``:

    python -m postgres_word2vec_tpu_torch.cli.index_creation.pq_index \\
        index_creation/config/pq_config.json

It reads the same JSON configs, takes the same positional arguments and
prints the same JSON or log lines under the same keys as its script. It
runs on the card unless ``--device`` names another device (``--device
cpu`` for the CPU); without a card and without ``--device`` it raises.
Each exposes ``main(..., device=None)`` for in-process callers.
"""
