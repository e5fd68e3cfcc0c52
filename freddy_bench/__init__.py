"""freddy_bench — the benchmark of the PyTorch and CUDA port,
``postgres_word2vec_tpu_torch``, on one H100.

Command (from the root of a checkout; ``BENCHMARK.json`` names the cells)::

    python -m freddy_bench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Each run is a new process. It draws the data on the card from the seed,
builds the configuration's indexes, serves them with the port's
``AsyncQueryServer`` in-process, drives it from client processes over
HTTP for ``--seconds``, and prints one JSON line. The end-to-end metrics
are taken on the client's side; with ``--trace 1`` the per-layer metrics
come from the program's counters and spans and from a ``torch.profiler``
trace of the card. The served answers are held to the plain reference in
``reference/`` (``check.py`` decides ``correct``).

Adding to it is adding files; no file here is edited:

- a configuration: ``configs/<config>.json`` and an entry under
  ``configs`` in ``BENCHMARK.json``;
- a cell (a traffic mix on a configuration): ``workloads/<cell>.json``
  (configuration, endpoint, clients, words a request, the request body,
  the ``/config`` settings, target sets, warm-up, sample share, roofline
  operation, the comparison's reference and limits, ``why``) and an entry
  under ``workloads``;
- a metric: ``metrics/<metric>.py`` with ``read(ctx)`` returning a number,
  or None where the run has nothing for it, and an entry under
  ``end_to_end`` or ``per_layer``;
- a roofline operation: ``roofline/<operation>.py`` with ``work(ctx)``
  returning the bytes and operations it needs and their kind.

Frozen copies, taken at commit abbb0ce so that a change to the program
cannot move the yardstick: ``traffic/fleet.py`` (the closed-loop clients
of ``postgres_word2vec_tpu_torch/evaluation/serving_bench.py``, adapted),
``traffic/synth.py`` (``evaluation/synth.generate_wordlike``, V3) and the
peaks of ``roofline/__init__.py`` (the HBM and peak-operation terms of
``evaluation/bounds.py``).

Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either. The tests in ``tests/`` run on the CPU:
``python -m pytest freddy_bench/tests -q``.
"""
