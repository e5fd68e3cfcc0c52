"""Find the benchmark's parts by name.

Everything that belongs to one configuration, one cell or one metric sits
in a file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (sizes, index parameters, the
  front end's settings, guarantees, ``reduced`` and ``assumed``);
- ``workloads/<cell>.json``: the traffic mix (configuration, endpoint,
  clients, request size, the settings sent through ``/config``, the
  comparison's limits and ``why``);
- ``metrics/<metric>.py``: the reader of one metric, ``read(ctx)`` → a
  number, or None where the run has nothing for it to read;
- ``roofline/<operation>.py``: the work of one operation,
  ``work(ctx)`` → (bytes, operations, kind of operation).

So a later change adds a configuration, a cell or a metric as new files
and entries, and edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

#: this package's directory
ROOT = Path(__file__).resolve().parent
#: a name, as BENCHMARK.json's contract allows it
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(path: str | Path = "BENCHMARK.json") -> dict:
    """The manifest at the root of the checkout."""
    return json.loads(Path(path).read_text())


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under this package (``configs`` or
    ``workloads``)."""
    return json.loads((ROOT / kind / f"{_check_name(name)}.json")
                      .read_text())


def _load_module(kind: str, name: str):
    path = ROOT / kind / f"{_check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"freddy_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` of metric ``name``."""
    return _load_module("metrics", name).read


def work_function(operation: str):
    """The ``work(ctx)`` of roofline operation ``operation``."""
    return _load_module("roofline", operation).work


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (those without a ``workloads`` list, or with one that names it), or
    with ``trace`` its per-layer metrics (those whose ``workloads`` name
    it, or, without the key, those whose ``moves`` the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def workload_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
