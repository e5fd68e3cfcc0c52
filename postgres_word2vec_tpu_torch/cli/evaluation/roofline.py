"""Roofline probe: the card's measured ceilings, then the achieved rate of
each hot scan at 3M × 300 against them.

The port's ``evaluation/roofline.py``. Ceilings: the HBM read rate (the
better of a float32-accumulated sum over a bf16 array and a B = 8 bf16
matmul over a bf16 table, each read once), the bf16 tensor-core rate of a
``torch.matmul`` and the int8 rate of a ``torch._int_mm`` of two square
matrices (library calls are the right tool for a ceiling). On the card the
keys ``mxu_bf16_tflops`` and ``mxu_int8_tops``, the JAX record's names for
the TPU's matrix unit, read the tensor cores.

Scans, each the median of 5 warm calls:

- ``exact_bf16_scan``: ``ExactIndex(V, "bfloat16").search`` of B = 1024
  queries (one pass over the bf16 table);
- ``exact_int8_scan``: ``ExactIndex(V, "int8").search`` of the same;
- ``pq_adc_scan``: ``PQIndex.search`` of B = 64 queries over 12×256 codes
  (K2, its LUTs and top-k included).

Each gets ``roofline`` (its binding side) and ``pct_of_bound``. For the
exact scans they come from the measured ceilings, as in the JAX script.
``pq_adc_scan``'s ``flops`` keeps the JAX record's count, the TPU's one-hot
formulation (k multiply-adds a code read), which K2 does not run: its
``bytes``, ``roofline`` and ``pct_of_bound`` come from the card's bound
model (``evaluation/bounds.py``: HBM bytes, shared-memory LUT lookups,
peak float32 adds, published peaks), and ``pct_of_measured_hbm`` reads
its bytes against the measured HBM ceiling.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.roofline \\
        [--small] [--n 3072000] [--device cpu]

Prints one JSON document, with the device it ran on (``device``).
"""

from __future__ import annotations

import json

import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import parse
from postgres_word2vec_tpu_torch.evaluation import bounds, synth
from postgres_word2vec_tpu_torch.evaluation.benchutil import log, timeit
from postgres_word2vec_tpu_torch.models.exact import ExactIndex
from postgres_word2vec_tpu_torch.models.pq import PQIndex


def measure_ceilings(device: torch.device, stream_mib: int = 512,
                     table_mib: int = 2048, mm: int = 16384) -> dict:
    """The measured ceilings: ``hbm_read_gbps`` (the best of
    ``hbm_probe_gbps``: a sum over a ``stream_mib`` bf16 array, a B = 8
    matmul over a ``table_mib`` bf16 table of width 256),
    ``mxu_bf16_tflops`` and ``mxu_int8_tops`` (``mm``² matrices; the
    best of ``mxu_int8_probe_tops``, the right operand row-major and
    column-major)."""
    out = {}
    n = stream_mib * 2**20 // 2
    x = torch.ones(n, dtype=torch.bfloat16, device=device)
    t, _ = timeit(lambda a: torch.sum(a, dtype=torch.float32), x)
    rates = [n * 2 / t / 1e9]
    del x
    d = 256
    rows = table_mib * 2**20 // (d * 2)
    tab = torch.ones(rows, d, dtype=torch.bfloat16, device=device)
    q8 = torch.ones(8, d, dtype=torch.bfloat16, device=device)
    t, _ = timeit(lambda q, v: torch.amin(q @ v.t(), dim=-1), q8, tab)
    rates.append(rows * d * 2 / t / 1e9)
    del tab
    out["hbm_read_gbps"] = max(rates)
    out["hbm_probe_gbps"] = rates

    a = torch.ones(mm, mm, dtype=torch.bfloat16, device=device)
    t, _ = timeit(torch.matmul, a, a)
    out["mxu_bf16_tflops"] = 2 * mm**3 / t / 1e12
    del a
    # the int8 product with its right operand row-major and column-major
    # (cuBLASLt's int8 kernels want the latter): the better is the ceiling
    ai = torch.ones(mm, mm, dtype=torch.int8, device=device)
    out["mxu_int8_probe_tops"] = [
        2 * mm**3 / timeit(torch._int_mm, ai, b)[0] / 1e12
        for b in (ai, ai.t())]
    out["mxu_int8_tops"] = max(out["mxu_int8_probe_tops"])
    return out


def measure_kernels(n: int, d: int, device: torch.device) -> dict:
    """Each scan's wall time, bytes and operations at ``n`` × ``d``."""
    V = synth.generate_wordlike(torch.Generator(device).manual_seed(0), n, d)
    out = {}

    B = 1024
    ex = ExactIndex(V, "bfloat16")
    t, _ = timeit(lambda q: ex.search(q, 10, approx=True), V[:B])
    out["exact_bf16_scan"] = {
        "wall_s": t, "bytes": n * d * 2,
        "flops": 2 * B * n * d,
        "gbps": n * d * 2 / t / 1e9,
        "tflops": 2 * B * n * d / t / 1e12,
        "note": f"B={B} batched scan; one HBM pass over the bf16 table"}
    del ex

    ex8 = ExactIndex(V, "int8")
    t, _ = timeit(lambda q: ex8.search(q, 10, approx=True), V[:B])
    out["exact_int8_scan"] = {
        "wall_s": t, "bytes": n * d,
        "flops": 2 * B * n * d,
        "gbps": n * d / t / 1e9,
        "tops": 2 * B * n * d / t / 1e12,
        "note": "int8 table + int8 tensor-core matmul (torch._int_mm)"}
    del ex8

    Bq, m, k = 64, 12, 256
    pq = PQIndex.build(torch.Generator(device).manual_seed(1), V, m=m, k=k,
                       train_size=100_000, iters=10)
    ct = pq.transposed_codes()
    rows = int(ct.shape[1])
    t, _ = timeit(lambda q: pq.search(q, 10), V[:Bq])
    # K2's work: the codes and LUTs read once, the (B, N) distances
    # written once; B·N·m float32 adds, each a 4-byte LUT lookup
    nbytes = rows * m * ct.element_size() + Bq * m * k * 4 + Bq * rows * 4
    ops = Bq * rows * m
    out["pq_adc_scan"] = {
        "wall_s": t, "bytes": nbytes,
        "flops": 2 * Bq * rows * k * m,
        "gbps": nbytes / t / 1e9,
        "tflops": 2 * Bq * rows * k * m / t / 1e12,
        "adds": ops, "lookup_bytes": 4 * ops,
        "note": f"B={Bq} ADC scan (K2 on the card) with its LUTs and "
                f"top-k; flops count the TPU's one-hot formulation (k per "
                f"code read), which K2 does not run"}
    return out


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--small", action="store_true",
                    help="307,200 rows instead of 3,072,000")
    ap.add_argument("--n", type=int, default=None,
                    help="rows of the scans (overrides --small)")
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--stream-mib", type=int, default=512)
    ap.add_argument("--table-mib", type=int, default=2048)
    ap.add_argument("--mm", type=int, default=16384)
    return ap


def _measured_share(v: dict, ceil: dict) -> None:
    """``roofline`` and ``pct_of_bound`` of an exact scan against the
    measured ceilings."""
    if "tops" in v:
        comp = v["tops"] / ceil["mxu_int8_tops"]
    else:
        comp = v["tflops"] / ceil["mxu_bf16_tflops"]
    mem = v["gbps"] / ceil["hbm_read_gbps"]
    v["roofline"] = "compute" if comp > mem else "memory"
    v["pct_of_bound"] = round(100 * max(comp, mem), 1)


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    n = args.n or (307_200 if args.small else 3_072_000)
    d = args.d
    log(f"roofline: n={n} d={d} device={dev}")
    ceil = measure_ceilings(dev, args.stream_mib, args.table_mib, args.mm)
    kern = measure_kernels(n, d, dev)
    for name in ("exact_bf16_scan", "exact_int8_scan"):
        _measured_share(kern[name], ceil)
    pq = kern["pq_adc_scan"]
    rate = (bounds.smem_bytes_per_s() if dev.type == "cuda"
            else float("inf"))
    ms, _, term = bounds.bound(pq["bytes"], pq["adds"], "fp32",
                               shared=pq["lookup_bytes"], shared_rate=rate)
    pq["bound_ms"], pq["bound_term"] = ms, term
    pq["roofline"] = "compute" if term == "operations" else "memory"
    pq["pct_of_bound"] = round(100 * ms / 1e3 / pq["wall_s"], 1)
    pq["pct_of_measured_hbm"] = round(100 * pq["gbps"]
                                      / ceil["hbm_read_gbps"], 1)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    doc = {"n": n, "d": d, "device": name, "ceilings": ceil,
           "kernels": kern}
    print(json.dumps(doc, indent=2))
    return doc


if __name__ == "__main__":
    main()
