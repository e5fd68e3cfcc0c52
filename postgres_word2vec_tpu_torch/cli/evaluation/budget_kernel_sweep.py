"""Budget-kernel microbench: per-query (K6) against tile-grouped (K7, K8)
over a sweep of the queries a group holds.

The port's ``evaluation/budget_kernel_sweep.py``. It measures the
selectivity-proportional probe primitive on the IVPQ join's shapes: B
queries × P tile slots over a few hundred cell-aligned tiles of
``block_t`` rows, fine codebook m 30 × k 32, tiles drawn with a zipf
popularity (cell sizes are zipfy). The inputs are the JAX script's numpy
draws from ``default_rng(0)`` in the same order, so ``mean_run`` (pairs per
distinct tile) equals its record's.

- ``per_query``: ``kernels.budget_adc`` (K6), one query's slots per block;
- ``grouped_r{rows}``: ``kernels.budget_adc_grouped`` (K7), the (query,
  slot) pairs grouped by tile on the card (``kernels.budget_pair_layout``,
  two launches) and ``rows`` of them sharing one code tile a block, at rows
  8, 16, 32 and 64;
- ``grouped_i8_r{rows}``: the same with int8 LUTs (K8), rows 16 and 32.

Keys, as in the JAX record: ``*_s`` per-call seconds
(``benchutil.timeit_piped``: CUDA events over calls queued back to back);
``*_match``, K7 held to K6 with the JAX script's rule (rtol and atol 1e-5
on the finite entries, the same +inf pattern; K7 equals its plain version
bit for bit, K6 its own within 1e-5) and K8 to the JAX script's int8
bound, ``m · max(lut) · (1/254 + 1/512) · 1.01 + 1e-3`` a query: the int8
quantization plus the bf16 rounding of the TPU's reference LUTs, kept
though K6's LUTs here are float32; ``*_programs``: on the card the CUDA
blocks the kernel's launch runs (its grid, from a ``torch.profiler`` trace
of one call: K6 a block per query and group of slots, K7 a block per
group, ⌈B·P/rows⌉ + the table's tiles; the pair layout's launches are not
counted), on the CPU, where nothing launches, the JAX record's program
counts (B·P and the same group count).

Logged beside them (stderr): K7's pair layout timed on its own, each
kernel's bound from ``evaluation/bounds.py`` (HBM bytes, shared-memory
LUT lookups, float32 adds) and which layout the dispatch rule
(``kernels._grouped_wins`` at ``GROUPED_ROWS_DEFAULT``) picks at this
shape beside the fastest.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.budget_kernel_sweep \\
        [--b 1024] [--p 16] [--block-t 256] [--n-tiles 400] [--m 30] \\
        [--k 32] [--zipf 1.1] [--out reports/budget_kernel_sweep_torch.json] \\
        [--device cpu]

Writes the record to ``--out`` and prints ``{"best", "per_query_ms"}``.
``--device`` takes the place of the JAX script's ``--interpret``: on the
CPU the plain versions run.
"""

from __future__ import annotations

import json
import math
import os
import re
import tempfile
import time
import warnings

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import (
    REPORTS, parse, write_json)
from postgres_word2vec_tpu_torch.evaluation import bounds
from postgres_word2vec_tpu_torch.evaluation.benchutil import (
    log, materialize, timeit_piped)
from postgres_word2vec_tpu_torch.ops import kernels

GROUPED_ROWS = (8, 16, 32, 64)
INT8_ROWS = (16, 32)


def draws(b: int, p: int, block_t: int, n_tiles: int, m: int, k: int,
          zipf: float, seed: int = 0):
    """The JAX script's inputs: numpy's ``default_rng(seed)`` drawing, in
    order, the (m, NA) uint8 codes, the (NA,) squared-normal row term
    (+inf on the trailing inf tile), the (B, m, k) |normal| LUTs and the
    (B, P) zipf-weighted tile ids → (luts, codes_t, rowterm, tiles)."""
    rng = np.random.default_rng(seed)
    na = (n_tiles + 1) * block_t
    codes = rng.integers(0, k, size=(m, na)).astype(np.uint8)
    rowterm = rng.normal(size=(na,)).astype(np.float32) ** 2
    rowterm[n_tiles * block_t:] = np.inf
    luts = np.abs(rng.normal(size=(b, m, k))).astype(np.float32)
    w = 1.0 / np.arange(1, n_tiles + 1) ** zipf
    tiles = rng.choice(n_tiles, size=(b, p), p=w / w.sum()).astype(np.int32)
    return luts, codes, rowterm, tiles


def launch_blocks(fn, kernel: str) -> int:
    """The CUDA blocks that one call of ``fn`` launches of ``kernel`` (a
    kernel's name in ``csrc/``), summed over its launches: the grid of each
    launch in a ``torch.profiler`` trace of the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pat = re.compile(rf"\b{kernel}\b")
    # a trace has come back without a kernel's records (chip_smoke.py's
    # device_ms): trace again
    for _ in range(3):
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        grids = [e["args"]["grid"] for e in events
                 if e.get("cat") == "kernel" and pat.search(e.get("name", ""))
                 and "grid" in e.get("args", {})]
        if grids:
            return int(sum(math.prod(g) for g in grids))
    raise RuntimeError(f"the profiler recorded no launch of {kernel}")


def _parser():
    ap = arg_parser(__doc__)
    ap.add_argument("--b", type=int, default=1024, help="query batch")
    ap.add_argument("--p", type=int, default=16, help="tile slots/query")
    ap.add_argument("--block-t", type=int, default=256)
    ap.add_argument("--n-tiles", type=int, default=400,
                    help="real tiles (≈100k targets at block_t=256)")
    ap.add_argument("--m", type=int, default=30)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="tile popularity skew (cell sizes are zipfy)")
    ap.add_argument("--out",
                    default=str(REPORTS / "budget_kernel_sweep_torch.json"))
    return ap


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    args, dev = parse(_parser(), argv, device)
    B, P, bt, nt, m, k = (args.b, args.p, args.block_t, args.n_tiles,
                          args.m, args.k)
    luts, codes, rowterm, tiles = draws(B, P, bt, nt, m, k, args.zipf)
    luts_d, codes_d, rt_d, tiles_d = (torch.from_numpy(a).to(dev) for a in
                                      (luts, codes, rowterm, tiles))
    on_card = dev.type == "cuda"
    results = dict(b=B, p=P, block_t=bt, n_tiles=nt, m=m, k=k,
                   zipf=args.zipf,
                   mean_run=float(B * P / len(np.unique(tiles))))

    # each kernel's bound: tiles, LUTs and the (B, P·block_t) result once,
    # the distinct tiles' codes and row terms once; B·P·block_t·m adds and
    # lookups (4 bytes each for float LUTs, 1 for int8), no slot on the inf
    # tile
    shared_rate = bounds.smem_bytes_per_s() if on_card else float("inf")
    ops = B * P * bt * m
    probe = (tiles.nbytes + B * P * bt * 4
             + len(np.unique(tiles)) * bt * (m * codes.itemsize + 4))

    def bound_of(lut_bytes: int, lookup: int) -> str:
        ms, by, term = bounds.bound(probe + lut_bytes, ops, "fp32",
                                    shared=lookup * ops,
                                    shared_rate=shared_rate)
        return f"bound {ms:.4f} ms ({by}, {term})"

    def per_query(q):
        return kernels.budget_adc(q, codes_d, rt_d, tiles_d, block_t=bt)

    t0 = time.perf_counter()
    ref = per_query(luts_d)
    materialize(ref)
    log(f"per-query first call {time.perf_counter() - t0:.1f}s")
    t = timeit_piped(per_query, luts_d)
    results["per_query_s"] = t
    results["per_query_programs"] = (
        launch_blocks(lambda: per_query(luts_d), "budget_adc_kernel")
        if on_card else B * P)
    log(f"per-query: {t * 1e3:.4f} ms ({results['per_query_programs']} "
        f"programs), {bound_of(luts.nbytes, 4)}")
    ref = ref.cpu().numpy()
    fin = np.isfinite(ref)

    for rows in GROUPED_ROWS:
        def grouped(q, rows=rows):
            return kernels.budget_adc_grouped(q, codes_d, rt_d, tiles_d,
                                              block_t=bt, rows=rows)

        t0 = time.perf_counter()
        got = grouped(luts_d).cpu().numpy()
        log(f"rows={rows} first call {time.perf_counter() - t0:.1f}s")
        ok = (np.array_equal(np.isfinite(got), fin)
              and np.allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5))
        t = timeit_piped(grouped, luts_d)
        progs = (launch_blocks(lambda: grouped(luts_d),
                               "budget_adc_grouped_kernel") if on_card
                 else -(-B * P // rows) + nt + 1)
        layout = timeit_piped(
            lambda tl, rows=rows: kernels.budget_pair_layout(tl, nt + 1,
                                                             rows), tiles_d)
        results[f"grouped_r{rows}_s"] = t
        results[f"grouped_r{rows}_programs"] = progs
        results[f"grouped_r{rows}_match"] = bool(ok)
        log(f"grouped rows={rows}: {t * 1e3:.4f} ms ({progs} programs, "
            f"match={ok}, {results['per_query_s'] / t:.2f}x), its pair "
            f"layout alone {layout * 1e3:.4f} ms, "
            f"{bound_of(luts.nbytes, 4)}")

    # int8 LUTs at the row counts the TPU sweep found best
    lut_max = luts.reshape(B, -1).max(axis=1)
    for rows in INT8_ROWS:
        def grouped_i8(q, rows=rows):
            return kernels.budget_adc_grouped(q, codes_d, rt_d, tiles_d,
                                              block_t=bt, rows=rows,
                                              lut_dtype="int8")

        t0 = time.perf_counter()
        got = grouped_i8(luts_d).cpu().numpy()
        log(f"int8 rows={rows} first call {time.perf_counter() - t0:.1f}s")
        # int8 quantization (max/254) + the bf16 reference's own LUT
        # rounding (max/512) in the JAX script's bound
        bound = m * lut_max * (1 / 254 + 1 / 512) * 1.01 + 1e-3
        err = np.abs(np.where(fin, got - ref, 0.0))
        ok = bool((err <= bound[:, None]).all()
                  and np.array_equal(np.isfinite(got), fin))
        t = timeit_piped(grouped_i8, luts_d)
        results[f"grouped_i8_r{rows}_s"] = t
        results[f"grouped_i8_r{rows}_match"] = ok
        log(f"grouped int8 rows={rows}: {t * 1e3:.4f} ms (match={ok}, "
            f"{results['per_query_s'] / t:.2f}x), "
            f"{bound_of(luts.size + 4 * B, 1)}")

    write_json(args.out, results, 1)
    # "best" only among configs whose outputs matched the reference
    best = min((v, k2) for k2, v in results.items()
               if k2.endswith("_s")
               and results.get(k2[:-2] + "_match", True))[1]
    rows = kernels.GROUPED_ROWS_DEFAULT
    picks = (f"grouped rows={rows}"
             if kernels._grouped_wins(B * P, nt + 1, rows, m * k * 2)
             else "per-query")
    log(f"the dispatch rule picks {picks} at this shape; the fastest "
        f"matched is {best} on "
        f"{torch.cuda.get_device_name(dev) if on_card else dev}")
    print(json.dumps({"best": best,
                      "per_query_ms": results["per_query_s"] * 1e3}))
    return results


if __name__ == "__main__":
    main()
