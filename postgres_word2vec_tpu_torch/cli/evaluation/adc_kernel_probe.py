"""A/B probe of the exhaustive ADC scans at 3M rows: the dense scan against
the binned one.

The port's ``evaluation/adc_kernel_probe.py``. Times, on the JAX script's
random codes and LUTs (numpy's ``default_rng(0)``, drawn in the same
order; timing does not depend on values):

- dense: ``kernels.adc_top_k`` (K2, the (B, N) distances, then the top-k);
- binned: ``kernels.adc_top_k_binned`` (K4, one survivor per strided bin,
  then the survivors' top-k);

at B ∈ {64, 256} in the 12×256 and 60×16 regimes, each the median of 3
calls after a warm one. Keys ``m{m}k{k}_B{B}`` with ``dense_ms_per_q``,
``binned_ms_per_q`` and ``speedup``.

``--sweep`` adds ``sweep_m12k256_B256``: K4 alone at B 256 and 12×256
over ``block_n`` ∈ {2048, 4096, 8192} (a size that does not divide N is
skipped), queries per block ∈ {16, 8, 4} (the card's counterpart of the
TPU's ``block_b``, through the C entry point
``pw2v_adc_scan_binned_qb``) and ``bins`` ∈ {128, 256} where ``bins ≤
block_n / 2``, as ``bn{block_n}_qb{qb}_bins{bins}``: ms a query, or
``{"failed": true, "error": …}`` where the checks of
``kernels.adc_scan_binned`` refuse the point (the card's K4 takes bins =
128). The queries-per-block route has no plain version, so ``--sweep``
runs only on the card and raises on the CPU.

    python -m postgres_word2vec_tpu_torch.cli.evaluation.adc_kernel_probe \\
        [--sweep] [--device cpu]          # 3,072,000 rows
    BENCH_SMALL=1 python -m ...adc_kernel_probe   # 307,200 rows

One JSON line on stdout; progress on stderr.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from postgres_word2vec_tpu_torch.cli._common import arg_parser
from postgres_word2vec_tpu_torch.cli.evaluation._research import parse
from postgres_word2vec_tpu_torch.evaluation.benchutil import log, timeit
from postgres_word2vec_tpu_torch.ops import kernels

K = 10
REGIMES = ((12, 256), (60, 16))
BATCHES = (64, 256)
#: the queries per block ``pw2v_adc_scan_binned_qb`` can be forced to
QUERY_BLOCKS = (16, 8, 4, 2, 1)


def cases(n: int, rng: np.random.Generator):
    """The probe's inputs in the JAX script's order: per regime its (m, N)
    uint8 codes, then per batch its (B, m, k) |normal| LUTs → yields (m,
    k, B, luts, codes_t) as numpy arrays."""
    for m, k in REGIMES:
        codes_t = rng.integers(0, k, size=(m, n)).astype(np.uint8)
        for b in BATCHES:
            luts = np.abs(rng.normal(size=(b, m, k))).astype(np.float32)
            yield m, k, b, luts, codes_t


def dense(luts: torch.Tensor, codes_t: torch.Tensor, n: int):
    return kernels.adc_top_k(luts, codes_t, K, valid_n=n)


def binned(luts: torch.Tensor, codes_t: torch.Tensor, n: int):
    return kernels.adc_top_k_binned(luts, codes_t, K, valid_n=n)


def binned_at(luts: torch.Tensor, codes_t: torch.Tensor, *, block_n: int,
              bins: int, qb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 with ``qb`` queries per block → (mins, ids), the contract of
    ``kernels.adc_scan_binned``, whose checks it makes first: a point they
    refuse raises ``ValueError`` before any launch. Card tensors only."""
    kernels._require(luts.is_cuda and codes_t.is_cuda,
                     "the queries-per-block sweep runs only on the card")
    kernels._require(bins >= 1 and block_n % bins == 0,
                     f"block_n={block_n} must be a multiple of bins={bins}")
    kernels._require(bins == kernels.BINNED_BINS,
                     f"the card's binned scan takes bins="
                     f"{kernels.BINNED_BINS}, got {bins}")
    kernels._require(qb in QUERY_BLOCKS,
                     f"queries per block must be one of {QUERY_BLOCKS}")
    kernels._check_adc_inputs(luts, codes_t)
    b, m, k = luts.shape
    n = codes_t.shape[1]
    width = -(-n // block_n) * bins
    mins = torch.empty(b, width, dtype=torch.float32, device=luts.device)
    ids = torch.empty(b, width, dtype=torch.int32, device=luts.device)
    kernels._launch("adc_scan_binned", "pw2v_adc_scan_binned_qb",
                    luts.data_ptr(), codes_t.data_ptr(),
                    codes_t.element_size(), mins.data_ptr(), ids.data_ptr(),
                    b, m, k, n, block_n, bins, qb, kernels._stream())
    return mins, ids


def probe(n: int, device: torch.device, sweep: bool = False) -> dict:
    """The probe at ``n`` rows on ``device`` → the record."""
    if sweep and device.type != "cuda":
        raise ValueError("--sweep runs K4 at forced queries per block, a "
                         "route with no plain version: it runs only on the "
                         "card")
    rng = np.random.default_rng(0)
    out = {}
    for m, k, b, luts, codes_t in cases(n, rng):
        lt = torch.from_numpy(luts).to(device)
        ct = torch.from_numpy(codes_t).to(device)
        t_dense, _ = timeit(lambda: dense(lt, ct, n), iters=3)
        t_binned, _ = timeit(lambda: binned(lt, ct, n), iters=3)
        key = f"m{m}k{k}_B{b}"
        out[key] = {"dense_ms_per_q": round(t_dense / b * 1e3, 4),
                    "binned_ms_per_q": round(t_binned / b * 1e3, 4),
                    "speedup": round(t_dense / t_binned, 2)}
        log(f"{key}: dense {t_dense * 1e3:.1f}ms  binned "
            f"{t_binned * 1e3:.1f}ms  ({t_dense / t_binned:.2f}x)")

    if sweep:
        # block-shape sweep of the binned kernel at the throughput batch
        m, k, b = 12, 256, 256
        ct = torch.from_numpy(
            rng.integers(0, k, size=(m, n)).astype(np.uint8)).to(device)
        lt = torch.from_numpy(
            np.abs(rng.normal(size=(b, m, k))).astype(np.float32)).to(device)
        points = {}
        for bn in (2048, 4096, 8192):
            if n % bn:
                continue
            for qb in (16, 8, 4):
                for bins in (128, 256):
                    if bins > bn // 2:
                        continue
                    kk = f"bn{bn}_qb{qb}_bins{bins}"
                    try:
                        t, _ = timeit(lambda: binned_at(
                            lt, ct, block_n=bn, bins=bins, qb=qb),
                            iters=3)
                    except ValueError as e:
                        # the wrapper's checks refuse the point: recorded,
                        # as exact_block_sweep records a refused size
                        log(f"{kk}: refused ({e})")
                        points[kk] = {"failed": True, "error": str(e)[:300]}
                        continue
                    points[kk] = round(t / b * 1e3, 4)
                    log(f"{kk}: {t * 1e3:.2f}ms ({t / b * 1e3:.4f} ms/q)")
        out["sweep_m12k256_B256"] = points
    return out


def main(argv: list[str] | None = None,
         device: torch.device | str | None = None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep K4's block shape (the card only)")
    args, dev = parse(ap, argv, device)
    small = bool(int(os.environ.get("BENCH_SMALL", "0")))
    out = probe(307_200 if small else 3_072_000, dev, sweep=args.sweep)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
