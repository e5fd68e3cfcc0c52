"""The search paths' scan and probe kernels for Hopper, their wrappers and
their plain PyTorch versions.

Counterpart of ``postgres_word2vec_tpu/ops/pallas_kernels.py``. Ten
kernels, written in CUDA C++ for ``sm_90a`` (sources in ``csrc/``, built by
``ops/_build.py``):

- K1 :func:`fused_exact_scan` — brute-force bf16 scan fused with a
  strided-bin min/argmin (``csrc/fused_exact_scan.cu``);
- K2 :func:`adc_scan` — dense ADC distances (``csrc/adc_scan.cu``);
- K3 :func:`adc_scan_int8` — the same over int8 LUTs
  (``csrc/adc_scan_int8.cu``);
- K4 :func:`adc_scan_binned` — ADC fused with a strided-bin min/argmin
  (``csrc/adc_scan_binned.cu``);
- K5 :func:`adc_scan_binned_int8` — its int8 twin, an exact packed key
  (``csrc/adc_scan_binned_int8.cu``);
- K6 :func:`budget_adc` — budgeted tile-gather ADC, one query per block,
  its code tiles through a ring of asynchronous copies
  (``csrc/budget_adc.cu``), the IVFADC probe and the sparse join;
- K7 :func:`budget_adc_grouped` — the same contract with the (query,
  tile) pairs grouped by tile on the card (:func:`budget_pair_layout`,
  ``csrc/budget_pair_layout.cu``), written straight into the result
  (``csrc/budget_adc_grouped.cu``);
- K8 :func:`budget_adc_grouped_int8` — K7 over int8 LUTs, staged only
  for a group's real slots and summed in packed 16-bit lanes
  (``csrc/budget_adc_grouped_int8.cu``);
- K9 :func:`budget_exact` — budgeted tile-gather exact scores, a small
  probe's rows spread over many blocks (``csrc/budget_exact.cu``), the
  join's ``method=1``;
- K10 :func:`budget_exact_grouped` — its tile-grouped twin, on the
  tensor cores (``csrc/budget_exact_grouped.cu``).

:func:`budget_adc_auto` / :func:`budget_exact_auto` choose between the
per-query and grouped kernels with the JAX package's rule
(``_grouped_wins``, ``GROUPED_ROWS_DEFAULT``), carried over unchanged.

int8 LUTs (``lut_dtype="int8"`` on :func:`adc_scan`, :func:`adc_top_k`,
:func:`adc_scan_binned`, :func:`adc_top_k_binned`,
:func:`budget_adc_grouped` and :func:`budget_adc_auto`) are quantized in
the torch glue by :func:`quantize_luts_int8` — one max-abs scale per
query, the JAX package's ``_quantize_luts_int8`` — and summed exactly in
int32; the float32 scale is applied once. ``"bf16"`` names the float path,
as in the JAX package; the port keeps those LUTs in float32.

Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; it runs the plain version (``*_plain``, same
module) only for CPU tensors. There is no fallback from a failed launch.
Each wrapper adds one to its kernel's ``launches`` count in
:data:`KERNELS` where it launches, and nowhere else. Each kernel's source
says which TPU kernel it replaces, what bounds it on the H100, and what
its design does about that.

Bins and ids follow the TPU kernels: bin ``j`` of a ``block_n``-row tile
holds rows ``{j, j+bins, j+2·bins, …}`` and a survivor's global id is
``tile·block_n + s·bins + j``.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F

from postgres_word2vec_tpu_torch.ops import adc
from postgres_word2vec_tpu_torch.ops import topk as topk_ops
from postgres_word2vec_tpu_torch.ops.vector_ops import no_tf32, row_sqnorms

_PALLAS = "postgres_word2vec_tpu/ops/pallas_kernels.py"
_CSRC = "postgres_word2vec_tpu_torch/csrc"


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper has launched it."""
    name: str
    source: str        # CUDA source, as a repository path
    replaces: str      # the TPU kernel body it ports, file:line
    launches: int = 0


KERNELS: dict[str, Kernel] = {
    "fused_exact_scan": Kernel("fused_exact_scan",
                               f"{_CSRC}/fused_exact_scan.cu",
                               f"{_PALLAS}:358"),
    "adc_scan": Kernel("adc_scan", f"{_CSRC}/adc_scan.cu", f"{_PALLAS}:91"),
    "adc_scan_binned": Kernel("adc_scan_binned",
                              f"{_CSRC}/adc_scan_binned.cu",
                              f"{_PALLAS}:220"),
    "budget_adc": Kernel("budget_adc", f"{_CSRC}/budget_adc.cu",
                         f"{_PALLAS}:492"),
    "budget_adc_grouped": Kernel("budget_adc_grouped",
                                 f"{_CSRC}/budget_adc_grouped.cu",
                                 f"{_PALLAS}:702"),
    "budget_exact": Kernel("budget_exact", f"{_CSRC}/budget_exact.cu",
                           f"{_PALLAS}:589"),
    "budget_exact_grouped": Kernel("budget_exact_grouped",
                                   f"{_CSRC}/budget_exact_grouped.cu",
                                   f"{_PALLAS}:818"),
    "adc_scan_int8": Kernel("adc_scan_int8", f"{_CSRC}/adc_scan_int8.cu",
                            f"{_PALLAS}:109"),
    "adc_scan_binned_int8": Kernel("adc_scan_binned_int8",
                                   f"{_CSRC}/adc_scan_binned_int8.cu",
                                   f"{_PALLAS}:262"),
    "budget_adc_grouped_int8": Kernel("budget_adc_grouped_int8",
                                      f"{_CSRC}/budget_adc_grouped_int8.cu",
                                      f"{_PALLAS}:721"),
}

#: One query's float32 LUT, or four queries' int8 LUTs, must fit in a
#: block's shared memory (227 KB).
_MAX_LUT_BYTES = 227 * 1024

LUT_DTYPES = ("bf16", "int8")


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def supports_hopper() -> bool:
    """True when CUDA is present and device 0 is compute capability ≥ 9.0
    (the twin of ``supports_pallas``)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) >= (9, 0))


# ---------------------------------------------------------------- helpers

def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if every one is
    on the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"tensors on mixed devices: {sorted(map(str, devs))}")
    return True


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _call(what: str, fn_name: str, *args) -> None:
    """Launch through C entry point ``fn_name``; raise if it fails."""
    from postgres_word2vec_tpu_torch.ops import _build

    lib = _build.load()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err} "
                           f"({lib.pw2v_error_string(err).decode()})")


def _launch(kernel: str, fn_name: str, *args) -> None:
    """:func:`_call` for one of :data:`KERNELS`, counting the launch."""
    _call(kernel, fn_name, *args)
    KERNELS[kernel].launches += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_adc_inputs(luts: torch.Tensor, codes_t: torch.Tensor,
                      scale: torch.Tensor | None = None) -> None:
    """Float32 LUTs, or int8 LUTs with their (B,) float32 ``scale``."""
    dt = torch.float32 if scale is None else torch.int8
    _require(luts.dim() == 3 and luts.dtype == dt and luts.is_contiguous(),
             f"luts must be contiguous {dt} (B, m, k), got "
             f"{luts.dtype} {tuple(luts.shape)}")
    B, m, k = luts.shape
    _require(codes_t.dim() == 2 and codes_t.shape[0] == m
             and codes_t.dtype in (torch.uint8, torch.int16)
             and codes_t.is_contiguous(),
             f"codes_t must be contiguous uint8/int16 (m={m}, N), got "
             f"{codes_t.dtype} {tuple(codes_t.shape)}")
    _require(B >= 1 and codes_t.shape[1] >= 1, "empty query batch or table")
    _require(m * k * 4 <= _MAX_LUT_BYTES,
             f"one query's float32 LUT or four int8 LUTs ({m}×{k}) exceed "
             f"shared memory")
    if scale is not None:
        _require(scale.shape == (B,) and scale.dtype == torch.float32
                 and scale.is_contiguous(),
                 f"scale must be contiguous float32 ({B},), got "
                 f"{scale.dtype} {tuple(scale.shape)}")


def _check_lut_dtype(lut_dtype: str) -> None:
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"lut_dtype must be 'bf16' or 'int8', "
                         f"got {lut_dtype!r}")


def quantize_luts_int8(luts: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization of ADC LUTs → (int8 LUTs in
    [−127, 127], float32 scale (B,)) with ``dist ≈ int_sum · scale``.

    One global max-abs scale per query over all m·k entries, so every
    subspace's lookup shares it and the whole ADC sum accumulates exactly
    in int32 before one float32 rescale. ``round`` rounds half to even.
    The JAX package's ``_quantize_luts_int8`` (pallas_kernels.py:68-88):
    the same float32 LUTs give the same int8 tables."""
    lf = luts.float()
    s = torch.clamp_min(torch.amax(torch.abs(lf), dim=(1, 2)), 1e-20)
    # a true division: ``127.0 / s`` would multiply by a rounded reciprocal
    inv = torch.full_like(s, 127.0) / s
    q = torch.clamp(torch.round(lf * inv[:, None, None]), -127, 127)
    return q.to(torch.int8), s / 127.0


def _bin_min(dist: torch.Tensor, block_n: int, bins: int, base: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Strided-bin min/argmin of a ``(B, n)`` score block whose first row
    is global row ``base`` (a multiple of ``block_n``). Columns past ``n``
    up to a whole tile count as +inf. → (mins (B, n_tiles·bins) float32,
    global ids int32); ties take the smallest id."""
    B, n = dist.shape
    n_tiles = -(-n // block_n)
    pad = n_tiles * block_n - n
    if pad:
        dist = F.pad(dist, (0, pad), value=float("inf"))
    v = dist.reshape(B, n_tiles, block_n // bins, bins)
    mins, arg = torch.min(v, dim=2)                     # (B, n_tiles, bins)
    tile = torch.arange(n_tiles, device=dist.device)[:, None]
    j = torch.arange(bins, device=dist.device)[None, :]
    ids = base + tile * block_n + arg * bins + j
    return mins.reshape(B, -1), ids.reshape(B, -1).to(torch.int32)


# ------------------------------------------------------ K2: dense ADC scan

def adc_scan_plain(luts: torch.Tensor, codes_t: torch.Tensor, *,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`adc_scan` and :func:`adc_scan_int8`:
    ``(B, m, k) × (m, N) → (B, N)`` float32, summed over subspaces in
    order (``adc.adc_distances``). int8 LUTs with their ``scale`` sum
    exactly in int32, then multiply once by the query's scale."""
    d = adc.adc_distances(luts, codes_t.t())
    return d if scale is None else d.float() * scale[:, None]


def adc_scan(luts: torch.Tensor, codes_t: torch.Tensor, *,
             lut_dtype: str = "bf16") -> torch.Tensor:
    """Dense ADC distances ``(B, m, k) × (m, N) → (B, N)`` float32.

    ``codes_t`` is the subspace-major code table in its storage dtype
    (uint8 for k ≤ 256, else int16), any N: the kernel masks the ragged
    edge. Codes must lie in ``[0, k)``. ``lut_dtype="bf16"`` keeps the
    LUTs float32 (K2); ``"int8"`` quantizes them per query and runs K3.
    """
    _check_lut_dtype(lut_dtype)
    if lut_dtype == "int8":
        return adc_scan_int8(*quantize_luts_int8(luts), codes_t)
    if not _on_cuda(luts, codes_t):
        return adc_scan_plain(luts, codes_t)
    _check_adc_inputs(luts, codes_t)
    B, m, k = luts.shape
    n = codes_t.shape[1]
    out = torch.empty(B, n, dtype=torch.float32, device=luts.device)
    _launch("adc_scan", "pw2v_adc_scan", luts.data_ptr(), codes_t.data_ptr(),
            codes_t.element_size(), out.data_ptr(), B, m, k, n, _stream())
    return out


def adc_scan_int8(luts: torch.Tensor, scale: torch.Tensor,
                  codes_t: torch.Tensor) -> torch.Tensor:
    """Dense ADC over int8 LUTs (K3): ``(B, m, k)`` int8 LUTs with their
    ``(B,)`` float32 scale (:func:`quantize_luts_int8`) × ``(m, N)`` codes
    → ``(B, N)`` float32, ``float(Σ_j lut) · scale``; the int32 sum is
    exact and the result equals the plain version's bit for bit."""
    if not _on_cuda(luts, scale, codes_t):
        return adc_scan_plain(luts, codes_t, scale=scale)
    _check_adc_inputs(luts, codes_t, scale)
    B, m, k = luts.shape
    n = codes_t.shape[1]
    out = torch.empty(B, n, dtype=torch.float32, device=luts.device)
    _launch("adc_scan_int8", "pw2v_adc_scan_int8", luts.data_ptr(),
            scale.data_ptr(), codes_t.data_ptr(), codes_t.element_size(),
            out.data_ptr(), B, m, k, n, _stream())
    return out


def adc_top_k(luts: torch.Tensor, codes_t: torch.Tensor, k: int, *,
              valid_n: int | None = None, lut_dtype: str = "bf16"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive ADC top-k through the dense scan (K2, or K3 for
    ``lut_dtype="int8"``) → (dists, int64 ids). ``valid_n`` masks columns
    at or past it. The top-k is exact."""
    dists = adc_scan(luts, codes_t, lut_dtype=lut_dtype)
    n = dists.shape[1]
    if valid_n is not None and valid_n < n:
        dists[:, valid_n:] = float("inf")
    return topk_ops.top_k_smallest(dists, min(k, n))


# ------------------------------------------------- K4: binned ADC scan

#: K5's key of a bin with no row (INT32_MAX).
_KEY_EMPTY = 2**31 - 1


def _key_shift(block_n: int, bins: int) -> int:
    """Width of K5's sub-index field: log2 of ``block_n/bins`` rounded up
    to a power of two (the JAX package's ``sub_pow``)."""
    return (block_n // bins - 1).bit_length()


def _bin_min_int8(sums: torch.Tensor, scale: torch.Tensor, block_n: int,
                  bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's strided-bin reduction of exact int32 sums ``(B, n)``: per bin
    the min of the packed key ``sum·2^shift + s`` (a tie takes the lowest
    sub-index), → (``float(key >> shift) · scale``, global ids int32); a
    bin with no row below ``n`` is +inf with id −1."""
    B, n = sums.shape
    shift = _key_shift(block_n, bins)
    n_tiles = -(-n // block_n)
    sub_idx = (torch.arange(n, device=sums.device) % block_n) // bins
    key = sums.to(torch.int32) * (1 << shift) + sub_idx.to(torch.int32)
    key = F.pad(key, (0, n_tiles * block_n - n), value=_KEY_EMPTY)
    best = torch.amin(key.reshape(B, n_tiles, block_n // bins, bins), dim=2)
    empty = best == _KEY_EMPTY
    mins = (best >> shift).float() * scale[:, None, None]
    tile = torch.arange(n_tiles, device=sums.device)[:, None]
    j = torch.arange(bins, device=sums.device)[None, :]
    ids = tile * block_n + (best & ((1 << shift) - 1)) * bins + j
    mins = torch.where(empty, float("inf"), mins)
    ids = torch.where(empty, -1, ids)
    return mins.reshape(B, -1), ids.reshape(B, -1).to(torch.int32)


#: Strided bins a tile of the binned scans K4 and K5 (one survivor each)
BINNED_BINS = 128


def adc_scan_binned_plain(luts: torch.Tensor, codes_t: torch.Tensor, *,
                          block_n: int = 2048, bins: int = BINNED_BINS,
                          scale: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`adc_scan_binned` and
    :func:`adc_scan_binned_int8`: the dense plain scan, then the
    strided-bin min/argmin (for int8 LUTs with their ``scale``, K5's
    packed-key reduction of the exact int32 sums)."""
    if scale is None:
        return _bin_min(adc_scan_plain(luts, codes_t), block_n, bins)
    return _bin_min_int8(adc.adc_distances(luts, codes_t.t()), scale,
                         block_n, bins)


def adc_scan_binned(luts: torch.Tensor, codes_t: torch.Tensor, *,
                    block_n: int = 2048, bins: int = BINNED_BINS,
                    lut_dtype: str = "bf16"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Binned ADC scan → (mins (B, n_tiles·bins) float32, global ids
    int32), ``n_tiles = ⌈N / block_n⌉``. One survivor per strided bin, so
    the (B, N) distance matrix never reaches device memory. Rows at or past
    N count as +inf; a bin without a valid row holds +inf and its first
    row's id (K4), or id −1 for ``lut_dtype="int8"`` (K5). On the card K4
    and K5 take ``bins=128``."""
    _require(bins >= 1 and block_n % bins == 0,
             f"block_n={block_n} must be a multiple of bins={bins}")
    _check_lut_dtype(lut_dtype)
    if lut_dtype == "int8":
        return adc_scan_binned_int8(*quantize_luts_int8(luts), codes_t,
                                    block_n=block_n, bins=bins)
    if not _on_cuda(luts, codes_t):
        return adc_scan_binned_plain(luts, codes_t, block_n=block_n,
                                     bins=bins)
    _require(bins == BINNED_BINS, f"the card's binned scan takes bins="
             f"{BINNED_BINS}, got {bins}")
    _check_adc_inputs(luts, codes_t)
    B, m, k = luts.shape
    n = codes_t.shape[1]
    width = -(-n // block_n) * bins
    mins = torch.empty(B, width, dtype=torch.float32, device=luts.device)
    ids = torch.empty(B, width, dtype=torch.int32, device=luts.device)
    _launch("adc_scan_binned", "pw2v_adc_scan_binned", luts.data_ptr(),
            codes_t.data_ptr(), codes_t.element_size(), mins.data_ptr(),
            ids.data_ptr(), B, m, k, n, block_n, bins, _stream())
    return mins, ids


def adc_scan_binned_int8(luts: torch.Tensor, scale: torch.Tensor,
                         codes_t: torch.Tensor, *, block_n: int = 2048,
                         bins: int = BINNED_BINS
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Binned ADC over int8 LUTs (K5) → (mins (B, n_tiles·bins) float32,
    global ids int32): per strided bin the min of the exact packed key
    ``int_sum·2^shift + s`` (a tie takes the lowest row id), scaled by the
    query's ``scale``. Rows at or past N are masked; a bin without one is
    +inf with id −1. Equal to the plain version bit for bit. On the card
    K5 takes ``bins=128``."""
    _require(bins >= 1 and block_n % bins == 0,
             f"block_n={block_n} must be a multiple of bins={bins}")
    _require((luts.shape[1] * 127 + 1) << _key_shift(block_n, bins)
             < _KEY_EMPTY, "the packed int8 key would overflow int32")
    if not _on_cuda(luts, scale, codes_t):
        return adc_scan_binned_plain(luts, codes_t, block_n=block_n,
                                     bins=bins, scale=scale)
    _require(bins == BINNED_BINS, f"the card's binned scan takes bins="
             f"{BINNED_BINS}, got {bins}")
    _check_adc_inputs(luts, codes_t, scale)
    B, m, k = luts.shape
    n = codes_t.shape[1]
    width = -(-n // block_n) * bins
    mins = torch.empty(B, width, dtype=torch.float32, device=luts.device)
    ids = torch.empty(B, width, dtype=torch.int32, device=luts.device)
    _launch("adc_scan_binned_int8", "pw2v_adc_scan_binned_int8",
            luts.data_ptr(), scale.data_ptr(), codes_t.data_ptr(),
            codes_t.element_size(), mins.data_ptr(), ids.data_ptr(), B, m, k,
            n, block_n, bins, _stream())
    return mins, ids


def verify_binned(mins: torch.Tensor, ids: torch.Tensor,
                  ref_mins: torch.Tensor, score_at, *, block_n: int,
                  bins: int, valid_n: int, atol: float) -> float:
    """Hold a binned scan's output to its contract; used to compare a
    kernel with its plain version. ``score_at(ids)`` gives each row's
    score, ``(B, W)`` int64 ids → ``(B, W)`` float32.

    - the +inf slots match ``ref_mins`` and the finite mins agree with it
      within ``atol``;
    - every id lies in its own bin: tile ``col // bins``, position
      ``col % bins`` within its stride (an empty +inf bin may carry −1);
    - every finite slot's id is a valid row whose score equals the min
      within ``atol``.

    Returns the largest |mins − ref_mins|; raises ``ValueError`` on a
    violation."""
    fin = torch.isfinite(ref_mins)
    _require(torch.equal(torch.isfinite(mins), fin),
             "+inf slots differ from the plain version")
    err = float((mins - ref_mins)[fin].abs().max()) if fin.any() else 0.0
    _require(err <= atol, f"bin mins differ by {err:.3g} > {atol}")
    col = torch.arange(mins.shape[1], device=ids.device)
    idl = ids.long()
    in_bin = ((idl // block_n == (col // bins)[None])
              & ((idl % block_n) % bins == (col % bins)[None]))
    _require(bool(torch.all(in_bin | ((idl == -1) & ~fin))),
             "an id lies outside its bin")
    _require(bool(torch.all((idl[fin] >= 0) & (idl[fin] < valid_n))),
             "a finite slot points past the table")
    at = score_at(torch.clamp(idl, 0, valid_n - 1))
    gap = float((at - mins)[fin].abs().max()) if fin.any() else 0.0
    _require(gap <= atol,
             f"an id's score is {gap:.3g} away from its bin min (> {atol})")
    return err


def _top_k_survivors(mins: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest bin survivors → (vals, int64 ids), id −1 on +inf
    slots; slots beyond the survivor count are +inf / −1."""
    vals, pos = topk_ops.top_k_smallest(mins, min(k, mins.shape[1]))
    sel = torch.gather(ids, 1, pos).long()
    sel = torch.where(torch.isinf(vals), torch.full_like(sel, -1), sel)
    short = k - vals.shape[1]
    if short > 0:
        vals = F.pad(vals, (0, short), value=float("inf"))
        sel = F.pad(sel, (0, short), value=-1)
    return vals, sel


def adc_top_k_binned(luts: torch.Tensor, codes_t: torch.Tensor, k: int, *,
                     valid_n: int | None = None, block_n: int = 2048,
                     bins: int = BINNED_BINS, lut_dtype: str = "bf16"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-lean exhaustive ADC top-k through the binned scan (K4, or K5
    for ``lut_dtype="int8"``) → (dists, int64 ids). Candidates are per-bin
    minima (one survivor per bin; the global minimum always survives),
    then an exact top-k over them. Survivors with id ≥ ``valid_n`` are
    dropped; +inf slots carry id −1."""
    mins, ids = adc_scan_binned(luts, codes_t, block_n=block_n, bins=bins,
                                lut_dtype=lut_dtype)
    if valid_n is not None:
        mins = torch.where(ids < valid_n, mins,
                           torch.full_like(mins, float("inf")))
    return _top_k_survivors(mins, ids, k)


# ------------------------------------------------ K1: fused exact scan

def tile_table(vectors: torch.Tensor, *, block_n: int = 8192,
               dtype: torch.dtype = torch.bfloat16
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Lay out an ``(N, d)`` table for the fused scan → ``(table (N_pad,
    D) dtype, norms (N_pad,) float32, valid_n)``.

    The table stays row-major. Rows are zero-padded from d to D, the next
    multiple of 8 (300 bf16 values are 600 bytes, which breaks 16-byte
    alignment), and N is padded to a multiple of ``block_n`` with zero
    rows whose norms are +inf, so their shifted scores are +inf and never
    win a bin. Norms are ‖v‖² of the float32 rows."""
    n, d = vectors.shape
    n_pad = -(-n // block_n) * block_n
    dp = -(-d // 8) * 8
    table = torch.zeros(n_pad, dp, dtype=dtype, device=vectors.device)
    norms = torch.full((n_pad,), float("inf"), dtype=torch.float32,
                       device=vectors.device)
    step = 262144
    for s in range(0, n, step):
        e = min(s + step, n)
        table[s:e, :d] = vectors[s:e].to(dtype)
    norms[:n] = row_sqnorms(vectors, chunk_rows=step)
    return table, norms, n


def pad_queries(queries: torch.Tensor, dim: int) -> torch.Tensor:
    """Queries cast to bf16 and zero-padded to the table's row width."""
    q = queries.to(torch.bfloat16)
    if q.shape[1] < dim:
        q = F.pad(q, (0, dim - q.shape[1]))
    return q.contiguous()


@no_tf32()
def fused_exact_scan_plain(queries: torch.Tensor, table: torch.Tensor,
                           norms: torch.Tensor, *, block_n: int = 8192,
                           bins: int = 128, chunk_tiles: int = 32
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_exact_scan`: bf16 operands widened to
    float32 (exactly) and multiplied in float32 (TF32 off), ``chunk_tiles``
    tiles at a time, then the strided-bin min/argmin."""
    qf = queries.float()
    n_tiles = table.shape[0] // block_n
    mins, ids = [], []
    for t0 in range(0, n_tiles, chunk_tiles):
        r0, r1 = t0 * block_n, min(t0 + chunk_tiles, n_tiles) * block_n
        s = norms[r0:r1][None, :] - 2.0 * (qf @ table[r0:r1].float().t())
        m_, i_ = _bin_min(s, block_n, bins, base=r0)
        mins.append(m_)
        ids.append(i_)
    return torch.cat(mins, dim=1), torch.cat(ids, dim=1)


def fused_exact_scan(queries: torch.Tensor, table: torch.Tensor,
                     norms: torch.Tensor, *, block_n: int = 8192,
                     bins: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force binned scan ``(B, D) × (N_pad, D) → (B, n_tiles·bins)``:
    per strided bin, the min of the shifted score ``norm − 2·q·v`` (bf16
    inputs, float32 accumulation) and its global id (int32). Callers top-k
    the small output and add ‖q‖² back. ``table``/``norms`` come from
    :func:`tile_table`; ``queries`` are bf16 with the table's row width."""
    _require(queries.dim() == 2 and table.dim() == 2
             and queries.shape[1] == table.shape[1],
             f"queries {tuple(queries.shape)} and table "
             f"{tuple(table.shape)} must share the row width")
    n_pad, dp = table.shape
    _require(bins == 128 and block_n % bins == 0 and n_pad % block_n == 0,
             f"need bins=128, block_n a multiple of 128 and N_pad "
             f"({n_pad}) a multiple of block_n ({block_n})")
    _require(norms.shape == (n_pad,), "norms must be (N_pad,)")
    if not _on_cuda(queries, table, norms):
        return fused_exact_scan_plain(queries, table, norms,
                                      block_n=block_n, bins=bins)
    _require(queries.dtype == torch.bfloat16 and table.dtype == torch.bfloat16
             and norms.dtype == torch.float32,
             "the fused scan takes bf16 queries and table, float32 norms")
    _require(dp % 8 == 0 and dp <= 448,
             f"row width {dp} must be a multiple of 8 of at most 448")
    _require(block_n <= 32768 and n_pad < 2**31,
             f"block_n ({block_n}) must be at most 32768 and N_pad "
             f"({n_pad}) below 2^31")
    for name, t in (("queries", queries), ("table", table),
                    ("norms", norms)):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name} must be contiguous and 16-byte aligned")
    B = queries.shape[0]
    width = n_pad // block_n * bins
    mins = torch.empty(B, width, dtype=torch.float32, device=table.device)
    ids = torch.empty(B, width, dtype=torch.int32, device=table.device)
    _launch("fused_exact_scan", "pw2v_fused_exact_scan", queries.data_ptr(),
            table.data_ptr(), norms.data_ptr(), mins.data_ptr(),
            ids.data_ptr(), B, dp, n_pad, block_n, _stream())
    return mins, ids


def fused_exact_top_k(queries: torch.Tensor, table: torch.Tensor,
                      norms: torch.Tensor, k: int, *,
                      valid_n: int | None = None, block_n: int = 8192,
                      bins: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused brute-force top-k → (squared dists, int64 ids): one survivor
    per strided bin from the scan, then an exact top-k over the survivors
    and ‖q‖² added back. ``queries`` are float (B, d), d ≤ the table's row
    width."""
    mins, ids = fused_exact_scan(pad_queries(queries, table.shape[1]),
                                 table, norms, block_n=block_n, bins=bins)
    if valid_n is not None and valid_n < table.shape[0]:
        mins = torch.where(ids < valid_n, mins,
                           torch.full_like(mins, float("inf")))
    vals, sel = _top_k_survivors(mins, ids, k)
    qf = queries.float()
    qq = torch.sum(qf * qf, dim=-1, keepdim=True)
    return torch.clamp_min(vals + qq, 0.0), sel


# ------------------------------------------------ K6/K7/K9/K10: budget probes
#
# A budget probe scans, per query, P tiles of ``block_t`` rows of a
# cell-aligned table (each cell's rows padded to whole tiles, one trailing
# all-padding "inf tile"): ``tiles`` is a (B, P) tensor of tile ids and the
# result is (B, P·block_t) float32, slot p in columns [p·block_t,
# (p+1)·block_t). +inf in ``rowterm`` / ``rownorm`` marks pad rows and the
# inf tile and stays +inf. The grouped kernels group the (query, slot) pairs
# by tile first, so ``rows`` queries share one tile: K7 by the pair layout,
# and it writes each pair's row of the contract itself; K8 and K10 by the
# sorted layout, and one row gather takes their result back into the
# contract. The grouping changes no value, so their plain versions are the
# per-query ones.

#: Queries per group of the grouped kernels (the JAX package's on-chip
#: sweep on its TPU, carried over; re-fitting it on the H100 is open).
GROUPED_ROWS_DEFAULT = 32


def _grouped_wins(bp: int, n_tiles: int, rows: int, slot_bytes: int) -> bool:
    """True when the grouped layout's program bound ``⌈bp/rows⌉ + n_tiles``
    beats the per-query ``bp`` by ≥2× and its expanded per-slot copy stays
    under 128 MiB — the JAX package's rule, carried over unchanged."""
    groups = -(-bp // rows) + n_tiles
    return groups * 2 < bp and groups * rows * slot_bytes <= 128 * 2**20


def _group_probe_layout(tiles: torch.Tensor, n_queries: int, p: int,
                        groups: int, inf_tile: int, rows: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Regroup (query, tile-slot) pairs by tile into ``rows``-query groups:

      qidx (groups, rows) int32 — query per slot (``n_queries`` = unused)
      tog  (groups,)      int32 — tile per group (``inf_tile`` for padding)
      row  (B·P,)         int64 — grouped row of each flat (query-major)
                                  pair, for reassembly

    A stable sort by tile, then each run of equal tiles fills whole groups
    from their first slot. ``groups`` must be ≥ ⌈B·P/rows⌉ + the number of
    distinct tiles."""
    bp = tiles.numel()
    dev = tiles.device
    s, order = torch.sort(tiles.reshape(bp).to(torch.int32), stable=True)
    idx = torch.arange(bp, device=dev)
    head = torch.ones(bp, dtype=torch.bool, device=dev)
    head[1:] = s[1:] != s[:-1]
    run_start = torch.cummax(torch.where(head, idx, 0), 0).values
    j = idx - run_start
    gid = torch.cumsum((j % rows == 0).to(torch.int64), 0) - 1
    row_sorted = gid * rows + j % rows
    qidx = torch.full((groups * rows,), n_queries, dtype=torch.int32,
                      device=dev)
    qidx[row_sorted] = (order // p).to(torch.int32)
    tog = torch.full((groups,), inf_tile, dtype=torch.int32, device=dev)
    tog[gid] = s
    row = torch.empty(bp, dtype=torch.int64, device=dev)
    row[order] = row_sorted
    return qidx.reshape(groups, rows), tog, row


def _grouped_layout(tiles: torch.Tensor, n_tiles: int, rows: int):
    """:func:`_group_probe_layout` with the static group bound."""
    B, P = tiles.shape
    groups = -(-B * P // rows) + n_tiles
    return _group_probe_layout(tiles, B, P, groups, n_tiles - 1, rows)


def _reassemble(out_rows: torch.Tensor, row: torch.Tensor,
                tiles: torch.Tensor) -> torch.Tensor:
    """Grouped ``(G·rows, block_t)`` rows → the ``(B, P·block_t)``
    contract."""
    B, P = tiles.shape
    return out_rows.index_select(0, row).reshape(B, P * out_rows.shape[1])


def budget_pair_layout_plain(tiles: torch.Tensor, n_tiles: int, rows: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`budget_pair_layout`: tile ids outside
    ``[0, n_tiles)`` become one bucket (tile ``n_tiles``), then
    :func:`_group_probe_layout`'s stable sort, and each grouped slot takes
    the flat pair it holds, ``pairs[row] = arange(B·P)``."""
    B, P = tiles.shape
    groups = -(-B * P // rows) + n_tiles
    t = tiles.to(torch.int32)
    t = torch.where((t >= 0) & (t < n_tiles), t, n_tiles)
    _, tog, row = _group_probe_layout(t, B, P, groups, n_tiles - 1, rows)
    pairs = torch.full((groups * rows,), -1, dtype=torch.int32,
                       device=tiles.device)
    pairs[row] = torch.arange(B * P, dtype=torch.int32, device=tiles.device)
    return pairs.reshape(groups, rows), tog


def budget_pair_layout(tiles: torch.Tensor, n_tiles: int, rows: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group a (B, P) plan's flat query-major pairs ``b·P + p`` by tile,
    ``rows`` to a group → ``(pairs (G, rows) int32, tog (G,) int32)``, G =
    ⌈B·P/rows⌉ + n_tiles: group g holds pairs ``pairs[g]`` (−1 on an unused
    slot, the real ones first) that all probe tile ``tog[g]``. Ids outside
    the table share the groups of tile ``n_tiles``; groups past the last
    real one are padding (tile ``n_tiles − 1``, no pair).

    On the card two launches of ``csrc/budget_pair_layout.cu`` build it
    (K7's glue, not one of :data:`KERNELS`): pairs are counted by tile and
    placed by atomics, so which pairs share a group, and in which order,
    may differ from the plain version's stable sort and from run to run;
    every pair lands in exactly one slot of a group of its tile."""
    if not _on_cuda(tiles):
        return budget_pair_layout_plain(tiles, n_tiles, rows)
    from postgres_word2vec_tpu_torch.ops import _build

    B, P = tiles.shape
    groups = -(-B * P // rows) + n_tiles
    _require(tiles.dtype == torch.int32 and tiles.is_contiguous(),
             "tiles must be contiguous int32")
    scratch = _build.load().pw2v_budget_pair_layout_scratch(B * P, n_tiles)
    _require(rows >= 1 and scratch >= 0
             and groups * (rows + 1) + scratch < 2**31,
             f"a layout of {groups} groups of {rows} exceeds int32")
    buf = torch.empty(groups * (rows + 1) + scratch, dtype=torch.int32,
                      device=tiles.device)
    base = buf.data_ptr()
    _call("budget_pair_layout", "pw2v_budget_pair_layout", tiles.data_ptr(),
          base, base + 4 * groups * rows, base + 4 * groups * (rows + 1),
          B * P, n_tiles, groups, rows, _stream())
    return (buf[:groups * rows].view(groups, rows),
            buf[groups * rows:groups * (rows + 1)])


def _check_budget(table_rows: int, block_t: int, tiles: torch.Tensor,
                  B: int, term: torch.Tensor) -> torch.Tensor:
    """Shape checks shared by the four wrappers → int32 contiguous tiles."""
    _require(block_t >= 1 and table_rows >= block_t
             and table_rows % block_t == 0,
             f"NA={table_rows} is not a multiple of block_t={block_t}")
    _require(tiles.dim() == 2 and tiles.shape[0] == B and tiles.shape[1] >= 1,
             f"tiles must be (B={B}, P≥1), got {tuple(tiles.shape)}")
    _require(term.shape == (table_rows,) and term.dtype == torch.float32
             and term.is_contiguous(),
             f"row term must be contiguous float32 ({table_rows},), got "
             f"{term.dtype} {tuple(term.shape)}")
    return tiles.to(torch.int32).contiguous()


# K6 -------------------------------------------------------------------------

def budget_adc_plain(luts: torch.Tensor, codes_t: torch.Tensor,
                     rowterm: torch.Tensor, tiles: torch.Tensor, *,
                     block_t: int, scale: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Plain version of :func:`budget_adc`, :func:`budget_adc_grouped` and
    :func:`budget_adc_grouped_int8` (``adc.budget_adc_xla`` on the
    transposed code table): LUT sums over subspaces in order, then the row
    term — the kernels' order, so float32 results agree bit for bit. int8
    LUTs with their ``scale``: the exact int32 sum times the scale, then
    the row term, each rounded on its own as in K8."""
    return adc.budget_adc_xla(luts, codes_t.t(), rowterm, tiles,
                              block_t=block_t, scale=scale)


def budget_adc(luts: torch.Tensor, codes_t: torch.Tensor,
               rowterm: torch.Tensor, tiles: torch.Tensor, *,
               block_t: int) -> torch.Tensor:
    """Budgeted tile-gather ADC → ``(B, P·block_t)`` float32 (K6).

    ``luts`` (B, m, k) float32 per-query LUTs; ``codes_t`` (m, NA)
    uint8/int16 cell-aligned codes, NA a multiple of ``block_t``;
    ``rowterm`` (NA,) float32 additive row term (+inf on padding);
    ``tiles`` (B, P) tile ids. On the card an id outside the table reads
    as the inf tile, and slots on the table's last tile (the inf tile, a
    plan's padding) come out +inf without a read once the kernel has seen
    that its row terms are all +inf; LUT entries must be finite."""
    if not _on_cuda(luts, codes_t, rowterm, tiles):
        return budget_adc_plain(luts, codes_t, rowterm, tiles,
                                block_t=block_t)
    _check_adc_inputs(luts, codes_t)
    B, m, k = luts.shape
    na = codes_t.shape[1]
    t = _check_budget(na, block_t, tiles, B, rowterm)
    P = t.shape[1]
    out = torch.empty(B, P * block_t, dtype=torch.float32, device=luts.device)
    _launch("budget_adc", "pw2v_budget_adc", luts.data_ptr(),
            codes_t.data_ptr(), codes_t.element_size(), rowterm.data_ptr(),
            t.data_ptr(), out.data_ptr(), B, m, k, na, P, block_t, _stream())
    return out


# K7 -------------------------------------------------------------------------

def budget_adc_grouped(luts: torch.Tensor, codes_t: torch.Tensor,
                       rowterm: torch.Tensor, tiles: torch.Tensor, *,
                       block_t: int, rows: int = 8,
                       lut_dtype: str = "bf16") -> torch.Tensor:
    """Tile-grouped budgeted ADC (K7), :func:`budget_adc`'s contract: the
    (query, slot) pairs are grouped by tile on the card
    (:func:`budget_pair_layout`), ``rows`` pairs per block share one code
    tile, and each writes its own row of the ``(B, P·block_t)`` result;
    equal to the plain version bit for bit. ``lut_dtype="int8"`` quantizes
    the LUTs per query and runs K8. CPU tensors take
    :func:`budget_adc_plain`."""
    _check_lut_dtype(lut_dtype)
    if lut_dtype == "int8":
        return budget_adc_grouped_int8(*quantize_luts_int8(luts), codes_t,
                                       rowterm, tiles, block_t=block_t,
                                       rows=rows)
    if not _on_cuda(luts, codes_t, rowterm, tiles):
        return budget_adc_plain(luts, codes_t, rowterm, tiles,
                                block_t=block_t)
    _check_adc_inputs(luts, codes_t)
    B, m, k = luts.shape
    na = codes_t.shape[1]
    t = _check_budget(na, block_t, tiles, B, rowterm)
    _require(rows >= 1, f"rows must be ≥ 1, got {rows}")
    P = t.shape[1]
    pairs, tog = budget_pair_layout(t, na // block_t, rows)
    out = torch.empty(B, P * block_t, dtype=torch.float32, device=luts.device)
    _launch("budget_adc_grouped", "pw2v_budget_adc_grouped", luts.data_ptr(),
            codes_t.data_ptr(), codes_t.element_size(), rowterm.data_ptr(),
            pairs.data_ptr(), tog.data_ptr(), out.data_ptr(), B, m, k, na, P,
            tog.shape[0], rows, block_t, _stream())
    return out


# K8 -------------------------------------------------------------------------

def budget_adc_grouped_int8(luts: torch.Tensor, scale: torch.Tensor,
                            codes_t: torch.Tensor, rowterm: torch.Tensor,
                            tiles: torch.Tensor, *, block_t: int,
                            rows: int = 8) -> torch.Tensor:
    """Tile-grouped budgeted ADC over int8 LUTs (K8): K7's grouping glue
    and contract, ``float(Σ_j lut) · scale + rowterm`` with the per-query
    ``scale`` of :func:`quantize_luts_int8`, whose LUTs lie in [−127, 127];
    finite results equal the plain version's bit for bit. CPU tensors take
    :func:`budget_adc_plain` with the same int8 LUTs."""
    if not _on_cuda(luts, scale, codes_t, rowterm, tiles):
        return budget_adc_plain(luts, codes_t, rowterm, tiles,
                                block_t=block_t, scale=scale)
    _check_adc_inputs(luts, codes_t, scale)
    B, m, k = luts.shape
    na = codes_t.shape[1]
    t = _check_budget(na, block_t, tiles, B, rowterm)
    _require(rows >= 1, f"rows must be ≥ 1, got {rows}")
    _require(4 * m * k + m * block_t * codes_t.element_size()
             <= _MAX_LUT_BYTES - 1024,
             f"four int8 LUTs ({m}×{k}) and a code tile of {block_t} rows "
             f"exceed shared memory")
    qidx, tog, row = _grouped_layout(t, na // block_t, rows)
    groups = tog.shape[0]
    out = torch.empty(groups * rows, block_t, dtype=torch.float32,
                      device=luts.device)
    _launch("budget_adc_grouped_int8", "pw2v_budget_adc_grouped_int8",
            luts.data_ptr(), scale.data_ptr(), codes_t.data_ptr(),
            codes_t.element_size(), rowterm.data_ptr(), qidx.data_ptr(),
            tog.data_ptr(), out.data_ptr(), B, m, k, na, groups, rows,
            block_t, _stream())
    return _reassemble(out, row, t)


def budget_adc_auto(luts: torch.Tensor, codes_t: torch.Tensor,
                    rowterm: torch.Tensor, tiles: torch.Tensor, *,
                    block_t: int, rows: int | None = None,
                    lut_dtype: str = "bf16") -> torch.Tensor:
    """Grouped (K7, or K8 for ``lut_dtype="int8"``) for probe sets over few
    tiles (the join regime), per-query (K6) otherwise — the JAX
    ``budget_adc_auto`` rule. The per-query kernel has no int8 twin, as
    in the JAX package: an int8 request that lands there warns and runs
    K6 on float32 LUTs."""
    _check_lut_dtype(lut_dtype)
    rows = GROUPED_ROWS_DEFAULT if rows is None else rows
    B, m, k = luts.shape
    slot_bytes = m * k * (1 if lut_dtype == "int8" else 2)
    if _grouped_wins(B * tiles.shape[1], codes_t.shape[1] // block_t, rows,
                     slot_bytes):
        return budget_adc_grouped(luts, codes_t, rowterm, tiles,
                                  block_t=block_t, rows=rows,
                                  lut_dtype=lut_dtype)
    if lut_dtype == "int8":
        warnings.warn(
            "budget_adc_auto: probe shape selects the per-query kernel, "
            "which has no int8 variant — running float32 LUTs. (Sparse "
            "probes or an expanded-LUT copy past the memory guard.)",
            stacklevel=2)
    return budget_adc(luts, codes_t, rowterm, tiles, block_t=block_t)


# K9 -------------------------------------------------------------------------

def _check_exact_inputs(queries: torch.Tensor, vecs: torch.Tensor) -> None:
    _require(vecs.dim() == 2 and vecs.dtype == torch.bfloat16
             and vecs.is_contiguous() and vecs.data_ptr() % 16 == 0,
             f"vecs must be contiguous 16-byte aligned bf16 (NA, D), got "
             f"{vecs.dtype} {tuple(vecs.shape)}")
    D = vecs.shape[1]
    _require(D % 8 == 0 and 8 <= D <= 1024,
             f"row width {D} must be a multiple of 8 in [8, 1024]")
    _require(queries.dim() == 2 and queries.shape[0] >= 1
             and queries.shape[1] <= D,
             f"queries {tuple(queries.shape)} wider than the table ({D})")


def _pad_f32(queries: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 queries zero-padded to the table's row width, contiguous
    and 16-byte aligned (K10 reads them in 16-byte pieces)."""
    q = queries.float()
    if q.shape[1] < dim:
        q = F.pad(q, (0, dim - q.shape[1]))
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def budget_exact_plain(queries: torch.Tensor, vecs: torch.Tensor,
                       rownorm: torch.Tensor, tiles: torch.Tensor, *,
                       block_t: int) -> torch.Tensor:
    """Plain version of :func:`budget_exact` (``adc.budget_exact_xla``):
    float32 queries against the bf16 rows widened to float32, a float32
    matmul with TF32 off."""
    return adc.budget_exact_xla(queries, vecs, rownorm, tiles,
                                block_t=block_t)


def budget_exact(queries: torch.Tensor, vecs: torch.Tensor,
                 rownorm: torch.Tensor, tiles: torch.Tensor, *,
                 block_t: int) -> torch.Tensor:
    """Budgeted tile-gather exact scores → ``(B, P·block_t)`` shifted
    scores ``‖v‖² − 2·q·v`` (K9); add ‖q‖² back for squared L2.

    ``queries`` (B, d) float, kept float32 and read by the kernel as they
    are (no padding to D); ``vecs`` (NA, D) bf16 row-major cell-aligned
    rows, D a multiple of 8 ≥ d (pad rows zero); ``rownorm`` (NA,) float32
    ‖v‖², +inf on padding. On the card slots on the table's last tile come
    out +inf without a read once the kernel has seen that its row norms
    are all +inf."""
    if not _on_cuda(queries, vecs, rownorm, tiles):
        return budget_exact_plain(queries, vecs, rownorm, tiles,
                                  block_t=block_t)
    _check_exact_inputs(queries, vecs)
    B, d = queries.shape
    na, D = vecs.shape
    t = _check_budget(na, block_t, tiles, B, rownorm)
    P = t.shape[1]
    q = queries.float().contiguous()   # as it is for float32 queries
    out = torch.empty(B, P * block_t, dtype=torch.float32,
                      device=queries.device)
    _launch("budget_exact", "pw2v_budget_exact", q.data_ptr(),
            vecs.data_ptr(), rownorm.data_ptr(), t.data_ptr(),
            out.data_ptr(), B, d, D, na, P, block_t, _stream())
    return out


# K10 ------------------------------------------------------------------------

def budget_exact_grouped(queries: torch.Tensor, vecs: torch.Tensor,
                         rownorm: torch.Tensor, tiles: torch.Tensor, *,
                         block_t: int, rows: int = 8) -> torch.Tensor:
    """Tile-grouped budgeted exact scores (K10), :func:`budget_exact`'s
    contract: ``rows`` ≤ 32 queries per block share one vector tile, their
    products on the tensor cores with each float32 query value split into
    three bf16 parts (``hi = bf16(q)``, ``mid = bf16(q − hi)``, ``lo =
    bf16(q − hi − mid)``, which hold it exactly), within 1e-4 of the
    float32 plain version. CPU tensors take :func:`budget_exact_plain`."""
    if not _on_cuda(queries, vecs, rownorm, tiles):
        return budget_exact_plain(queries, vecs, rownorm, tiles,
                                  block_t=block_t)
    _check_exact_inputs(queries, vecs)
    _require(1 <= rows <= 32, f"rows must be in [1, 32], got {rows}")
    B = queries.shape[0]
    na, D = vecs.shape
    t = _check_budget(na, block_t, tiles, B, rownorm)
    qidx, tog, row = _grouped_layout(t, na // block_t, rows)
    groups = tog.shape[0]
    q = _pad_f32(queries, D)
    out = torch.empty(groups * rows, block_t, dtype=torch.float32,
                      device=queries.device)
    _launch("budget_exact_grouped", "pw2v_budget_exact_grouped",
            q.data_ptr(), vecs.data_ptr(), rownorm.data_ptr(),
            qidx.data_ptr(), tog.data_ptr(), out.data_ptr(), B, D, na,
            groups, rows, block_t, _stream())
    return _reassemble(out, row, t)


def budget_exact_auto(queries: torch.Tensor, vecs: torch.Tensor,
                      rownorm: torch.Tensor, tiles: torch.Tensor, *,
                      block_t: int, rows: int | None = None) -> torch.Tensor:
    """Grouped (K10) / per-query (K9) dispatch, the same rule as
    :func:`budget_adc_auto` with a bf16 query row as the slot size."""
    rows = GROUPED_ROWS_DEFAULT if rows is None else rows
    if _grouped_wins(queries.shape[0] * tiles.shape[1],
                     vecs.shape[0] // block_t, rows, queries.shape[1] * 2):
        return budget_exact_grouped(queries, vecs, rownorm, tiles,
                                    block_t=block_t, rows=rows)
    return budget_exact(queries, vecs, rownorm, tiles, block_t=block_t)
