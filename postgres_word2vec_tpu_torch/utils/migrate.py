"""FREDDY database migration — import/export of Postgres dump files.

The reference's index state lives in 10 Postgres tables (created by
index_creation/vec2database.py:25, pq_index.py:24-29, ivfadc.py:26-34,
ivpq.py:20-58 and written by database_export.py:19-77). This module reads a
dump of those tables — the text files produced by ``COPY <table> TO
'<file>'`` (tab-separated, ``\\N`` nulls, bytea as hex ``\\x…``) or a CSV
equivalent — into a live :class:`Freddy` engine, and writes an engine back
into the same file shapes, so a FREDDY deployment migrates to this
framework (and back) without retraining any quantizer.

Counterpart of ``postgres_word2vec_tpu/utils/migrate.py``: the same dump
format and helpers; :func:`import_engine` builds this package's engine and
indexes on a device (the card unless ``device=`` names another) and the
port's own ``utils/codec.py`` decodes the blobs, so a dump written by
either package imports in the other.

Layout conventions recovered from the reference:

- Row tables (``google_vecs``, ``google_vecs_norm``, ``pq_quantization``,
  ``fine_quantization``, ``fine_quantization_ivpq``) are inserted in vocab
  order with serial ids, so ``id`` order aligns rows across tables
  (pq_index.py:100-110; the C kernels join ``fq.id IN (targets)`` against
  vector-table ids, ivpq_search_in.c:355-401).
- Codebooks are ``(pos, code, vector, count)`` rows, vectors float4 bytea
  (database_export.py:19-31).
- Flat coarse quantizers are ``(id, vector, count)`` with EXPLICIT 0-based
  ids (database_export.py:36-44); multi-index coarse quantizers are
  ``(pos, code, vector)`` plus a dense ``…_counts (id, count)`` table whose
  flat id is ``Σ cᵢ·kᵢ`` (database_export.py:47-77).
- Code rows are int2 bytea (``vec_to_bytea(%s::int2[])``, pq_index.py:106).
- Statistics tables are ``(coarse_id, coarse_freq)`` with one trailing row
  holding the absolute domain count at ``coarse_id == num_cells``
  (freddy--0.0.1.sql:150-171).
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from postgres_word2vec_tpu_torch.utils import codec
from postgres_word2vec_tpu_torch.utils.device import resolve_device

#: role → default FREDDY table name (the ``init`` defaults,
#: freddy--0.0.1.sql:134-148 + index_creation/config/*.json).
DEFAULT_TABLES = {
    "vecs": "google_vecs",
    "vecs_norm": "google_vecs_norm",
    "pq_quantization": "pq_quantization",
    "pq_codebook": "pq_codebook",
    "fine_quantization": "fine_quantization",
    "coarse_quantization": "coarse_quantization",
    "residual_codebook": "residual_codebook",
    "ivpq_quantization": "fine_quantization_ivpq",
    "ivpq_codebook": "codebook_ivpq",
    "ivpq_coarse": "coarse_quantization_ivpq",
    "ivpq_coarse_counts": "coarse_quantization_ivpq_counts",
}

_COPY_UNESCAPE = {"\\": "\\", "t": "\t", "n": "\n", "r": "\r", "b": "\b",
                  "f": "\f", "v": "\v"}
_COPY_ESCAPE = {"\\": "\\\\", "\t": "\\t", "\n": "\\n", "\r": "\\r",
                "\b": "\\b", "\f": "\\f", "\v": "\\v"}


# --------------------------------------------------------------- COPY codec
#: One token of a COPY text line: a field separator, an octal escape (up
#: to three digits), any other escape, a run of plain characters, or a
#: lone backslash at the end of the line.
_COPY_TOKEN = re.compile(r"\t|\\[0-7]{1,3}|\\.|[^\\\t]+|\\", re.S)


def parse_copy_line(line: str) -> list[str | None]:
    """One ``COPY … TO`` text-format line → fields (None for ``\\N``).

    The JAX package's character loop, token by token: a run of plain
    characters (a whole hex bytea body) is one token, so a 300-d vector
    row costs a few tokens, not 2,400 steps. ``\\N`` makes the field NULL
    only where nothing precedes it in the field; an escape not in the
    COPY table stands for its character (``\\8`` → ``8``); a line without
    a backslash is a plain split."""
    if "\\" not in line:
        return line.split("\t")
    fields: list[str | None] = []
    buf: list[str] = []
    is_null = False
    for tok in _COPY_TOKEN.findall(line):
        if tok == "\t":
            fields.append(None if is_null else "".join(buf))
            buf, is_null = [], False
        elif tok[0] != "\\" or len(tok) == 1:
            buf.append(tok)
        elif tok[1] in "01234567":
            buf.append(chr(int(tok[1:], 8)))
        elif tok[1] == "N" and not buf:
            is_null = True
        else:
            buf.append(_COPY_UNESCAPE.get(tok[1], tok[1]))
    fields.append(None if is_null else "".join(buf))
    return fields


def format_copy_field(value) -> str:
    """A value → COPY text field. bytes encode as hex bytea (``\\x…`` with
    the backslash itself COPY-escaped, as Postgres emits)."""
    if value is None:
        return "\\N"
    if isinstance(value, (bytes, bytearray, memoryview)):
        return "\\\\x" + bytes(value).hex()
    s = str(value)
    return "".join(_COPY_ESCAPE.get(c, c) for c in s)


def read_table(path: str | Path) -> list[list[str | None]]:
    """Read a dumped table: ``.copy``/``.tsv``/no-extension → COPY text
    format; ``.csv`` → CSV (header-less, hex bytea as ``\\x…``)."""
    path = Path(path)
    rows: list[list[str | None]] = []
    if path.suffix == ".csv":
        with open(path, newline="") as f:
            for rec in csv.reader(f):
                rows.append([None if v == "" else v for v in rec])
        return rows
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line == "\\.":
                continue
            rows.append(parse_copy_line(line))
    return rows


def write_table(path: str | Path, rows) -> None:
    """Write rows in COPY text format (one line per row)."""
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(format_copy_field(v) for v in row) + "\n")


def _bytea(field: str) -> bytes:
    """A dumped bytea field → raw bytes. COPY hex shows as ``\\x…`` after
    unescaping; CSV dumps may carry the same or plain hex."""
    if field.startswith("\\x"):
        return bytes.fromhex(field[2:])
    if field.startswith("x"):
        return bytes.fromhex(field[1:])
    # escape (octal) bytea output format: already unescaped to raw chars.
    return field.encode("latin-1")


# ----------------------------------------------------------------- readers
def _by_id(rows, id_col: int = 0):
    """Sort rows by their serial id column (dump order is not guaranteed)."""
    return sorted(rows, key=lambda r: int(r[id_col]))


def _vector_table(rows, kind: str) -> tuple[list[str], np.ndarray]:
    """(id, word, vector) rows → (words in id order, (n, d) array)."""
    rows = _by_id(rows)
    words = [r[1] if r[1] is not None else "" for r in rows]
    vecs = codec.decode_vector_column([_bytea(r[2]) for r in rows], kind)
    return words, vecs


def _codebook_table(rows) -> tuple[np.ndarray, np.ndarray]:
    """(id, pos, code, vector, count) rows → ((m, k, dsub), (m, k) counts)."""
    m = max(int(r[1]) for r in rows) + 1
    k = max(int(r[2]) for r in rows) + 1
    dsub = codec.bytes_to_float4(_bytea(rows[0][3])).shape[0]
    cents = np.zeros((m, k, dsub), np.float32)
    counts = np.zeros((m, k), np.int32)
    for r in rows:
        pos, code = int(r[1]), int(r[2])
        cents[pos, code] = codec.bytes_to_float4(_bytea(r[3]))
        counts[pos, code] = int(r[4]) if len(r) > 4 and r[4] is not None else 0
    return cents, counts


def _flat_coarse_table(rows) -> tuple[np.ndarray, np.ndarray]:
    """(id, vector, count) rows with 0-based explicit ids →
    ((C, d) centroids, (C,) counts)."""
    rows = _by_id(rows)
    cents = codec.decode_vector_column([_bytea(r[1]) for r in rows],
                                       "float4")
    counts = np.asarray([int(r[2]) if len(r) > 2 and r[2] is not None else 0
                         for r in rows], np.int32)
    return cents.astype(np.float32), counts


def _multi_coarse_table(rows) -> np.ndarray:
    """(id, pos, code, vector) rows → (positions, k_c, dsub) centroids."""
    p = max(int(r[1]) for r in rows) + 1
    kc = max(int(r[2]) for r in rows) + 1
    dsub = codec.bytes_to_float4(_bytea(rows[0][3])).shape[0]
    cents = np.zeros((p, kc, dsub), np.float32)
    for r in rows:
        cents[int(r[1]), int(r[2])] = codec.bytes_to_float4(_bytea(r[3]))
    return cents


# ------------------------------------------------------------------ import
def import_engine(dump_dir: str | Path, *,
                  tables: dict[str, str] | None = None,
                  exact_dtype: str = "float32",
                  exact_approx: bool = False,
                  device: torch.device | str | None = None):
    """Read a FREDDY dump directory into a :class:`Freddy` engine on
    ``device`` (the card unless another is named; resolved before any
    file is read).

    ``dump_dir`` holds one file per table named ``<table>.copy`` / ``.tsv``
    / ``.csv`` (or bare ``<table>``); ``tables`` overrides role→table names
    (defaults: :data:`DEFAULT_TABLES`). The normalized vector table is
    required; each index family is loaded iff its tables are present.
    Codebooks and codes are taken VERBATIM — no retraining — so search
    results match the originating FREDDY instance's quantizer.
    """
    from postgres_word2vec_tpu_torch.api import Freddy
    from postgres_word2vec_tpu_torch.models.ivfadc import (CoarseQuantizer,
                                                           IVFADCIndex)
    from postgres_word2vec_tpu_torch.models.ivpq import (IVPQIndex,
                                                         MultiIndexQuantizer)
    from postgres_word2vec_tpu_torch.models.pq import PQCodebook, PQIndex
    from postgres_word2vec_tpu_torch.store import VectorStore

    device = resolve_device(device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype),
                               device=device)

    dump_dir = Path(dump_dir)
    names = dict(DEFAULT_TABLES, **(tables or {}))

    def find(role: str) -> Path | None:
        base = names[role]
        for suffix in (".copy", ".tsv", ".csv", ""):
            p = dump_dir / f"{base}{suffix}"
            if p.exists():
                return p
        return None

    norm_path = find("vecs_norm")
    if norm_path is None:
        raise FileNotFoundError(
            f"required table {names['vecs_norm']!r} not found in {dump_dir}")
    words, norm = _vector_table(read_table(norm_path), "float4")
    raw_path = find("vecs")
    if raw_path is not None:
        words_raw, raw = _vector_table(read_table(raw_path), "float4")
        if words_raw != words:
            raise ValueError("google_vecs / google_vecs_norm word order "
                             "mismatch — inconsistent dump")
    else:
        raw = norm
    store = VectorStore(list(words), {w: i for i, w in enumerate(words)},
                        dev(raw, np.float32), dev(norm, np.float32))

    pq = None
    pq_codes_path, pq_cb_path = find("pq_quantization"), find("pq_codebook")
    if pq_codes_path is not None and pq_cb_path is not None:
        cents, counts = _codebook_table(read_table(pq_cb_path))
        w2, codes = _vector_table(read_table(pq_codes_path), "int2")
        _check_words(w2, words, names["pq_quantization"])
        pq = PQIndex(PQCodebook(dev(cents), dev(counts)),
                     dev(_narrow_codes(codes, cents.shape[1])))

    ivfadc = None
    f_path, c_path, r_path = (find("fine_quantization"),
                              find("coarse_quantization"),
                              find("residual_codebook"))
    if f_path is not None and c_path is not None and r_path is not None:
        cents, counts = _codebook_table(read_table(r_path))
        coarse_c, coarse_n = _flat_coarse_table(read_table(c_path))
        rows = _by_id(read_table(f_path))       # (id, coarse_id, word, codes)
        assign = np.asarray([int(r[1]) for r in rows], np.int32)
        _check_words([r[2] if r[2] is not None else "" for r in rows],
                     words, names["fine_quantization"])
        codes = codec.decode_vector_column([_bytea(r[3]) for r in rows],
                                           "int2")
        ivfadc = IVFADCIndex._assemble(
            CoarseQuantizer(dev(coarse_c), dev(coarse_n)),
            PQCodebook(dev(cents), dev(counts)),
            dev(_narrow_codes(codes, cents.shape[1])), dev(assign, np.int64))

    ivpq = None
    q_path, b_path, m_path = (find("ivpq_quantization"),
                              find("ivpq_codebook"), find("ivpq_coarse"))
    if q_path is not None and b_path is not None and m_path is not None:
        cents, counts = _codebook_table(read_table(b_path))
        coarse_c = _multi_coarse_table(read_table(m_path))
        num_cells = coarse_c.shape[1] ** coarse_c.shape[0]
        rows = _by_id(read_table(q_path))       # (id, coarse_id, codes)
        cell_of = np.asarray([int(r[1]) for r in rows], np.int32)
        codes = codec.decode_vector_column([_bytea(r[2]) for r in rows],
                                           "int2")
        cc_path = find("ivpq_coarse_counts")
        if cc_path is not None:
            crows = _by_id(read_table(cc_path))
            cell_counts = np.asarray([int(r[1]) for r in crows], np.int32)
        else:
            cell_counts = np.bincount(cell_of, minlength=num_cells).astype(
                np.int32)
        ivpq = IVPQIndex(
            MultiIndexQuantizer(dev(coarse_c), dev(cell_counts)),
            PQCodebook(dev(cents), dev(counts)),
            dev(_narrow_codes(codes, cents.shape[1])), dev(cell_of, np.int64))

    eng = Freddy(store, pq=pq, ivfadc=ivfadc, ivpq=ivpq,
                 exact_dtype=exact_dtype, exact_approx=exact_approx)
    # reference-style statistics dumps (stat_<table>_<column>) ...
    for stat_path in sorted(dump_dir.glob("stat_*")):
        stats = _read_statistics(stat_path)
        eng.statistics[stat_path.name.split(".")[0]] = dev(stats)
    # ... and this framework's own exports, which carry ARBITRARY
    # statistics-table names under the reserved "stats." prefix —
    # exporting them as bare <name>.copy silently dropped any table not
    # named stat_* on the round trip.
    for stat_path in sorted(dump_dir.glob("stats.*.copy")):
        name = stat_path.name[len("stats."):-len(".copy")]
        eng.statistics[name] = dev(_read_statistics(stat_path))
    return eng


def _read_statistics(path: Path) -> np.ndarray:
    """A ``stat_<t>_<c>`` dump (coarse_id, coarse_freq; trailing row =
    absolute count) → the kernel's ``(C + 1,)`` statistics vector."""
    rows = read_table(path)
    cells = np.asarray([int(r[0]) for r in rows])
    freqs = np.asarray([float(r[1]) for r in rows], np.float32)
    num_cells = cells.max()  # the total row sits at coarse_id == C
    out = np.zeros((num_cells + 1,), np.float32)
    out[cells] = freqs
    return out


def _check_words(got: Sequence[str], expected: Sequence[str],
                 table: str) -> None:
    """Validate row/vocab alignment where the dump carries words. The
    reference truncates words to 100 chars on insert (pq_index.py:103)."""
    if len(got) != len(expected):
        raise ValueError(f"{table}: {len(got)} rows vs {len(expected)} "
                         "vocabulary words")
    for g, e in zip(got, expected):
        if g and g != e[:100]:
            raise ValueError(f"{table}: word {g!r} does not match "
                             f"vocabulary {e!r} — row order mismatch")


def _narrow_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """int2 dump codes → the framework's storage dtype (uint8 iff k ≤ 256)."""
    codes = codes.astype(np.int32)
    if codes.size and (codes.min() < 0 or codes.max() >= k):
        raise ValueError(f"code out of range for k={k}")
    return codes.astype(np.uint8 if k <= 256 else np.int16)


# ------------------------------------------------------------------ export
def export_engine(engine, dump_dir: str | Path, *,
                  tables: dict[str, str] | None = None) -> None:
    """Write an engine's state as a FREDDY dump directory (COPY text files,
    one per table) — the reverse of :func:`import_engine`; a FREDDY
    instance restores them with ``COPY <table> FROM '<file>'``.

    OPQ-rotated PQ indexes cannot be represented (the reference has no
    rotation stage); exporting one raises.
    """
    dump_dir = Path(dump_dir)
    dump_dir.mkdir(parents=True, exist_ok=True)
    names = dict(DEFAULT_TABLES, **(tables or {}))
    store = engine.store
    n = store.size

    def path(role: str) -> Path:
        return dump_dir / f"{names[role]}.copy"

    raw = _np(store.vectors)
    norm = _np(store.vectors_norm)
    write_table(path("vecs"),
                [(i + 1, w[:100], codec.vec_to_bytes(raw[i]))
                 for i, w in enumerate(store.words)])
    write_table(path("vecs_norm"),
                [(i + 1, w[:100], codec.vec_to_bytes(norm[i]))
                 for i, w in enumerate(store.words)])

    if engine.pq is not None:
        if engine.pq.rotation is not None:
            raise ValueError("cannot export an OPQ-rotated PQ index to "
                             "FREDDY (no rotation stage in the reference); "
                             "rebuild with opq_iters=0 to export")
        _write_codebook(path("pq_codebook"), engine.pq.codebook)
        codes = _np(engine.pq.codes)
        write_table(path("pq_quantization"),
                    [(i + 1, store.words[i][:100],
                      codec.vec_to_bytes(codes[i], "int2"))
                     for i in range(n)])

    if engine.ivfadc is not None:
        ivf = engine.ivfadc.flush()   # tail rows must land in the CSR
        _write_codebook(path("residual_codebook"), ivf.codebook)
        cq = _np(ivf.coarse.centroids)
        cn = _np(ivf.coarse.counts)
        write_table(path("coarse_quantization"),
                    [(i, codec.vec_to_bytes(cq[i]), int(cn[i]))
                     for i in range(cq.shape[0])])
        # original row order: invert the CSR sort.
        order = _np(ivf.row_ids)
        codes = np.empty_like(_np(ivf.codes_sorted))
        codes[order] = _np(ivf.codes_sorted)
        assign = _np(ivf.assignments)
        write_table(path("fine_quantization"),
                    [(i + 1, int(assign[i]), store.words[i][:100],
                      codec.vec_to_bytes(codes[i], "int2"))
                     for i in range(codes.shape[0])])

    if engine.ivpq is not None:
        ivpq = engine.ivpq
        _write_codebook(path("ivpq_codebook"), ivpq.codebook)
        mc = _np(ivpq.coarse.centroids)
        rows = [(p * mc.shape[1] + c + 1, p, c,
                 codec.vec_to_bytes(mc[p, c]))
                for p in range(mc.shape[0]) for c in range(mc.shape[1])]
        write_table(path("ivpq_coarse"), rows)
        counts = _np(ivpq.coarse.cell_counts)
        write_table(path("ivpq_coarse_counts"),
                    [(i, int(counts[i])) for i in range(counts.shape[0])])
        codes = _np(ivpq.codes)
        cell_of = _np(ivpq.cell_of)
        write_table(path("ivpq_quantization"),
                    [(i + 1, int(cell_of[i]),
                      codec.vec_to_bytes(codes[i], "int2"))
                     for i in range(n)])

    for name, stats in engine.statistics.items():
        s = _np(stats)
        rows = [(i, float(s[i])) for i in range(s.shape[0])]
        # reserved "stats." prefix: import_engine only recognizes
        # reference-style stat_* names otherwise, so a bare <name>.copy
        # would be silently dropped on re-import.
        write_table(dump_dir / f"stats.{name}.copy", rows)


def _write_codebook(path: Path, codebook) -> None:
    cents = _np(codebook.centroids)
    counts = _np(codebook.counts)
    m, k, _ = cents.shape
    rows = [(pos * k + code + 1, pos, code,
             codec.vec_to_bytes(cents[pos, code]), int(counts[pos, code]))
            for pos in range(m) for code in range(k)]
    write_table(path, rows)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
