"""LIBSVM file parsing (dense + sparse) and writing.

TPU-native equivalent of ``plssvm::detail::parse_libsvm_content`` /
``parameter::parse_libsvm_file`` (``src/plssvm/parameter.cpp:41-176``) with
one capability *extension*: the parsed data is retained natively as CSR
(``scipy.sparse``) in addition to the densified matrix the reference always
produces (``include/plssvm/parameter.hpp:51-75`` "the parsed output is
always in a dense format").  The CSR form feeds the sparse kernel-matvec
path, which is the capability gap the fork name ("Sparse") promises
(SURVEY.md §0).

Behavioral parity notes (``parameter.cpp:41-116``):

- a line whose first token contains ``:`` has no label; if *any* line lacks a
  label the whole file is treated as unlabeled (the reference sets the
  ``values[0] = max()`` sentinel for any unlabeled line),
- the number of features is ``max feature index + 1`` over all lines,
- a file with no ``index:value`` pairs at all raises
  :class:`InvalidFileFormatError` ("no data points are given"),
- parsing of a line stops at the first token without a ``:`` (which is how
  the reference tolerates trailing inline comments),
- labels are mapped through ``sign`` (+1 if > 0 else -1,
  ``operators.hpp:174-177``) by :func:`parse_libsvm_file`, **not** by the
  low-level content parser (model files reuse the content parser for raw
  alpha values, ``parameter.cpp:506``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..exceptions import InvalidFileFormatError
from .file_reader import read_lines
from .fmtlib import fmt_shortest


@dataclass
class ParsedData:
    """Result of parsing a LIBSVM/ARFF data file.

    ``csr`` is the natively retained sparse form; ``dense`` densifies on
    demand (and is cached).  ``values`` holds raw parsed values (labels or
    alphas) or ``None`` when the file is unlabeled.
    """

    csr: sp.csr_matrix
    values: np.ndarray | None
    _dense: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_points(self) -> int:
        return self.csr.shape[0]

    @property
    def num_features(self) -> int:
        return self.csr.shape[1]

    @property
    def dense(self) -> np.ndarray:
        if self._dense is None:
            rows = self.stored_rows()
            self._dense = self.csr.toarray() if rows is None else rows.copy()
        return self._dense

    def stored_rows(self) -> np.ndarray | None:
        """The dense rows without a copy where they are stored already: the
        dense matrix once made, or the CSR's values where the CSR holds
        every entry of every row once, in column order (a dense file's
        parse), which is then ``csr.toarray()`` bit for bit; else None."""
        if self._dense is not None:
            return self._dense
        csr = self.csr
        n, f = csr.shape
        if (csr.nnz != n * f or n * f == 0
                or not np.array_equal(csr.indptr, np.arange(n + 1) * f)
                or not csr.has_canonical_format):
            return None
        return csr.data.reshape(n, f)

    @property
    def density(self) -> float:
        total = self.csr.shape[0] * self.csr.shape[1]
        return float(self.csr.nnz) / total if total else 0.0


def _convert_float(text: str, what: str) -> float:
    try:
        return float(text)
    except ValueError:
        raise InvalidFileFormatError(f"Can't convert '{text}' to a value of type {what}!") from None


def _convert_index(text: str) -> int:
    try:
        idx = int(text)
    except ValueError:
        raise InvalidFileFormatError(
            f"Can't convert '{text}' to a value of type unsigned long!"
        ) from None
    if idx < 0:
        raise InvalidFileFormatError(f"Can't convert '{text}' to a value of type unsigned long!")
    return idx


def parse_libsvm_content(
    lines: list[str], dtype=np.float64
) -> tuple[sp.csr_matrix, np.ndarray, bool]:
    """Parse LIBSVM ``[label] idx:val ...`` lines into CSR + values.

    Equivalent of ``detail::parse_libsvm_content`` (``parameter.cpp:41-116``)
    with the densification replaced by CSR assembly.  Returns
    ``(csr, raw_values, any_unlabeled)``.
    """
    n = len(lines)
    values = np.zeros(n, dtype=np.float64)
    any_unlabeled = False

    indptr = np.zeros(n + 1, dtype=np.int64)
    col_chunks: list[list[int]] = []
    val_chunks: list[list[float]] = []
    max_index = -1

    for i, line in enumerate(lines):
        tokens = line.split()
        start = 0
        if tokens and ":" not in tokens[0]:
            values[i] = _convert_float(tokens[0], "real_type")
            start = 1
        else:
            any_unlabeled = True

        cols: list[int] = []
        vals: list[float] = []
        for tok in tokens[start:]:
            idx_text, sep, val_text = tok.partition(":")
            if not sep:
                # first token without ':' ends the data section of this line
                # (tolerates trailing inline comments, parameter.cpp:67-70)
                break
            idx = _convert_index(idx_text)
            vals.append(_convert_float(val_text, "real_type"))
            cols.append(idx)
            if idx > max_index:
                max_index = idx
        col_chunks.append(cols)
        val_chunks.append(vals)
        indptr[i + 1] = indptr[i] + len(cols)

    if max_index < 0:
        raise InvalidFileFormatError("Can't parse file: no data points are given!")

    col_arr = np.concatenate([np.asarray(c, dtype=np.int64) for c in col_chunks]) if n else np.zeros(0, np.int64)
    val_arr = np.concatenate([np.asarray(v, dtype=dtype) for v in val_chunks]) if n else np.zeros(0, dtype)
    return assemble_csr(val_arr, col_arr, indptr, max_index, dtype), values, any_unlabeled


def assemble_csr(val_arr: np.ndarray, col_arr: np.ndarray, indptr: np.ndarray,
                 max_index: int, dtype) -> sp.csr_matrix:
    """The CSR matrix of parsed lines: ``val_arr`` (in ``dtype``) and the
    int64 ``col_arr`` in line order, ``indptr`` per line, ``max_index + 1``
    columns; a repeated index within a line keeps its last value."""
    n = len(indptr) - 1
    # duplicate indices within a line: last one wins in the reference's dense
    # write (vline[index] = v); CSR assembly would sum them, so deduplicate.
    if not _no_repeats(col_arr, indptr, max_index + 1):
        return _dedup_last_wins(val_arr, col_arr, indptr, (n, max_index + 1), dtype)
    csr = sp.csr_matrix((val_arr, col_arr, indptr), shape=(n, max_index + 1), dtype=dtype)
    csr.sort_indices()
    csr.has_canonical_format = True  # sorted, no repeats: spares scipy the scan
    return csr


def _no_repeats(cols: np.ndarray, indptr: np.ndarray, ncols: int) -> bool:
    """Whether no line repeats a column index: one pass where every line's
    indices rise (as the writers write them), else a sort of all
    ``(line, column)`` keys."""
    rising = cols[1:] > cols[:-1]
    starts = indptr[1:-1]
    rising[starts[(starts > 0) & (starts < len(cols))] - 1] = True
    if rising.all():
        return True
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    keys = rows * np.int64(ncols) + cols
    return len(np.unique(keys)) == len(keys)


def _dedup_last_wins(vals, cols, indptr, shape, dtype) -> sp.csr_matrix:
    """Rebuild CSR keeping only the last value per (row, col) pair."""
    new_cols: list[np.ndarray] = []
    new_vals: list[np.ndarray] = []
    new_indptr = np.zeros(len(indptr), dtype=np.int64)
    for i in range(shape[0]):
        c = cols[indptr[i]:indptr[i + 1]]
        v = vals[indptr[i]:indptr[i + 1]]
        if len(c):
            # keep last occurrence of each column index
            _, last_idx = np.unique(c[::-1], return_index=True)
            keep = len(c) - 1 - last_idx
            keep.sort()
            c, v = c[keep], v[keep]
        new_cols.append(c)
        new_vals.append(v)
        new_indptr[i + 1] = new_indptr[i] + len(c)
    cols2 = np.concatenate(new_cols) if new_cols else np.zeros(0, np.int64)
    vals2 = np.concatenate(new_vals) if new_vals else np.zeros(0, dtype)
    out = sp.csr_matrix((vals2, cols2, new_indptr), shape=shape, dtype=dtype)
    out.sort_indices()
    out.has_canonical_format = True
    return out


def parse_libsvm_file(filename: str | os.PathLike, dtype=np.float64) -> ParsedData:
    """Parse a LIBSVM data file; labels are mapped through ``sign``.

    Equivalent of ``parameter::parse_libsvm_file`` (``parameter.cpp:132-176``)
    minus the gamma/filename bookkeeping, which lives in
    :class:`~plssvm_sparse_fp22_tpu_torch.params.Parameter`.

    Uses the native (C++ mmap + multi-threaded) parser when available — the
    analog of the reference's OpenMP-parallel parse — falling back to the
    pure-Python implementation.
    """
    result = None
    try:
        from .native import parse_libsvm_native

        result = parse_libsvm_native(os.fspath(filename), dtype=dtype)
    except ImportError:  # pragma: no cover
        result = None
    if result is not None:
        csr, raw_values, any_unlabeled = result
        # duplicate (row, col) entries need last-wins semantics that CSR
        # assembly can't express; defer those rare files to the Python parser
        if _no_repeats(csr.indices, csr.indptr, csr.shape[1] + 1):
            csr.has_canonical_format = True  # sorted, no repeats
            if any_unlabeled:
                values = None
            else:
                values = np.where(raw_values > 0, 1.0, -1.0).astype(np.float64)
            return ParsedData(csr=csr, values=values)

    lines = read_lines(filename, "#")
    csr, raw_values, any_unlabeled = parse_libsvm_content(lines, dtype=dtype)
    if any_unlabeled:
        values = None
    else:
        values = np.where(raw_values > 0, 1.0, -1.0).astype(np.float64)
    return ParsedData(csr=csr, values=values)


def write_libsvm_file(
    filename: str | os.PathLike,
    data: np.ndarray,
    labels: np.ndarray | None = None,
    *,
    sparse: bool = True,
) -> None:
    """Write a LIBSVM data file (used by the data generator and tests)."""
    data = np.asarray(data)
    with open(filename, "w") as f:
        for i in range(data.shape[0]):
            parts = []
            if labels is not None:
                parts.append(fmt_shortest(float(labels[i])))
            for j in range(data.shape[1]):
                v = float(data[i, j])
                if not sparse or v != 0.0:
                    parts.append(f"{j}:{fmt_shortest(v)}")
            f.write(" ".join(parts) + "\n")
