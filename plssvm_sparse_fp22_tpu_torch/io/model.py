"""LIBSVM model file reading and writing (the checkpoint format).

TPU-native equivalent of ``parameter::parse_model_file``
(``src/plssvm/parameter.cpp:366-520``) and ``csvm::write_model``
(``src/plssvm/csvm.cpp:60-204``).  The model file *is* the reference's
checkpoint/resume mechanism (SURVEY.md §5): byte-compatible headers mean the
reference's ``plssvm-predict`` can read models written here and vice versa.

Writer format (``csvm.cpp:93-155``)::

    svm_type c_svc
    kernel_type {linear|polynomial|rbf}
    [degree D / gamma G / coef0 C]      # polynomial
    [gamma G]                           # rbf
    nr_class 2
    total_sv N
    rho R
    label 1 -1
    nr_sv N+ N-
    SV
    {alpha} {idx}:{val:e} ...           # positives first, then negatives;
                                        # zero-valued features skipped

Header parsing accepts entries in any order, is case-insensitive, and
enforces the same validation errors as the reference.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass

import numpy as np

from ..exceptions import InvalidFileFormatError
from ..types import KernelType
from .file_reader import read_bytes
from .fmtlib import fmt_scientific, fmt_shortest
from .libsvm import ParsedData, parse_libsvm_content


@dataclass
class ModelData:
    """Contents of a parsed LIBSVM model file."""

    kernel: KernelType
    rho: float
    support_vectors: ParsedData  # .values holds the raw alphas
    labels: np.ndarray  # per-SV label (+1/-1), from nr_sv counts
    num_sv_pos: int
    num_sv_neg: int
    degree: int | None = None
    gamma: float | None = None
    coef0: float | None = None

    @property
    def alphas(self) -> np.ndarray:
        return self.support_vectors.values


def _kept_lines(content: bytes):
    """``(line, end)`` of every line :func:`~.file_reader.read_lines` keeps
    (leading whitespace stripped; blank and ``#`` lines dropped), in order,
    with ``end`` the byte offset just past the line: the lines one at a
    time, so the header is read without decoding the whole file."""
    pos = 0
    while pos < len(content):
        nl = content.find(b"\n", pos)
        end = len(content) if nl < 0 else nl + 1
        line = content[pos:end - (nl >= 0)].decode("utf-8", errors="replace").lstrip()
        pos = end
        if line and not line.startswith("#"):
            yield line, end


def parse_model_file(filename: str | os.PathLike, dtype=np.float64) -> ModelData:
    """Parse and validate a LIBSVM model file (``parameter.cpp:366-520``).
    The header is read in Python; the support-vector lines natively
    (:func:`~.native.parse_sv_native`) where the port's parser builds and
    takes them, else by :func:`~.libsvm.parse_libsvm_content`, with the
    same result and the same errors."""
    content = read_bytes(filename)
    lines = _kept_lines(content)

    kernel = KernelType.linear
    degree = gamma = coef0 = None
    num_sv = 0
    labels_pair = [0.0, 0.0]
    rho = 0.0
    rho_set = False
    nr_sv_counts: tuple[int, int] | None = None

    sv_offset = None
    for raw, end in lines:
        line = raw.strip().lower()
        # value = text after the first space (parameter.cpp:394-396)
        sep = line.find(" ")
        value = line[sep + 1:].lstrip() if sep >= 0 else ""

        if line.startswith("svm_type"):
            if value != "c_svc":
                raise InvalidFileFormatError(
                    f"Can only use c_svc as svm_type, but '{value}' was given!"
                )
        elif line.startswith("kernel_type"):
            try:
                kernel = KernelType.from_string(value)
            except Exception:
                raise InvalidFileFormatError(f"Unrecognized kernel type '{value}'!") from None
        elif line.startswith("gamma"):
            gamma = _to_float(value)
        elif line.startswith("degree"):
            degree = _to_int(value)
        elif line.startswith("coef0"):
            coef0 = _to_float(value)
        elif line.startswith("nr_class"):
            nr_class = _to_int(value)
            if nr_class != 2:
                raise InvalidFileFormatError(
                    f"Can only use 2 classes, but {nr_class} were given!"
                )
        elif line.startswith("total_sv"):
            num_sv = _to_int(value)
            if num_sv == 0:
                raise InvalidFileFormatError(
                    f"The number of support vectors must be greater than 0, but is {num_sv}!"
                )
        elif line.startswith("rho"):
            rho = _to_float(value)
            rho_set = True
        elif line.startswith("label"):
            parts = value.split()
            if len(parts) != 2:
                raise InvalidFileFormatError(
                    f"Only the labels 1 and -1 are allowed, but '{line}' were given!"
                )
            labels_pair = [_to_float(parts[0]), _to_float(parts[1])]
            if labels_pair[0] not in (1.0, -1.0) or labels_pair[1] not in (1.0, -1.0):
                raise InvalidFileFormatError(
                    f"Only the labels 1 and -1 are allowed, but '{line}' were given!"
                )
        elif line.startswith("nr_sv"):
            parts = value.split()
            if len(parts) != 2:
                raise InvalidFileFormatError(
                    f"Only two numbers are allowed, but more were given '{line}'!"
                )
            n_first, n_second = _to_int(parts[0]), _to_int(parts[1])
            if n_first + n_second != num_sv:
                raise InvalidFileFormatError(
                    f"The number of positive and negative support vectors doesn't add "
                    f"up to the total number: {n_first} + {n_second} != {num_sv}!"
                )
            nr_sv_counts = (n_first, n_second)
        elif line == "sv":
            sv_offset = end
            break
        else:
            raise InvalidFileFormatError(
                f"Unrecognized header entry '{raw}'! Maybe SV is missing?"
            )

    # sanity checks (parameter.cpp:484-499)
    if num_sv == 0:
        raise InvalidFileFormatError("Missing total number of support vectors!")
    if labels_pair[0] == 0.0 or labels_pair[1] == 0.0:
        raise InvalidFileFormatError("Missing labels!")
    if nr_sv_counts is None:
        raise InvalidFileFormatError("Missing number of support vectors per class!")
    if not rho_set:
        raise InvalidFileFormatError("Missing rho value!")

    from .native import parse_sv_native

    parsed = None if sv_offset is None else parse_sv_native(content, sv_offset, num_sv, dtype)
    if parsed is not None:
        csr, alphas = parsed
    else:
        # the reference sizes its arrays by total_sv and reads exactly that
        # many lines (extra lines are ignored, parameter.cpp:502-506)
        sv_lines = [line for line, _ in itertools.islice(lines, num_sv)]
        if not sv_lines:
            raise InvalidFileFormatError(
                "Can't parse file: no support vectors are given or SV is missing!"
            )
        if len(sv_lines) < num_sv:
            raise InvalidFileFormatError(
                f"Expected {num_sv} support vectors, but found only {len(sv_lines)}!"
            )
        csr, alphas, _ = parse_libsvm_content(sv_lines, dtype=dtype)

    labels = np.empty(num_sv, dtype=np.float64)
    labels[: nr_sv_counts[0]] = labels_pair[0]
    labels[nr_sv_counts[0]:] = labels_pair[1]

    return ModelData(
        kernel=kernel,
        rho=rho,
        support_vectors=ParsedData(csr=csr, values=alphas),
        labels=labels,
        num_sv_pos=nr_sv_counts[0],
        num_sv_neg=nr_sv_counts[1],
        degree=degree,
        gamma=gamma,
        coef0=coef0,
    )


def write_model_file(
    filename: str | os.PathLike,
    *,
    kernel: KernelType,
    rho: float,
    data: np.ndarray,
    labels: np.ndarray,
    alphas: np.ndarray,
    degree: int = 3,
    gamma: float = 0.0,
    coef0: float = 0.0,
) -> str:
    """Write a LIBSVM-compatible model file; returns the header string.

    Byte-format parity with ``csvm::write_model`` (``csvm.cpp:93-155``):
    header field order, ``fmt::format("{}")`` float formatting for alphas/rho
    and ``{:e}`` for feature values, zero features skipped, one trailing
    space per line, positives before negatives.

    ``data`` may be a scipy sparse matrix (CSR path: support vectors are
    written row-by-row without densification — the LIBSVM SV format is
    naturally sparse).
    """
    import scipy.sparse as _sp

    sparse_data = _sp.issparse(data)
    if sparse_data:
        data = data.tocsr()
    else:
        data = np.asarray(data)
    labels = np.asarray(labels)
    alphas = np.asarray(alphas)

    pos_mask = labels > 0
    neg_mask = labels < 0
    count_pos = int(pos_mask.sum())
    count_neg = int(neg_mask.sum())

    header = "svm_type c_svc\n" + f"kernel_type {kernel}\n"
    if kernel == KernelType.polynomial:
        header += f"degree {degree}\ngamma {fmt_shortest(gamma)}\ncoef0 {fmt_shortest(coef0)}\n"
    elif kernel == KernelType.rbf:
        header += f"gamma {fmt_shortest(gamma)}\n"
    header += (
        "nr_class 2\n"
        f"total_sv {count_pos + count_neg}\n"
        f"rho {fmt_shortest(rho)}\n"
        "label 1 -1\n"
        f"nr_sv {count_pos} {count_neg}\n"
        "SV\n"
    )

    # fast path: native multi-threaded writer (the analog of the reference's
    # OpenMP thread-local-buffer writer, csvm.cpp:157-195)
    from .native import write_model_native

    order = np.concatenate([np.flatnonzero(pos_mask), np.flatnonzero(neg_mask)])
    if sparse_data:
        csr = data
    else:
        # CSR *view* of the dense rows (zeros are skipped by the writer
        # itself) — avoids scipy's nonzero scan over the full matrix
        dense = np.ascontiguousarray(data, np.float64)
        n_rows, n_feat = dense.shape

        class _DenseAsCSR:
            indptr = np.arange(n_rows + 1, dtype=np.int64) * n_feat
            indices = np.tile(np.arange(n_feat, dtype=np.int32), n_rows)
            data = dense.ravel()

        csr = _DenseAsCSR
    if write_model_native(filename, header, csr, alphas, order):
        return header

    with open(filename, "w") as f:
        f.write(header)
        for mask in (pos_mask, neg_mask):
            for i in np.flatnonzero(mask):
                # reference emits "{alpha} " then "{j}:{v:e} " per nonzero
                # feature (csvm.cpp:144-154)
                if sparse_data:
                    start, end = data.indptr[i], data.indptr[i + 1]
                    pairs = zip(data.indices[start:end], data.data[start:end])
                    features = "".join(
                        f"{j}:{fmt_scientific(float(v))} " for j, v in pairs if v != 0.0
                    )
                else:
                    row = data[i]
                    features = "".join(
                        f"{j}:{fmt_scientific(float(row[j]))} "
                        for j in np.flatnonzero(row != 0.0)
                    )
                f.write(f"{fmt_shortest(float(alphas[i]))} {features}\n")
    return header


def _to_float(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        raise InvalidFileFormatError(f"Can't convert '{text}' to a value!") from None


def _to_int(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        raise InvalidFileFormatError(f"Can't convert '{text}' to a value!") from None
