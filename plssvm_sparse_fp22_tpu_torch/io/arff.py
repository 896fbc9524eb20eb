"""ARFF file parsing (dense and sparse rows).

TPU-native equivalent of ``parameter::parse_arff_file``
(``src/plssvm/parameter.cpp:180-363``).  Behavioral parity:

- header: ``@RELATION`` ignored; every ``@ATTRIBUTE`` must contain
  ``NUMERIC`` (case-insensitive); an attribute containing ``CLASS`` marks the
  label column and must be the *last* attribute; ``@DATA`` ends the header,
- errors: no attributes, no data rows, ``@`` inside the data section,
  missing closing ``}`` on sparse rows, feature index out of range, missing
  label on a labeled sparse row, wrong dense field count, superfluous fields,
- sparse rows are ``{idx value, idx value, ...}`` with the label at index
  ``num_attributes - 1`` when a CLASS attribute exists,
- labels are mapped through ``sign`` *during* parsing
  (``parameter.cpp:285,313``) — unlike the LIBSVM parser.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from ..exceptions import InvalidFileFormatError
from .file_reader import read_lines
from .libsvm import ParsedData, _convert_float, _convert_index


def parse_arff_file(filename: str | os.PathLike, dtype=np.float64) -> ParsedData:
    # native (C++ mmap + multi-threaded) fast path, the analog of the
    # reference's OpenMP-parallel ARFF parse; Python below is the oracle
    try:
        from .native import parse_arff_native

        result = parse_arff_native(os.fspath(filename), dtype=dtype)
    except ImportError:  # pragma: no cover
        result = None
    if result is not None:
        csr, labels = result
        return ParsedData(csr=csr, values=labels)

    lines = read_lines(filename, "%")

    # --- header (parameter.cpp:195-228) ---
    num_attributes = 0
    has_label = False
    header_end = None
    for lineno, line in enumerate(lines):
        upper = line.upper()
        if upper.startswith("@RELATION"):
            continue
        elif upper.startswith("@ATTRIBUTE"):
            if "NUMERIC" not in upper:
                raise InvalidFileFormatError(
                    f"Can only use NUMERIC features, but '{line}' was given!"
                )
            if has_label:
                raise InvalidFileFormatError("Only the last ATTRIBUTE may be CLASS!")
            if "CLASS" in upper:
                has_label = True
            num_attributes += 1
        elif upper.startswith("@DATA"):
            header_end = lineno
            break

    if num_attributes == 0:
        raise InvalidFileFormatError("Can't parse file: no ATTRIBUTES are defined!")
    if header_end is None or header_end + 1 >= len(lines):
        raise InvalidFileFormatError(
            "Can't parse file: no data points are given or @DATA is missing!"
        )

    data_lines = lines[header_end + 1:]
    num_features = num_attributes - 1 if has_label else num_attributes
    n = len(data_lines)
    dense = np.zeros((n, num_features), dtype=dtype)
    values = np.zeros(n, dtype=np.float64)

    for i, line in enumerate(data_lines):
        if line.startswith("@"):
            raise InvalidFileFormatError(f"Read @ inside data section!: '{line}'")

        if line.startswith("{"):
            # --- sparse row (parameter.cpp:256-298) ---
            if not line.rstrip().endswith("}"):
                raise InvalidFileFormatError(
                    f"Missing closing '}}' for sparse data point {i} description!"
                )
            body = line.rstrip()[1:-1]
            is_class_set = False
            for entry in body.split(","):
                entry = entry.strip()
                if not entry:
                    continue
                parts = entry.split(None, 1)
                if len(parts) != 2:
                    raise InvalidFileFormatError(
                        f"Invalid sparse entry '{entry}' for data point {i}!"
                    )
                index = _convert_index(parts[0])
                if index >= num_attributes:
                    raise InvalidFileFormatError(
                        f"Too many features given! Trying to add feature at position "
                        f"{index} but max position is {num_features - 1}!"
                    )
                value = _convert_float(parts[1], "real_type")
                if has_label and index == num_attributes - 1:
                    is_class_set = True
                    values[i] = 1.0 if value > 0 else -1.0
                else:
                    dense[i, index] = value
            if has_label and not is_class_set:
                raise InvalidFileFormatError(f"Missing label for data point {i}!")
        else:
            # --- dense row (parameter.cpp:299-322) ---
            fields = line.split(",")
            if len(fields) < num_attributes:
                raise InvalidFileFormatError(
                    f"Invalid number of features/labels! Found {len(fields) - 1} "
                    f"but should be {num_attributes - 1}!"
                )
            if len(fields) > num_attributes:
                extra = ",".join(fields[num_attributes:])
                raise InvalidFileFormatError(
                    f"Too many features! Superfluous '{extra}' for data point {i}!"
                )
            for j in range(num_features):
                dense[i, j] = _convert_float(fields[j].strip(), "real_type")
            if has_label:
                label = _convert_float(fields[-1].strip(), "real_type")
                values[i] = 1.0 if label > 0 else -1.0

    csr = sp.csr_matrix(dense)
    return ParsedData(csr=csr, values=values if has_label else None, _dense=dense)


def write_arff_file(
    filename: str | os.PathLike,
    data: np.ndarray,
    labels: np.ndarray | None = None,
) -> None:
    """Write a dense ARFF file (the data-generator's second output format)."""
    from .fmtlib import fmt_shortest

    data = np.asarray(data)
    with open(filename, "w") as f:
        f.write("@RELATION generated\n\n")
        for j in range(data.shape[1]):
            f.write(f"@ATTRIBUTE feature_{j} NUMERIC\n")
        if labels is not None:
            f.write("@ATTRIBUTE class NUMERIC\n")
        f.write("\n@DATA\n")
        for i in range(data.shape[0]):
            fields = [fmt_shortest(float(v)) for v in data[i]]
            if labels is not None:
                fields.append(fmt_shortest(float(labels[i])))
            f.write(",".join(fields) + "\n")
