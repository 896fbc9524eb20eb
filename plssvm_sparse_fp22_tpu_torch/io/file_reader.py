"""Whole-file line ingestion with comment skipping.

TPU-native equivalent of ``plssvm::detail::file_reader``
(``include/plssvm/detail/file_reader.hpp:30-90``,
``src/plssvm/detail/file_reader.cpp:34-154``): reads the entire file in one
go (the reference mmaps when possible; Python's buffered one-shot read of the
bytes object is the same single-copy ingest), splits it into lines, strips
leading whitespace, and drops blank lines and lines starting with the comment
character.  Inline comments are *not* stripped — parity with
``file_reader::parse_lines`` (``file_reader.cpp:129-152``).
"""

from __future__ import annotations

import os

from ..exceptions import FileNotFoundError_


def read_bytes(filename: str | os.PathLike) -> bytes:
    """Read the whole file; raise :class:`FileNotFoundError_` when absent.

    Mirrors ``file_reader::open_file`` (``file_reader.cpp:103-127``).
    """
    try:
        with open(filename, "rb") as f:
            return f.read()
    except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
        raise FileNotFoundError_(f"Couldn't find file: '{os.fspath(filename)}'!") from None


def read_lines(filename: str | os.PathLike, comment: str) -> list[str]:
    """Split file content into trimmed, non-empty, non-comment lines.

    Mirrors ``file_reader::parse_lines`` (``file_reader.cpp:129-152``): only
    *leading* whitespace is trimmed and only lines whose first non-blank
    character is ``comment`` are dropped.
    """
    content = read_bytes(filename).decode("utf-8", errors="replace")
    lines: list[str] = []
    for raw in content.split("\n"):
        line = raw.lstrip()
        if line and not line.startswith(comment):
            lines.append(line)
    return lines
