"""Exception hierarchy with captured source location.

TPU-native equivalent of the reference exception subsystem
(``include/plssvm/exceptions/exceptions.hpp:26-118`` and
``include/plssvm/exceptions/source_location.{hpp,cpp}``): a common base class
that records where it was raised and can render a ``what_with_loc``-style
message, plus one subclass per error category.  Backend-specific exception
classes (one per reference backend, e.g.
``include/plssvm/backends/CUDA/exceptions.hpp``) collapse into a single
:class:`BackendError` because XLA is the only backend here.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass


@dataclass(frozen=True)
class SourceLocation:
    """Python analog of ``plssvm::source_location`` (``source_location.hpp``)."""

    function_name: str = "unknown"
    file_name: str = "unknown"
    line: int = 0
    column: int = 0

    @staticmethod
    def current(depth: int = 2) -> "SourceLocation":
        """Capture the caller's frame (``source_location::current``)."""
        try:
            frame = inspect.stack()[depth]
            return SourceLocation(
                function_name=frame.function, file_name=frame.filename, line=frame.lineno
            )
        except Exception:  # pragma: no cover - stack inspection best effort
            return SourceLocation()


class PLSSVMError(Exception):
    """Base exception (``plssvm::exception``, ``exceptions.hpp:26-68``).

    Stores the error message together with the :class:`SourceLocation` where it
    was raised; :meth:`what_with_loc` mirrors ``exception::what_with_loc()``.
    """

    #: human-readable class name used in ``what_with_loc`` output
    class_name = "exception"

    def __init__(self, msg: str, loc: SourceLocation | None = None) -> None:
        super().__init__(msg)
        self.loc = loc if loc is not None else SourceLocation.current(depth=2)

    def what_with_loc(self) -> str:
        return (
            f"{self.args[0]}\n"
            f"{self.class_name} thrown:\n"
            f"  in file      {self.loc.file_name}\n"
            f"  in function  {self.loc.function_name}\n"
            f"  @ line       {self.loc.line}"
        )


class InvalidParameterError(PLSSVMError):
    """Invalid parameter combinations (ctor validation, ``csvm.cpp:41-57``)."""

    class_name = "invalid_parameter_exception"


class FileNotFoundError_(PLSSVMError):
    """``plssvm::file_not_found_exception`` (``exceptions.hpp:70-82``)."""

    class_name = "file_not_found_exception"


class InvalidFileFormatError(PLSSVMError):
    """``plssvm::invalid_file_format_exception`` (``exceptions.hpp:84-96``)."""

    class_name = "invalid_file_format_exception"


class UnsupportedBackendError(PLSSVMError):
    """``plssvm::unsupported_backend_exception`` (``exceptions.hpp:98-106``)."""

    class_name = "unsupported_backend_exception"


class UnsupportedKernelTypeError(PLSSVMError):
    """``plssvm::unsupported_kernel_type_exception`` (``exceptions.hpp:108-118``)."""

    class_name = "unsupported_kernel_type_exception"


class BackendError(PLSSVMError):
    """Runtime backend failure (per-backend ``backend_exception`` classes)."""

    class_name = "backend_exception"
