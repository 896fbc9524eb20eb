"""Enumerations with string round-trips.

:class:`KernelType` is the JAX package's enum unchanged, so model files and
CLI flags stay interchangeable between the two packages.  The port has its
own :class:`BackendType` and :class:`TargetPlatform`: the JAX enums map
``cuda`` and ``gpu_nvidia`` onto ``automatic``, where here they select the
hand-written CUDA kernels and the NVIDIA device.
"""

from __future__ import annotations

import enum

from .exceptions import UnsupportedBackendError, UnsupportedKernelTypeError


class KernelType(enum.IntEnum):
    """Kernel functions (``kernel_types.hpp:27-34``)."""

    linear = 0
    polynomial = 1
    rbf = 2

    def __str__(self) -> str:  # mirrors operator<< (kernel_types.cpp)
        return self.name

    @classmethod
    def from_string(cls, s: str) -> "KernelType":
        """Parse from a name or integer string, case-insensitively.

        Mirrors ``operator>>(std::istream&, kernel_type&)``
        (``kernel_types.cpp``).
        """
        t = str(s).strip().lower()
        if t in ("linear", "0"):
            return cls.linear
        if t in ("polynomial", "1"):
            return cls.polynomial
        if t in ("rbf", "2"):
            return cls.rbf
        raise UnsupportedKernelTypeError(f"Unrecognized kernel type '{s}'!")


class _ParsedEnum(enum.Enum):
    def __str__(self) -> str:
        return self.value

    @classmethod
    def _parse(cls, s: str, what: str):
        t = str(s).strip().lower()
        for member in cls:
            if member.value == t:
                return member
        raise UnsupportedBackendError(f"Unrecognized {what} '{s}'!")


class BackendType(_ParsedEnum):
    """Compute-path selection (``backend_types.hpp``).

    ``automatic`` resolves to ``cuda`` on an NVIDIA device and to ``torch``
    on the CPU (``CSVM._resolve_backend``)."""

    automatic = "automatic"
    #: plain PyTorch ops on any device (the kernels' plain versions)
    torch = "torch"
    #: the hand-written CUDA kernels of ``csrc/gram_matvec.cu``
    cuda = "cuda"

    @classmethod
    def from_string(cls, s: str) -> "BackendType":
        return cls._parse(s, "backend type")


class TargetPlatform(_ParsedEnum):
    """Hardware target (``target_platforms.hpp``).  ``automatic`` picks
    ``gpu_nvidia`` when a CUDA device is visible, else ``cpu``."""

    automatic = "automatic"
    cpu = "cpu"
    gpu_nvidia = "gpu_nvidia"

    @classmethod
    def from_string(cls, s: str) -> "TargetPlatform":
        return cls._parse(s, "target platform")


def list_available_backends() -> list[BackendType]:
    """Analog of ``list_available_backends`` (``backend_types.cpp:26-44``)."""
    return list(BackendType)


def list_available_target_platforms() -> list[TargetPlatform]:
    """Analog of ``list_available_target_platforms`` (``target_platforms.cpp``)."""
    return list(TargetPlatform)
