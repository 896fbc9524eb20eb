"""Estimator factory (``include/plssvm/csvm_factory.hpp:53-111``): validate
the backend request and construct :class:`~.base.CSVM`, which resolves the
device and backend."""

from __future__ import annotations

from ..exceptions import UnsupportedBackendError
from ..params import Parameter
from ..types import BackendType, list_available_backends
from .base import CSVM


def make_csvm(params: Parameter) -> CSVM:
    if not isinstance(params.backend, BackendType):
        params.backend = BackendType.from_string(str(params.backend))
    if params.backend not in list_available_backends():
        raise UnsupportedBackendError(f"Unrecognized backend type '{params.backend}'!")
    return CSVM(params)
