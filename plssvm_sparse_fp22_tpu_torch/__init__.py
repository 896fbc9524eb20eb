"""PLSSVM on PyTorch and CUDA: the port of the JAX package
``plssvm_sparse_fp22_tpu`` to an NVIDIA GPU.

Binary C-SVC trained by solving the LS-SVM linear system with Conjugate
Gradients, linear / polynomial / RBF kernels, LIBSVM and ARFF data files
and LIBSVM-compatible model files (byte-compatible with the JAX package's),
``plssvm-train-torch`` / ``plssvm-predict-torch`` CLIs and a library API.
The Gram-matrix x vector products of training and prediction run as
hand-written CUDA kernels (``csrc/gram_matvec.cu``) on the ``cuda`` backend
and as plain PyTorch on the ``torch`` backend.

Public surface mirrors the JAX package's (``include/plssvm/core.hpp``).
"""

from .exceptions import (
    BackendError,
    FileNotFoundError_,
    InvalidFileFormatError,
    InvalidParameterError,
    PLSSVMError,
    UnsupportedBackendError,
    UnsupportedKernelTypeError,
)
from .models import CSVM, csvm_from_state, make_csvm
from .params import Parameter
from .types import (
    BackendType,
    KernelType,
    TargetPlatform,
    list_available_backends,
    list_available_target_platforms,
)
from .version import VERSION as __version__

__all__ = [
    "CSVM",
    "make_csvm",
    "csvm_from_state",
    "Parameter",
    "KernelType",
    "BackendType",
    "TargetPlatform",
    "list_available_backends",
    "list_available_target_platforms",
    "PLSSVMError",
    "InvalidParameterError",
    "FileNotFoundError_",
    "InvalidFileFormatError",
    "UnsupportedBackendError",
    "UnsupportedKernelTypeError",
    "BackendError",
    "__version__",
]
