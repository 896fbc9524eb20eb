"""Compute ops: kernel functions, the implicit A·v operator, and the fused
Gram-matvec kernels (CUDA) with their plain PyTorch versions."""

from .kernel_functions import gram_block, gram_matrix, kernel_scalar
from .matvec import MatvecOperator, build_operator

__all__ = [
    "gram_block",
    "gram_matrix",
    "kernel_scalar",
    "MatvecOperator",
    "build_operator",
]
