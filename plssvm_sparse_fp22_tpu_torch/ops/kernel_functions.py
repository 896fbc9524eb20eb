"""Kernel functions (linear, polynomial, RBF) as plain torch ops.

Port of the JAX package's ``ops/kernel_functions.py``: the element-wise
transforms of ``plssvm::kernel_function`` (``kernel_types.hpp:69-84``) are
applied to Gram blocks produced by one matrix product.  RBF uses the norm
expansion ``|x-y|^2 = |x|^2 + |y|^2 - 2<x,y>`` clamped at 0; the polynomial
kernel uses an integer power by repeated squaring, as ``lax.integer_pow``.

Products run in exact float32 (the JAX package's ``PRECISION = HIGHEST``):
TF32 is switched off for matmuls and cuDNN when this module is imported.
"""

from __future__ import annotations

import torch

from ..types import KernelType

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for an integer ``y`` by binary exponentiation — the
    multiplication order of ``lax.integer_pow``, so results match the JAX
    package bit for bit where the base does."""
    if y == 0:
        return torch.ones_like(x)
    recip = y < 0
    y = -y if recip else y
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def kernel_scalar(kernel: KernelType, xi, xj, degree=3, gamma=1.0, coef0=0.0):
    """k(xi, xj) for single vectors (used for QA_cost, ``csvm.cpp:243``)."""
    dot = torch.dot(xi, xj)
    if kernel == KernelType.linear:
        return dot
    if kernel == KernelType.polynomial:
        return integer_pow(gamma * dot + coef0, int(degree))
    if kernel == KernelType.rbf:
        diff = xi - xj
        return torch.exp(-gamma * torch.dot(diff, diff))
    raise ValueError(f"unknown kernel {kernel}")


def kernel_diag(kernel: KernelType, sq, degree=3, gamma=1.0, coef0=0.0):
    """Kernel-matrix diagonal ``k(x_i, x_i)`` from squared norms."""
    if kernel == KernelType.linear:
        return sq
    if kernel == KernelType.polynomial:
        return integer_pow(gamma * sq + coef0, int(degree))
    if kernel == KernelType.rbf:
        return torch.ones_like(sq)
    raise ValueError(f"unknown kernel {kernel}")


def gram_block(kernel: KernelType, Xi, Xj, degree=3, gamma=1.0, coef0=0.0,
               Xi_sqnorm=None, Xj_sqnorm=None):
    """K[a, b] = k(Xi[a], Xj[b]) for row blocks Xi (m, f), Xj (n, f).

    For RBF, pass precomputed squared norms to avoid recomputing them per
    block."""
    if kernel == KernelType.rbf:
        if Xi_sqnorm is None:
            Xi_sqnorm = torch.sum(Xi * Xi, dim=1)
        if Xj_sqnorm is None:
            Xj_sqnorm = torch.sum(Xj * Xj, dim=1)
    return kernel_transform(kernel, Xi @ Xj.T, degree, gamma, coef0, Xi_sqnorm, Xj_sqnorm)


def kernel_transform(kernel: KernelType, G, degree=3, gamma=1.0, coef0=0.0,
                     Xi_sqnorm=None, Xj_sqnorm=None):
    """The element-wise transform of a Gram block ``G[a, b] = <xi_a, xj_b>``;
    rbf needs the rows' squared norms."""
    if kernel == KernelType.linear:
        return G
    if kernel == KernelType.polynomial:
        return integer_pow(gamma * G + coef0, int(degree))
    if kernel == KernelType.rbf:
        sq = Xi_sqnorm[:, None] + Xj_sqnorm[None, :] - 2.0 * G
        return torch.exp(-gamma * torch.clamp(sq, min=0.0))
    raise ValueError(f"unknown kernel {kernel}")


def gram_matrix(kernel: KernelType, X, Y=None, degree=3, gamma=1.0, coef0=0.0):
    """Full kernel matrix K[i, j] = k(X[i], Y[j]) (Y defaults to X)."""
    if Y is None:
        Y = X
    return gram_block(kernel, X, Y, degree, gamma, coef0)
