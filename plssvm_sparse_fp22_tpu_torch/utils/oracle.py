"""Pure-numpy LS-SVM reference implementation (the correctness oracle).

Plays the role of the reference's sequential comparison kernels
(``tests/backends/compare.{hpp,cpp}``): an independent, easily-auditable
implementation of the exact LS-SVM semantics that the PyTorch learns and
the CUDA kernels are tested against: a copy of the JAX package's
``utils/oracle.py`` typed with this package's ``KernelType``.  It is also a
usable (slow) CPU solver.

Math (SURVEY.md §3.1, ``csvm.cpp:207-267``, ``gpu_csvm.cpp:186-324``,
``svm_kernel.cu:17-88``): with ``n`` data points, the system has dimension
``dept = n - 1``.  Let ``K`` be the kernel matrix over the first ``dept``
points, ``q_i = k(x_i, x_last)``, ``QA_cost = k(x_last, x_last) + 1/C``.
The implicit matrix is::

    A_ij = K_ij + QA_cost - q_i - q_j + (1/C) * delta_ij

CG solves ``A x = b`` with ``b_i = y_i - y_last``, start ``x = 1``, stopping
at ``delta <= eps^2 * delta0`` with a full residual recompute every 50
iterations, capped at ``num_features`` iterations.  Afterwards
``bias = y_last + QA_cost * sum(x) - q.x`` and ``alpha_last = -sum(x)``
(``csvm.cpp:257-258``).
"""

from __future__ import annotations

import numpy as np

from ..types import KernelType


def kernel_function(
    kernel: KernelType, xi: np.ndarray, xj: np.ndarray, degree=3, gamma=1.0, coef0=0.0
) -> float:
    """Scalar kernel (``kernel_types.hpp:69-84``)."""
    xi = np.asarray(xi, dtype=np.float64)
    xj = np.asarray(xj, dtype=np.float64)
    if kernel == KernelType.linear:
        return float(xi @ xj)
    if kernel == KernelType.polynomial:
        return float((gamma * (xi @ xj) + coef0) ** degree)
    if kernel == KernelType.rbf:
        d = xi - xj
        return float(np.exp(-gamma * (d @ d)))
    raise ValueError(f"unknown kernel {kernel}")


def kernel_matrix(
    kernel: KernelType, X: np.ndarray, Y: np.ndarray, degree=3, gamma=1.0, coef0=0.0
) -> np.ndarray:
    """Dense kernel matrix K[i, j] = k(X[i], Y[j])."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    G = X @ Y.T
    if kernel == KernelType.linear:
        return G
    if kernel == KernelType.polynomial:
        return (gamma * G + coef0) ** degree
    if kernel == KernelType.rbf:
        sq = (X * X).sum(1)[:, None] + (Y * Y).sum(1)[None, :] - 2.0 * G
        return np.exp(-gamma * np.maximum(sq, 0.0))
    raise ValueError(f"unknown kernel {kernel}")


def generate_q(kernel: KernelType, X: np.ndarray, degree=3, gamma=1.0, coef0=0.0) -> np.ndarray:
    """q_i = k(x_i, x_last) for i < n-1 (``q_kernel.cu:16-49``)."""
    return kernel_matrix(kernel, X[:-1], X[-1:], degree, gamma, coef0)[:, 0]


def implicit_matvec(
    kernel: KernelType,
    X: np.ndarray,
    q: np.ndarray,
    QA_cost: float,
    cost_inv: float,
    v: np.ndarray,
    degree=3,
    gamma=1.0,
    coef0=0.0,
) -> np.ndarray:
    """A @ v without materializing A's rank-1 corrections.

    ``A v = K v + QA_cost*sum(v)*1 - sum(v)*q - (q.v)*1 + cost_inv*v``,
    matching ``device_kernel_linear``'s per-element
    ``(K_ij + QA_cost - q_i - q_j) + delta_ij/C`` (``svm_kernel.cu:67-83``).
    """
    K = kernel_matrix(kernel, X[:-1], X[:-1], degree, gamma, coef0)
    s = v.sum()
    t = q @ v
    return K @ v + QA_cost * s - s * q - t + cost_inv * v


def solve_lssvm(
    X: np.ndarray,
    y: np.ndarray,
    kernel: KernelType = KernelType.linear,
    degree: int = 3,
    gamma: float = 1.0,
    coef0: float = 0.0,
    cost: float = 1.0,
    epsilon: float = 0.001,
    max_iter: int | None = None,
) -> tuple[np.ndarray, float, dict]:
    """Full learn(): returns (alpha[n], bias, info dict).

    CG semantics follow ``OpenMP/csvm.cpp:82-170`` (including the correct
    ``r = b - A x`` refresh, which the multi-GPU path of the reference
    mis-implements by skipping device 0, ``gpu_csvm.cpp:272-283``).
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, num_features = X.shape
    dept = n - 1
    cost_inv = 1.0 / cost

    q = generate_q(kernel, X, degree, gamma, coef0)
    b = y[:-1] - y[-1]
    QA_cost = kernel_function(kernel, X[-1], X[-1], degree, gamma, coef0) + cost_inv
    imax = max_iter if max_iter is not None else num_features

    K = kernel_matrix(kernel, X[:-1], X[:-1], degree, gamma, coef0)

    def matvec(v):
        s = v.sum()
        t = q @ v
        return K @ v + QA_cost * s - s * q - t + cost_inv * v

    x = np.ones(dept)
    r = b - matvec(x)
    delta = r @ r
    delta0 = delta
    d = r.copy()
    iters = 0
    residuals = [delta]

    for run in range(imax):
        Ad = matvec(d)
        alpha_cd = delta / (d @ Ad)
        x = x + alpha_cd * d
        if run % 50 == 49:
            r = b - matvec(x)
        else:
            r = r - alpha_cd * Ad
        delta_old = delta
        delta = r @ r
        iters = run + 1
        residuals.append(delta)
        if delta <= epsilon * epsilon * delta0:
            break
        beta = delta / delta_old
        d = beta * d + r

    bias = y[-1] + QA_cost * x.sum() - q @ x
    alpha = np.concatenate([x, [-x.sum()]])
    info = {"iterations": iters, "delta": delta, "delta0": delta0, "residuals": residuals}
    return alpha, bias, info


def predict_values(
    X_sv: np.ndarray,
    alphas: np.ndarray,
    bias: float,
    points: np.ndarray,
    kernel: KernelType = KernelType.linear,
    degree: int = 3,
    gamma: float = 1.0,
    coef0: float = 0.0,
) -> np.ndarray:
    """f(p) = sum_i alpha_i k(x_i, p) + bias (``OpenMP/csvm.cpp:191-244``)."""
    K = kernel_matrix(kernel, np.asarray(points), np.asarray(X_sv), degree, gamma, coef0)
    return K @ np.asarray(alphas) + bias
