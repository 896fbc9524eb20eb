"""Implicit kernel-matrix x vector product — the hot op of the CG solver.

Port of the JAX package's ``ops/matvec.py``.  The implicit matrix is

    A_ij = K_ij + QA_cost - q_i - q_j + (1/C) * delta_ij

over the first ``dept = n - 1`` points, applied as

    A v = K v + (QA_cost * sum(v) - q.v) * mask - sum(v) * q + (1/C) * v

with ``mask`` zeroing padding rows, so the O(n^2) work is a pure Gram
matvec.  Three modes:

- ``linear``   — K v = X (X^T v): two matrix products.
- ``cached``   — K assembled once (masked), one GEMV per iteration.
- ``implicit`` — K recomputed every iteration: kernel K1 on the ``cuda``
  backend at float32 (K2 with ``PLSSVM_PALLAS_SYMMETRIC=0``), the plain
  blocked version on the ``torch`` backend and for float64
  (:func:`uses_kernels`).

``linear`` and ``implicit`` run at a precision tier (``exact``, ``bf16x3``,
``bf16cast``; ``ops/gram_matvec.py``).  :func:`resolve_mxu_plan` decides
whether a learn runs the adaptive two-tier CG, which builds the operator at
two tiers (``solver/cg.cg_solve_adaptive``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch

from ..constants import ROW_BLOCK_SIZE
from ..exceptions import PLSSVMError
from ..types import BackendType, KernelType
from ..utils.assertions import plssvm_assert
from .gram_matvec import (PRECISION_TIERS, gram_matvec, gram_matvec_sym_plain, make_sym_matvec,
                          pallas_tier, resolve_tier, row_sqnorms, tier_matmul, tier_operands)
from .kernel_functions import gram_block, kernel_diag


def _k_cache_budget_bytes() -> int:
    # provisional: the JAX package's v5e-derived default, not yet measured
    # on the H100
    return int(os.environ.get("PLSSVM_K_CACHE_BYTES", 8 * 1024**3))


def symmetric_enabled() -> bool:
    return os.environ.get("PLSSVM_PALLAS_SYMMETRIC", "1") not in ("0", "off", "false")


def _implicit_feature_cutoff() -> int:
    """Feature width up to which the ``cuda`` backend recomputes the Gram
    matrix (``implicit``) rather than caching K.  Provisional: 320/160 is
    the JAX package's crossover, derived from v5e rates; the H100's own
    crossover has not been measured.  With the symmetric kernel disabled the
    implicit path does twice the work, so the default cutoff halves; a set
    ``PLSSVM_IMPLICIT_FEATURE_CUTOFF`` is honoured verbatim."""
    env = os.environ.get("PLSSVM_IMPLICIT_FEATURE_CUTOFF")
    if env is not None:
        return int(env)
    return 320 if symmetric_enabled() else 160


def tier_precision(name: str) -> str:
    """Map a tier name of the plan to its kernel tier (``_TIER_PRECISION``,
    ``matvec.py:73-83`` of the JAX package; the map is
    :data:`~.gram_matvec.PRECISION_TIERS`)."""
    return PRECISION_TIERS[name]


def resolve_mxu_plan(mode: str, dtype: torch.dtype,
                     backend: BackendType | None) -> tuple[str, str] | None:
    """Adaptive precision plan for a learn: ``(fast_tier, acc_tier)`` when
    the adaptive two-tier CG applies, else ``None`` (one fixed tier)
    (``matvec.py:86-111`` of the JAX package, with the ``cuda`` backend in
    the place of a TPU).

    On the ``cuda`` backend the plan is the default for float32 ``implicit``
    systems: CG starts on one bf16 tensor-core product and escalates to the
    bf16x3 tier only if the accurate-tier residual misses the target.
    ``PLSSVM_MATMUL_PRECISION`` set to a fixed tier (``highest`` / ``high``
    / ``default``) disables the plan; ``adaptive`` forces it on any backend
    (the ``torch`` backend then runs the plain versions at both tiers, with
    real bf16 rounding).  ``cached`` mode is bound by reading K and float64
    needs exact products, so neither takes the plan.

    The ``linear`` mode takes the plan only under ``adaptive``, where the
    JAX package plans it by default (``matvec.py:109-111``): its tiers are
    PyTorch products of bf16 parts upcast to float32, which move and
    compute as much as the exact tier, so the plan costs accuracy and gains
    no time on the card."""
    name = os.environ.get("PLSSVM_MATMUL_PRECISION", "").lower()
    if name not in ("", "adaptive"):
        return None  # explicitly pinned tier
    if dtype != torch.float32 or mode not in ("implicit", "linear"):
        return None
    if name != "adaptive" and (backend != BackendType.cuda or mode == "linear"):
        return None  # exact products, or bf16 parts that gain nothing: nothing to adapt
    return ("default", "high")


def uses_kernels(backend: BackendType | None, dtype: torch.dtype) -> bool:
    """Whether a Gram product runs the hand kernels: on the ``cuda`` backend
    at float32, the counterpart of the JAX package's ``use_pallas_impl``
    (``matvec.py:256-258``).  float64 and the ``torch`` backend run the
    plain blocked product instead (on the card its GEMM is a float64
    ``torch.matmul``), as the JAX package computes float64 outside Pallas;
    the kernels have no float64 version."""
    return backend == BackendType.cuda and dtype == torch.float32


def fixed_tier(backend: BackendType) -> str:
    """The tier of a learn outside the plan: the kernels' fixed tier
    (:func:`~.gram_matvec.pallas_tier`, ``highest`` unless
    ``PLSSVM_MATMUL_PRECISION`` says otherwise) on the ``cuda`` backend,
    ``exact`` on the ``torch`` backend, whose products stand in for the JAX
    package's exact XLA ones."""
    return pallas_tier() if backend == BackendType.cuda else "exact"


def choose_mode(kernel: KernelType, dept: int, dtype: torch.dtype,
                num_features: int | None = None,
                backend: BackendType | None = None, budget_scale: int = 1) -> str:
    """Pick the execution mode (``matvec.py:113-135`` of the JAX package).
    float64 keeps the exact cached GEMV while K fits the budget: the CUDA
    kernels are float32 only.  ``budget_scale`` multiplies the K-cache
    budget (the sharded learn splits the cached K over that many devices)."""
    if kernel == KernelType.linear:
        return "linear"
    if (
        backend == BackendType.cuda
        and num_features is not None
        and num_features <= _implicit_feature_cutoff()
        and dtype.itemsize <= 4
    ):
        return "implicit"
    if dept * dept * dtype.itemsize <= _k_cache_budget_bytes() * budget_scale:
        return "cached"
    return "implicit"


def choose_sharded_mode(kernel: KernelType, dept: int, dtype: torch.dtype, ndev: int,
                        num_features: int | None = None,
                        backend: BackendType | None = None) -> str:
    """Mode selection for the row-sharded multi-device learn: one policy
    (:func:`choose_mode`) with the K-cache budget applied per device."""
    return choose_mode(kernel, dept, dtype, num_features=num_features, backend=backend,
                       budget_scale=ndev)


def jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv):
    """Inverse diagonal of the implicit matrix from the kernel diagonal:
    A_ii = K_ii + QA_cost - 2 q_i + 1/C (``svm_kernel.cu:67-83``, i = j)."""
    diag = kii + QA_cost - 2.0 * q + cost_inv
    # A is SPD so diag > 0; guard against FP underflow on degenerate rows
    tiny = torch.finfo(kii.dtype).tiny
    return mask / torch.clamp(diag, min=tiny)


def jacobi_minv(kernel, X_pad, q, mask, QA_cost, cost_inv, degree, gamma, coef0, sq=None):
    """:func:`jacobi_minv_from_kii` with ``kii`` computed from dense rows
    (``sq``: their squared norms, where the caller has them)."""
    sq = row_sqnorms(X_pad) if sq is None else sq
    kii = kernel_diag(kernel, sq, degree, gamma, coef0)
    return jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)


@dataclass
class MatvecOperator:
    """A v callable plus the scalars the CG solver needs."""

    matvec: Callable  # (v: (D,)) -> (D,)
    q: torch.Tensor  # (D,) padded with zeros
    mask: torch.Tensor  # (D,) 1.0 on the first dept entries
    QA_cost: torch.Tensor  # scalar
    cost_inv: torch.Tensor  # scalar
    mode: str


def _corrections(Kv, v, q, mask, QA_cost, cost_inv):
    """Fold the rank-1 + diagonal corrections (``svm_kernel.cu:67-83``).
    ``mask * Kv`` keeps padding at zero: rbf rows against zero padding are
    ``exp(-gamma |x|^2) != 0``, so Kv itself is not zero there."""
    s = torch.sum(v)
    t = torch.dot(q, v)
    return mask * Kv + (QA_cost * s - t) * mask - s * q + cost_inv * v


def build_operator(
    kernel: KernelType,
    X_pad: torch.Tensor,  # (D, f): first dept rows are data, rest zero
    q: torch.Tensor,  # (D,) zero-padded
    mask: torch.Tensor,  # (D,)
    QA_cost,
    cost_inv,
    *,
    degree: int = 3,
    gamma: float = 1.0,
    coef0: float = 0.0,
    mode: str | None = None,
    backend: BackendType = BackendType.torch,
    row_block: int = ROW_BLOCK_SIZE,
    precision: str | None = None,
    sq: torch.Tensor | None = None,
    operands: tuple | None = None,
) -> MatvecOperator:
    """Construct the implicit-A matvec for the padded system.

    ``backend=cuda`` needs the tensors on a CUDA device and runs the
    float32 ``implicit`` mode through the hand kernels; float64 runs the
    blocked plain product on the device (:func:`uses_kernels`).
    ``precision`` is the tier of the ``linear`` / ``implicit`` Gram
    products (``exact``, ``bf16x3``, ``bf16cast``; the adaptive CG builds
    the operator at two);  ``None`` keeps the backend's fixed tier
    (:func:`fixed_tier`).  The ``implicit`` mode takes the row norms ``sq``
    and the tier's ``operands`` (:func:`~.gram_matvec.tier_operands`) where
    the caller has prepared them once for all its operators, else prepares
    its own."""
    D, f = X_pad.shape
    plssvm_assert(q.shape == (D,) and mask.shape == (D,),
                  "operator vectors must match the padded system: q {} mask {} D {}",
                  tuple(q.shape), tuple(mask.shape), D)
    dtype, device = X_pad.dtype, X_pad.device
    QA_cost = torch.as_tensor(QA_cost, dtype=dtype, device=device)
    cost_inv = torch.as_tensor(cost_inv, dtype=dtype, device=device)
    if backend == BackendType.cuda and not X_pad.is_cuda:
        raise PLSSVMError(f"backend 'cuda' needs the system on a CUDA device, "
                          f"got {device}")
    if mode is None:
        dept = int(mask.sum().item())
        mode = choose_mode(kernel, dept, dtype, num_features=f, backend=backend)
    tier = resolve_tier(fixed_tier(backend) if precision is None else precision, dtype)

    if mode == "linear":
        if kernel != KernelType.linear:
            raise ValueError("mode='linear' requires the linear kernel")
        # the JAX package leaves these two products to XLA at the tier's
        # precision (matvec.py:232-235): plain PyTorch products here, on
        # bf16-rounded or split operands with f32 sums at a bf16 tier; X's
        # parts are upcast once (bf16 values are exact in float32)
        Xo = tier_operands(tier, X_pad, pad=False)
        if tier != "exact":
            Xo = tuple(t.float() for t in Xo)
        XoT = tuple(t.T for t in Xo)

        def matvec(v):
            # K v = X (X^T v): two products, never materializes K
            u = tier_matmul(tier, XoT, tier_operands(tier, v))
            Kv = tier_matmul(tier, Xo, tier_operands(tier, u))
            return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    elif mode == "cached":
        K = gram_block(kernel, X_pad, X_pad, degree, gamma, coef0)
        # zero the padding rows/cols once so the per-iteration GEMV needs no
        # masking of its own
        K = K * (mask[:, None] * mask[None, :])

        def matvec(v):
            return _corrections(K @ v, v, q, mask, QA_cost, cost_inv)

    elif mode == "implicit":
        sq = row_sqnorms(X_pad) if sq is None else sq
        Xo = tier_operands(tier, X_pad) if operands is None else operands  # split or cast once
        if uses_kernels(backend, dtype):
            if symmetric_enabled():
                kv_fn = make_sym_matvec(kernel, X_pad, degree=degree, gamma=gamma,
                                        coef0=coef0, tier=tier, sq=sq, operands=Xo)
            else:

                def kv_fn(v):
                    return gram_matvec(kernel, X_pad, v, degree=degree, gamma=gamma,
                                       coef0=coef0, sqx=sq, sqy=sq, tier=tier,
                                       operands=(Xo, Xo))
        else:
            # the blocked product over ROW_BLOCK_SIZE rows, the JAX package's
            # lax.map block_fn (matvec.py:286-305)

            def kv_fn(v):
                return gram_matvec_sym_plain(kernel, X_pad, v, degree=degree,
                                             gamma=gamma, coef0=coef0, sq=sq,
                                             row_block=row_block, tier=tier, operands=Xo)

        def matvec(v):
            return _corrections(kv_fn(v), v, q, mask, QA_cost, cost_inv)

    else:
        raise ValueError(f"unknown matvec mode '{mode}'")

    # the name a failed CUDA-graph capture of its CG step reports
    # (solver/cg.py)
    matvec.__qualname__ = f"build_operator[{mode}, {tier}, {dtype}]"
    return MatvecOperator(matvec=matvec, q=q, mask=mask, QA_cost=QA_cost,
                          cost_inv=cost_inv, mode=mode)
