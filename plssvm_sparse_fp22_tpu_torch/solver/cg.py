"""Conjugate gradients with a data-dependent iteration count.

Port of the JAX package's ``solver/cg.py`` (``cg_init``, ``cg_run``,
``cg_solve``), itself the equivalent of ``gpu_csvm::solver_CG``
(``src/plssvm/backends/gpu_csvm.cpp:186-324``) and
``openmp::csvm::solver_CG`` (``OpenMP/csvm.cpp:82-170``), with the same
semantics:

- start vector ``x = 1`` on the valid entries (``x0 = mask``),
- stop when ``delta <= eps^2 * delta0`` (``gpu_csvm.cpp:293``) or after
  ``imax`` iterations,
- full residual recompute ``r = b - A x`` when ``k % 50 == 49``
  (``OpenMP/csvm.cpp:130-139``),
- ``beta = delta_new / delta_old``, ``d = beta * d + r``; diagonal PCG
  through ``minv``.

The loop is a Python loop that reads ``delta`` on the host every
iteration: one device sync per iteration, and iteration counts equal to
the reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..constants import RESIDUAL_REFRESH_INTERVAL
from ..utils.assertions import plssvm_assert


class CGResult(NamedTuple):
    x: torch.Tensor  # solution on the padded system (padding entries zero)
    iterations: int  # CG iterations executed
    delta: torch.Tensor  # final squared residual norm (0-d)
    delta0: torch.Tensor  # initial squared residual norm (0-d)


class CGState(NamedTuple):
    """Complete CG state between iterations."""

    k: int  # iteration counter
    x: torch.Tensor
    r: torch.Tensor
    d: torch.Tensor
    delta: torch.Tensor
    delta0: torch.Tensor


def _dot(a, b):
    return torch.dot(a, b)


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGResult:
    """Solve ``A x = b`` on the padded system.

    ``b`` and ``mask`` are (D,) with zero padding; ``matvec`` must preserve
    zero padding.  ``minv`` enables diagonal-preconditioned CG; the stopping
    criterion stays on the unpreconditioned residual.  ``dot`` customizes
    the inner product (the JAX package's multi-device learns pass a reduced
    dot)."""
    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    plssvm_assert(minv is None or minv.shape == b.shape,
                  "preconditioner diagonal shape {} != system shape {}",
                  None if minv is None else minv.shape, b.shape)
    state = cg_init(matvec, b, mask, minv, dot)
    state = cg_run(matvec, b, mask, eps, imax, state, refresh_interval, minv, dot)
    return CGResult(x=state.x, iterations=state.k, delta=state.delta, delta0=state.delta0)


def cg_init(matvec: Callable, b: torch.Tensor, mask: torch.Tensor,
            minv: torch.Tensor | None = None, dot: Callable = _dot) -> CGState:
    """Initial CG state: x = 1 on valid entries, r = b - A x
    (``gpu_csvm.cpp:192-223``).  With ``minv``: d0 = M^-1 r0 (PCG)."""
    x0 = mask.to(b.dtype)
    r0 = b - matvec(x0)
    delta0 = dot(r0, r0)
    d0 = r0 if minv is None else minv * r0
    return CGState(k=0, x=x0, r=r0, d=d0, delta=delta0, delta0=delta0)


def cg_run(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    state: CGState,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGState:
    """Continue CG from ``state`` until convergence or ``imax`` total
    iterations.  ``state.delta`` always holds the plain residual ``r.r``."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps * eps * state.delta0
    k, x, r, d, delta = state.k, state.x, state.r, state.d, state.delta
    while k < imax and bool(delta > target):
        Ad = matvec(d)
        # PCG step scalars come from r.z; recomputing r.z from the stored r
        # keeps the state identical for both paths
        rz = delta if minv is None else dot(r, minv * r)
        alpha = rz / dot(d, Ad)
        x = x + alpha * d
        if k % refresh_interval == refresh_interval - 1:
            r = b - matvec(x)
        else:
            r = r - alpha * Ad
        delta_new = dot(r, r)
        if minv is None:
            d = (delta_new / delta) * d + r
        else:
            z = minv * r
            d = (dot(r, z) / rz) * d + z
        delta = delta_new
        k += 1
    return CGState(k=k, x=x, r=r, d=d, delta=delta, delta0=state.delta0)
