"""Conjugate gradients with a data-dependent iteration count.

Port of the JAX package's ``solver/cg.py`` (``cg_init``, ``cg_run``,
``cg_solve``, and the adaptive two-tier solve ``cg_run_stagnation`` /
``cg_solve_adaptive``), itself the equivalent of ``gpu_csvm::solver_CG``
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

import os
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


class AdaptiveCGResult(NamedTuple):
    """:class:`CGResult` plus the fast-tier iteration count of the adaptive
    two-tier solve (``fast_iterations == iterations`` means the accurate
    tier was never entered)."""

    x: torch.Tensor
    iterations: int
    delta: torch.Tensor
    delta0: torch.Tensor
    fast_iterations: int


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


def _cg_step(matvec, b, minv, dot, refresh_interval, k, x, r, d, delta):
    """One CG iteration from ``(k, x, r, d, delta)``: returns ``(x, r, d,
    delta_new)``."""
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
    return x, r, d, delta_new


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
        x, r, d, delta = _cg_step(matvec, b, minv, dot, refresh_interval, k, x, r, d, delta)
        k += 1
    return CGState(k=k, x=x, r=r, d=d, delta=delta, delta0=state.delta0)


#: iterations without a >= 10 % residual improvement before the adaptive
#: solve declares the fast tier stagnated
STAGNATION_PATIENCE: int = 8


def _default_patience() -> int:
    """``PLSSVM_CG_STAG_PATIENCE``, else :data:`STAGNATION_PATIENCE` (also
    when the value is not an integer), read when called."""
    try:
        return int(os.environ.get("PLSSVM_CG_STAG_PATIENCE", STAGNATION_PATIENCE))
    except ValueError:
        return STAGNATION_PATIENCE


def cg_run_stagnation(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    state: CGState,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGState:
    """:func:`cg_run` with a stagnation exit (``cg.py:194-270`` of the JAX
    package): the loop also stops when the residual norm has not improved
    on its best-seen value by at least 10 % for ``patience`` consecutive
    iterations, the signature of a matvec whose error floor (a bf16 tier)
    sits above the requested tolerance.  The detector is armed only when the
    target is positive; ``eps = 0`` (pinned-iteration mode) runs exactly
    like :func:`cg_run`.

    The caller tells the exits apart from the returned state:
    ``delta <= eps^2 * delta0`` converged, ``k >= imax`` exhausted, anything
    else stagnated."""
    if patience is None:
        patience = _default_patience()
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps * eps * state.delta0
    armed = bool(target > 0)
    k, x, r, d, delta = state.k, state.x, state.r, state.d, state.delta
    best, since = delta, 0
    while k < imax and bool(delta > target) and not (armed and since >= patience):
        x, r, d, delta = _cg_step(matvec, b, minv, dot, refresh_interval, k, x, r, d, delta)
        improved = bool(delta < 0.9 * best)
        best = torch.minimum(best, delta)
        since = 0 if improved else since + 1
        k += 1
    return CGState(k=k, x=x, r=r, d=d, delta=delta, delta0=state.delta0)


def cg_solve_adaptive(
    matvec_fast: Callable,
    matvec_acc: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> AdaptiveCGResult:
    """Two-tier adaptive solve (``cg.py:273-336`` of the JAX package): CG on
    the cheap ``matvec_fast`` (one bf16 product) until it converges,
    stagnates or exhausts ``imax``; then the residual is verified with
    ``matvec_acc`` (bf16x3, f32-grade) and, if the target is not met, CG
    continues from the current iterate on the accurate tier, within the
    same ``imax``.  The verify step replaces r and d with the accurate
    residual, so a returned ``delta <= eps^2 * delta0`` is always an
    accurate-tier residual.

    ``eps = 0`` pins the iteration count on the fast tier: stagnation,
    verification and escalation all disarm, as in :func:`cg_solve`."""
    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    state = cg_init(matvec_fast, b, mask, minv, dot)
    state = cg_run_stagnation(matvec_fast, b, mask, eps, imax, state, patience=patience,
                              refresh_interval=refresh_interval, minv=minv, dot=dot)
    k_fast = state.k
    eps_t = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps_t * eps_t * state.delta0
    if bool(target > 0):
        # accurate-tier residual at the fast iterate: one matvec
        r = b - matvec_acc(state.x)
        d = r if minv is None else minv * r
        state = CGState(k=state.k, x=state.x, r=r, d=d, delta=dot(r, r), delta0=state.delta0)
        if bool(state.delta > target) and state.k < imax:
            state = cg_run(matvec_acc, b, mask, eps, imax, state, refresh_interval, minv, dot)
    return AdaptiveCGResult(x=state.x, iterations=state.k, delta=state.delta,
                            delta0=state.delta0, fast_iterations=k_fast)
