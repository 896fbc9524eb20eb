"""Multi-device LS-SVM training: row-sharded A·v under one CG.

The dense, row-sharded half of the JAX package's ``parallel/sharded.py``.
The reference splits the *feature* axis across devices for the linear
kernel only (``gpu_csvm.cpp:130-157``) and pins polynomial/RBF to one GPU
(``CUDA/csvm.cu:61-63``); here the *row* axis of the padded system is cut
into ``p`` equal blocks over a mesh (``parallel/mesh.py``: a list of
``torch.device``, one entry per shard) and **one process drives every
device**, as the reference does.  A mesh may name one device several times:
its shards are then logical, which is how the sharded learns run on the CPU
and how several ring shards run on one card.

Where the vectors live: the data matrix, the largest thing by far, is
sharded; the CG vectors (``x, r, d, b, q, mask``: D floats each) are held
whole on the mesh's first device, the *home* device, as the reference holds
them once per device.  Only A·v is sharded: v is copied to every device,
each shard computes its rows of K·v, and the rows are gathered on the home
device, where the rank-1 corrections and the BLAS-1 of CG run.  Every
reduction over shards (the CG dot products, ``sum(v)``, the ``linear``
mode's ``X^T v``) adds the shards' partials in shard order, so a result
does not depend on timing and two runs agree bitwise.

The three modes of A·v:

- **linear**: ``K v = X (X^T v)``: each shard computes the partial
  feature-space product ``X_loc^T v_loc``, the ``p`` partials (f floats
  each) are reduced on the home device and sent back, the row product is
  local.  Traffic per A·v is O(f + D), independent of the data's size.
- **cached**: each shard holds a ``(D/p, D)`` slab of K, assembled once
  against the gathered data; one GEMV against the gathered v per A·v.
- **implicit (ring)**: each shard holds only its ``(D/p, f)`` row block.
  At step ``s`` shard ``i`` multiplies its rows against the block of shard
  ``(i - s) mod p`` and adds ``K(X_i, X_j) v_j`` to its rows' sum.  On the
  ``cuda`` backend every such hop is kernel K2 (``ops/gram_matvec.py``) at
  the operator's precision tier; on the ``torch`` backend, and for
  float64, its plain version.  A block that lies on another device is
  copied into the shard's one receive buffer on side streams (two row
  blocks per shard at most), ordered against the hops by events; the
  tier's operands (``tier_operands``) are prepared once per operator and
  are what travels.  K is never held.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..exceptions import PLSSVMError
from ..ops.gram_matvec import (gram_matvec, gram_matvec_plain, resolve_tier, row_sqnorms,
                               tier_matmul, tier_operands)
from ..ops.kernel_functions import gram_block, kernel_diag, kernel_scalar
from ..ops.matvec import fixed_tier, jacobi_minv_from_kii, tier_precision
from ..solver.cg import CGState, cg_init, cg_run, cg_solve, cg_solve_adaptive
from ..types import BackendType, KernelType


def _psum(parts):
    """Sum of the shards' partials (tensors on one device), in shard order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _psum_dot(a, b, num: int):
    """Deterministic sharded dot: one partial per row block, summed in
    shard order."""
    return _psum([torch.dot(ai, bi) for ai, bi in zip(a.chunk(num), b.chunk(num))])


def _local_corrections(Kv, v, q, mask, QA_cost, cost_inv, num: int):
    """Rank-1 + diagonal corrections with the two scalars reduced over the
    shards: the sharded twin of ``ops/matvec._corrections``."""
    s = _psum([c.sum() for c in v.chunk(num)])
    t = _psum_dot(q, v, num)
    return mask * Kv + (QA_cost * s - t) * mask - s * q + cost_inv * v


def _devices(mesh) -> list:
    """The distinct devices of a mesh, in order of first appearance."""
    return list(dict.fromkeys(mesh))


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _scatter(v: torch.Tensor, mesh) -> dict:
    """``v`` on every device of the mesh."""
    return {dev: _to(v, dev) for dev in _devices(mesh)}


def _gather(parts, home) -> torch.Tensor:
    """The shards' row slices joined on the home device."""
    return torch.cat([_to(part, home) for part in parts])


class _Ring:
    """The row blocks of an ``implicit`` operator and their way around the
    mesh: what a hop reads of block ``j`` (its tier operands and row norms)
    as shard ``i`` sees it."""

    def __init__(self, mesh, blocks):
        self.mesh, self.blocks = mesh, blocks
        p = len(mesh)
        self.recv = [None] * p   # one receive buffer per shard, made at first use
        self.free = [None] * p   # event: the last hop that read the buffer is done
        self.side = {}
        for dev in _devices(mesh):
            if dev.type == "cuda" and len(_devices(mesh)) > 1:
                # the copies' streams start after the operands are prepared
                self.side[dev] = torch.cuda.Stream(device=dev)
                self.side[dev].wait_stream(torch.cuda.current_stream(dev))

    def fetch(self, i: int, j: int):
        """Block ``j`` for shard ``i``: the owner's tensors where both lie
        on one device, else a copy into shard ``i``'s receive buffer."""
        src, dst = self.mesh[j], self.mesh[i]
        if src == dst:
            return self.blocks[j]
        ops, sq = self.blocks[j]
        if self.recv[i] is None:
            self.recv[i] = (tuple(torch.empty_like(t, device=dst) for t in ops),
                            torch.empty_like(sq, device=dst))
            if dst in self.side:
                # the allocator may hand out memory that earlier work on the
                # compute stream still reads
                self.side[dst].wait_stream(torch.cuda.current_stream(dst))
        buf = self.recv[i]
        pairs = list(zip((*buf[0], buf[1]), (*ops, sq)))
        if dst not in self.side or src not in self.side:
            for t_dst, t_src in pairs:
                t_dst.copy_(t_src)
            return buf
        side_src, side_dst = self.side[src], self.side[dst]
        with torch.cuda.stream(side_src), torch.cuda.stream(side_dst):
            if self.free[i] is not None:
                side_dst.wait_event(self.free[i])
            for t_dst, t_src in pairs:
                t_dst.copy_(t_src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side_dst)
        torch.cuda.current_stream(dst).wait_event(ready)
        return buf

    def release(self, i: int, block) -> None:
        """Called after the hop that read ``block`` is queued."""
        if block is self.recv[i] and self.mesh[i] in self.side:
            self.free[i] = torch.cuda.Event()
            self.free[i].record(torch.cuda.current_stream(self.mesh[i]))


def _build_local_matvec(kernel, mesh, Xs, q, mask, QA_cost, cost_inv, degree, gamma, coef0,
                        mode, K_locs=None, backend: BackendType = BackendType.torch,
                        precision: str | None = None):
    """A·v of the sharded system: ``v`` (D,) on the home device -> ``A v``
    there, the Gram product computed shard by shard.

    ``precision`` is the tier of the per-iteration products (``linear`` and
    ``implicit`` modes; ``None``: the backend's fixed tier) — the adaptive
    two-tier CG builds the same matvec at two tiers, as the single-device
    ``build_operator`` does."""
    p, home = len(mesh), mesh[0]
    dtype = Xs[0].dtype
    m = Xs[0].shape[0]
    tier = resolve_tier(fixed_tier(backend) if precision is None else precision, dtype)

    def corrections(Kv, v):
        return _local_corrections(Kv, v, q, mask, QA_cost, cost_inv, p)

    if mode == "linear":
        if kernel != KernelType.linear:
            raise ValueError("mode='linear' requires the linear kernel")
        # as the single-device operator: plain products on the tier's operands,
        # the bf16 parts upcast once
        Xo = [tier_operands(tier, X, pad=False) for X in Xs]
        if tier != "exact":
            Xo = [tuple(t.float() for t in ops) for ops in Xo]
        XoT = [tuple(t.T for t in ops) for ops in Xo]

        def matvec(v):
            v_on = _scatter(v, mesh)
            parts = [tier_matmul(tier, XoT[i], tier_operands(tier, v_on[dev][i * m:(i + 1) * m]))
                     for i, dev in enumerate(mesh)]
            # the one reduction of f floats, then u back to every device
            u = _psum([_to(part, home) for part in parts])
            uo_on = {dev: tier_operands(tier, u_dev) for dev, u_dev in _scatter(u, mesh).items()}
            Kv = _gather([tier_matmul(tier, Xo[i], uo_on[dev]) for i, dev in enumerate(mesh)],
                         home)
            return corrections(Kv, v)

    elif mode == "cached":

        def matvec(v):
            v_on = _scatter(v, mesh)
            Kv = _gather([K_locs[i] @ v_on[dev] for i, dev in enumerate(mesh)], home)
            return corrections(Kv, v)

    elif mode == "implicit":
        # float64 hops take the plain product on either backend: the kernels
        # are float32 only
        use_kernel = backend == BackendType.cuda and dtype == torch.float32
        hop_fn = gram_matvec if use_kernel else gram_matvec_plain
        sq = [row_sqnorms(X) for X in Xs]
        ops = [tier_operands(tier, X) for X in Xs]  # split or cast once per operator
        ring = _Ring(mesh, list(zip(ops, sq)))
        kw = {"degree": degree, "gamma": gamma, "coef0": coef0, "tier": tier}

        def matvec(v):
            v_on = _scatter(v, mesh)
            acc = [None] * p
            for s in range(p):
                for i, dev in enumerate(mesh):
                    j = (i - s) % p
                    block = ring.fetch(i, j)
                    # K(X_i, X_j) v_j from the operands alone: the float32 rows
                    # of block j need not travel at a bf16 tier
                    hop = hop_fn(kernel, Xs[i], v_on[dev][j * m:(j + 1) * m], sqx=sq[i],
                                 sqy=block[1], operands=(ops[i], block[0]), **kw)
                    ring.release(i, block)
                    acc[i] = hop if acc[i] is None else acc[i] + hop
            return corrections(_gather(acc, home), v)

    else:
        raise ValueError(f"unknown sharded matvec mode '{mode}'")

    return matvec


def _check_system(mesh, Xs, backend) -> None:
    if len(Xs) != len(mesh):
        raise ValueError(f"{len(Xs)} row blocks for a mesh of {len(mesh)} shards")
    for X, dev in zip(Xs, mesh):
        if X.device != dev or X.shape != Xs[0].shape:
            raise ValueError("the row blocks must be equal in shape and lie on their mesh "
                             f"devices (shard_system): got {tuple(X.shape)} on {X.device}, "
                             f"expected {tuple(Xs[0].shape)} on {dev}")
    if backend == BackendType.cuda and any(dev.type != "cuda" for dev in mesh):
        raise PLSSVMError(f"backend 'cuda' needs the system on CUDA devices, got {mesh}")


def _prepare_local(kernel, mesh, Xs, x_last, mask, gamma, coef0, cost, degree, mode,
                   backend, precond, precision=None):
    """Shared set-up of every sharded learn variant (full / setup / chunk):
    the q-vector, QA_cost, the A·v and the optional Jacobi diagonal, so there
    is one operator construction, mirroring the single ``build_operator`` of
    the one-device path.  ``precision`` is the matvec's tier (q, QA_cost and
    the cached K stay exact)."""
    _check_system(mesh, Xs, backend)
    home, dtype = mesh[0], Xs[0].dtype
    kw = {"degree": degree, "gamma": gamma, "coef0": coef0}
    cost_inv = (torch.tensor(1.0, dtype=dtype, device=home)
                / torch.as_tensor(cost, dtype=dtype, device=home))
    x_last = torch.as_tensor(x_last, dtype=dtype)
    xl_on = _scatter(_to(x_last, home), mesh)
    # q_i = k(x_i, x_last): local to each shard (x_last on every device)
    q = _gather([gram_block(kernel, X, xl_on[dev][None, :], **kw)[:, 0]
                 for X, dev in zip(Xs, mesh)], home) * mask
    QA_cost = kernel_scalar(kernel, xl_on[home], xl_on[home], **kw) + cost_inv

    K_locs = None
    if mode == "cached":
        # each shard's row slab of K against the gathered data; the gathered
        # copy is dropped after the assembly
        mask_on = _scatter(mask, mesh)
        m = Xs[0].shape[0]
        X_full = {dev: torch.cat([_to(X, dev) for X in Xs]) for dev in _devices(mesh)}
        K_locs = [gram_block(kernel, X, X_full[dev], **kw)
                  * (mask_on[dev][i * m:(i + 1) * m, None] * mask_on[dev][None, :])
                  for i, (X, dev) in enumerate(zip(Xs, mesh))]
        del X_full

    matvec = _build_local_matvec(kernel, mesh, Xs, q, mask, QA_cost, cost_inv, degree, gamma,
                                 coef0, mode, K_locs=K_locs, backend=backend,
                                 precision=precision)
    minv = None
    if precond == "jacobi":
        kii = _gather([kernel_diag(kernel, row_sqnorms(X), **kw) for X in Xs], home)
        minv = jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)
    return q, QA_cost, cost_inv, matvec, minv


def make_sharded_learn(mesh, kernel: KernelType, degree: int, mode: str,
                       backend: BackendType = BackendType.torch, precond: str = "none",
                       mxu_plan: tuple | None = None):
    """Build the multi-device learn step for a mesh and configuration.

    Returns ``fn(Xs, x_last, b, mask, gamma, coef0, cost, eps, imax) -> (x,
    s, t, QA_cost, iterations, delta, delta0[, fast_iterations])`` with
    ``Xs, b, mask`` from :func:`shard_system` (the 8th output exists only
    under ``mxu_plan``).

    ``backend='cuda'`` runs every hop of the ``implicit`` ring through
    kernel K2; ``precond='jacobi'`` enables the diagonal preconditioner and
    ``mxu_plan`` the adaptive two-tier CG: the same feature set as the
    single-device CG, and the same ``solver/cg.py`` under it."""
    p = len(mesh)
    dot = partial(_psum_dot, num=p)

    def run(Xs, x_last, b, mask, gamma, coef0, cost, eps, imax):
        gamma, coef0, imax = float(gamma), float(coef0), int(imax)
        args = (kernel, mesh, Xs, x_last, mask, gamma, coef0, cost, degree, mode, backend,
                precond)
        if mxu_plan is None:
            q, QA_cost, _ci, matvec, minv = _prepare_local(*args)
            res = cg_solve(matvec, b, mask, eps, imax, minv=minv, dot=dot)
            extra = ()
        else:
            q, QA_cost, cost_inv, mv_fast, minv = _prepare_local(
                *args, precision=tier_precision(mxu_plan[0]))
            mv_acc = _build_local_matvec(kernel, mesh, Xs, q, mask, QA_cost, cost_inv, degree,
                                         gamma, coef0, mode, backend=backend,
                                         precision=tier_precision(mxu_plan[1]))
            res = cg_solve_adaptive(mv_fast, mv_acc, b, mask, eps, imax, minv=minv, dot=dot)
            extra = (res.fast_iterations,)
        s = _psum([c.sum() for c in res.x.chunk(p)])
        t = dot(q, res.x)
        return (res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0) + extra

    return run


def make_sharded_learn_fns(mesh, kernel: KernelType, degree: int, mode: str,
                           backend: BackendType = BackendType.torch, precond: str = "none"):
    """Chunked multi-device learn: ``(setup, chunk)`` for the checkpoint /
    verbose-CG loop (``CSVM._drive_chunked_cg``), sharing
    :func:`_prepare_local` and the one CG of ``solver/cg.py``.

    ``setup(Xs, x_last, b, mask, gamma, coef0, cost) -> (q, QA_cost, state)``;
    ``chunk(Xs, b, mask, x_last, gamma, coef0, cost, eps, imax_end, state) ->
    state`` continues CG to ``imax_end`` total iterations.  A pair serves one
    learn: the operator is built **once**, by whichever of the two is called
    first (``chunk`` where the learn resumes from a checkpoint), and kept
    for the learn's other calls; a rebuild per chunk would redo the
    ``cached`` mode's K and the tiers' operands every interval.  The state's
    vectors are whole, on the home device, so a checkpoint has the
    single-device format."""
    dot = partial(_psum_dot, num=len(mesh))
    built = []

    def operator(Xs, x_last, mask, gamma, coef0, cost):
        if not built:
            built.append(_prepare_local(kernel, mesh, Xs, x_last, mask, float(gamma),
                                        float(coef0), cost, degree, mode, backend, precond))
        return built[0]

    def setup(Xs, x_last, b, mask, gamma, coef0, cost):
        q, QA_cost, _ci, matvec, minv = operator(Xs, x_last, mask, gamma, coef0, cost)
        return q, QA_cost, cg_init(matvec, b, mask, minv=minv, dot=dot)

    def chunk(Xs, b, mask, x_last, gamma, coef0, cost, eps, imax_end, state: CGState):
        _q, _QA, _ci, matvec, minv = operator(Xs, x_last, mask, gamma, coef0, cost)
        return cg_run(matvec, b, mask, eps, int(imax_end), state, minv=minv, dot=dot)

    return setup, chunk


def make_sharded_predict(mesh, kernel: KernelType, degree: int,
                         backend: BackendType = BackendType.torch):
    """Multi-device predict: the support-vector axis is sharded, each shard
    expands its slice of the kernel sum, and the partial decision values
    are added in shard order on the home device (``gpu_csvm.cpp:52-127``
    over all devices).  On the ``cuda`` backend a float32 slice runs kernel
    K2, as the single-device predict does.

    Returns ``fn(points, Xs_sv, alphas_s, bias, gamma, coef0) -> (npoints,)``
    with ``points`` on the home device and ``Xs_sv`` / ``alphas_s`` the row
    blocks of the support vectors and their weights on the mesh's devices
    (zero-padded rows are harmless: their alphas are zero)."""
    home = mesh[0]

    def run(points, Xs_sv, alphas_s, bias, gamma, coef0):
        _check_system(mesh, Xs_sv, backend)
        use_kernel = backend == BackendType.cuda and points.dtype == torch.float32
        fn = gram_matvec if use_kernel else gram_matvec_plain
        P_on = _scatter(points, mesh)
        parts = [fn(kernel, P_on[dev], a, Y=X, degree=degree, gamma=float(gamma),
                    coef0=float(coef0))
                 for X, a, dev in zip(Xs_sv, alphas_s, mesh)]
        return _psum([_to(part, home) for part in parts]) + bias

    return run


def make_sharded_w(mesh):
    """Multi-device ``w = X^T alpha`` (the linear predict's fast path,
    ``gpu_csvm.cpp:327-350``): each shard contracts its row slice, the
    partials of f floats are added in shard order on the home device."""
    home = mesh[0]

    def run(Xs, alphas_s):
        return _psum([_to(X.T @ a, home) for X, a in zip(Xs, alphas_s)])

    return run


def shard_rows(mesh, a, dtype: torch.dtype | None = None) -> list:
    """The ``len(mesh)`` equal row blocks of ``a`` (numpy or torch, rows a
    multiple of the mesh size), block ``i`` contiguous on ``mesh[i]``."""
    a = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    p = len(mesh)
    if a.shape[0] % p:
        raise ValueError(f"{a.shape[0]} rows do not divide evenly over the {p}-shard mesh; "
                         f"pad the system to a multiple of {p} rows first")
    return [blk.to(device=dev, dtype=dtype).contiguous() for blk, dev in zip(a.chunk(p), mesh)]


def shard_system(mesh, X_pad, b_pad, mask, dtype: torch.dtype | None = None):
    """Place the padded system on the mesh: the rows of ``X_pad`` sharded,
    ``b_pad`` and ``mask`` whole on the home device.  Returns ``(Xs, b,
    mask)``."""
    def whole(a):
        a = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return a.to(device=mesh[0], dtype=dtype)

    return shard_rows(mesh, X_pad, dtype), whole(b_pad), whole(mask)
