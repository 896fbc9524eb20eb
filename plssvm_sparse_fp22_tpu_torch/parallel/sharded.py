"""Multi-device LS-SVM training: sharded A·v under one CG.

Port of the JAX package's ``parallel/sharded.py``.  The reference splits the
*feature* axis across devices for the linear kernel only
(``gpu_csvm.cpp:130-157``) and pins polynomial/RBF to one GPU
(``CUDA/csvm.cu:61-63``); here the *row* axis of the padded system is cut
into ``p`` equal blocks over a mesh (``parallel/mesh.py``: a list of
``torch.device``, one entry per shard), and the feature axis where the data
is wide, for all three kernels.  One process drives every device of a
plain mesh, as the reference does.  A mesh may name one device several
times: its shards are then logical, which is how the sharded learns run on
the CPU and how several ring shards run on one card.

A mesh may also span processes (``mesh.GlobalMesh``, from
``parallel/distributed.py``): each rank then holds and computes its own
shards (the entries of other ranks' shards are None), and the CG vectors are
whole on every rank's home device, where every rank runs the same CG on the
same bits.  The shards' rows of K·v are all-gathered, their partials
all-gathered and added in global shard order, and a ring block owned by
another rank arrives by a matched send and receive (:class:`_Exchange`);
so a learn across processes gives, bit for bit, the one-process learn over
the same shards.  Every learn of this module, the predict and ``w`` cross
processes so.

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
  float64, its plain version.  A block that lies on another device of the
  process is
  copied into the shard's one receive buffer on side streams (two row
  blocks per shard at most), ordered against the hops by events; the
  tier's operands (``tier_operands``) are prepared once per operator and
  are what travels.  K is never held.

Four more learns share that skeleton (:func:`make_feature_sharded_learn`
and the sparse ones below):

- **feature-sharded**: each shard holds a column slice ``(D, f/p)`` of X and
  the CG vectors stay whole on the home device; ``K v = sum_p X_p (X_p^T
  v)`` for the linear kernel, and for poly/rbf each row block of the linear
  Gram ``G = sum_p X_p X_p^T`` is reduced on the home device before the
  kernel transform.  Plain products, exact (TF32 off), as in the JAX
  package, which runs no Pallas kernel there.
- **sparse linear**: row-sharded ELL+COO slabs, ``u = sum_p X_p^T v_p``
  reduced on the home device, ``K v`` the rows of ``X_p u``.  No kernel.
- **sparse panel ring** (poly/rbf): the tiled-ELL slabs and heavy rows
  walk the ring; each shard densifies its own panels once per operator and
  each panel of the block in flight once per hop, and every panel pair is
  one launch of K2 at the fixed tier on the ``cuda`` backend (its plain
  version on ``torch`` and for float64): ``p² nP²`` launches per A·v.
- **sparse gather ring** (poly/rbf, extreme sparsity): the ELL+COO shards
  walk the ring and each hop runs the ``gather`` contraction of
  ``ops/sparse.py``.  No kernel.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..constants import ROW_BLOCK_SIZE
from ..exceptions import PLSSVMError
from ..ops.gram_matvec import (gram_matvec, gram_matvec_plain, resolve_tier, row_sqnorms,
                               tier_matmul, tier_operands)
from ..ops.kernel_functions import (gram_block, integer_pow, kernel_diag, kernel_scalar,
                                    kernel_transform)
from ..ops.matvec import (_corrections, fixed_tier, jacobi_minv_from_kii, tier_precision,
                          uses_kernels)
from ..ops.sparse import (TILE, ELLMatrix, HybridSparse, _heavy_by_panel, densify_tiled,
                          hybrid_matvec, hybrid_rmatvec, hybrid_row_sqnorms,
                          make_streaming_cross_contrib, sparse_q_qa_kii, tiled_matvec)
from ..solver.cg import CGState, cg_init, cg_run, cg_solve, cg_solve_adaptive
from ..types import BackendType, KernelType
from . import distributed
from .mesh import local_shards, place_local, spans_processes

#: bytes of the partial Gram blocks a feature-sharded A·v holds at once on
#: the home device; the row blocks are as tall as that allows, at least
#: ``ROW_BLOCK_SIZE`` rows
FEATURE_BLOCK_BYTES = 256 * 1024**2


def _psum(parts):
    """Sum of partials (tensors on one device), in shard order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _psum_dot(a, b, num: int):
    """Deterministic sharded dot: one partial per row block, summed in
    shard order.  The vectors are whole on every rank, so each rank holds
    every shard's partial already and the sum is the same bits on all."""
    return _psum([torch.dot(ai, bi) for ai, bi in zip(a.chunk(num), b.chunk(num))])


def _local_corrections(Kv, v, q, mask, QA_cost, cost_inv, num: int):
    """Rank-1 + diagonal corrections with the two scalars reduced over the
    shards: the sharded twin of ``ops/matvec._corrections``."""
    s = _psum([c.sum() for c in v.chunk(num)])
    t = _psum_dot(q, v, num)
    return mask * Kv + (QA_cost * s - t) * mask - s * q + cost_inv * v


def _home(mesh) -> torch.device:
    """Where the CG vectors live: the device of this process's first shard."""
    return mesh[local_shards(mesh)[0]]


def _devices(mesh) -> list:
    """The distinct devices of this process's shards, in order of first
    appearance."""
    return list(dict.fromkeys(mesh[i] for i in local_shards(mesh)))


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _scatter(v: torch.Tensor, mesh) -> dict:
    """``v`` on every device of this process's shards."""
    return {dev: _to(v, dev) for dev in _devices(mesh)}


def _gather(mesh, parts) -> torch.Tensor:
    """The shards' row slices joined on the home device; ``parts[i]`` is
    shard ``i``'s, for this process's shards.  Across processes, one
    all-gather brings every rank's rows."""
    home = _home(mesh)
    mine = torch.cat([_to(parts[i], home) for i in local_shards(mesh)])
    return torch.cat(distributed.all_gather(mine)) if spans_processes(mesh) else mine


def _reduce(mesh, parts) -> torch.Tensor:
    """The shards' partials (``parts[i]``, for this process's shards) added
    on the home device in global shard order: across processes every rank
    gathers all of them first, so every rank, and a one-process run over
    the same shards, gets the same bits."""
    home = _home(mesh)
    mine = [_to(parts[i], home) for i in local_shards(mesh)]
    if spans_processes(mesh):
        mine = [t for rank_parts in distributed.all_gather(torch.stack(mine)) for t in rank_parts]
    return _psum(mine)


class _Ring:
    """The row blocks of a ring operator and their way around the mesh: what
    a hop reads of block ``j`` as shard ``i`` sees it.  A block is a tuple of
    tensors, of any dtypes, equal in shape from block to block: a dense
    block's tier operands and row norms, a sparse shard's packing and row
    norms.  ``blocks[j]`` is None where another process holds shard ``j``;
    such a block arrives through :class:`_Exchange`."""

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
        self.exchange = _Exchange(mesh, blocks) if spans_processes(mesh) else None

    def hops(self):
        """``(i, j)`` of every hop this process runs, step by step: at step
        ``s`` shard ``i`` reads block ``(i - s) mod p``.  Across processes
        each step begins with its transfers, which every rank posts at the
        same point."""
        p = len(self.mesh)
        for s in range(p):
            if self.exchange is not None:
                self.exchange.begin(s)
            for i in local_shards(self.mesh):
                yield i, (i - s) % p

    def fetch(self, i: int, j: int):
        """Block ``j`` for shard ``i``: the owner's tensors where both lie
        on one device, else a copy into shard ``i``'s receive buffer, or
        what arrived from the rank that holds it."""
        if self.blocks[j] is None:
            return self.exchange.block(i)
        src, dst = self.mesh[j], self.mesh[i]
        if src == dst:
            return self.blocks[j]
        if self.recv[i] is None:
            self.recv[i] = tuple(torch.empty_like(t, device=dst) for t in self.blocks[j])
            if dst in self.side:
                # the allocator may hand out memory that earlier work on the
                # compute stream still reads
                self.side[dst].wait_stream(torch.cuda.current_stream(dst))
        buf = self.recv[i]
        pairs = list(zip(buf, self.blocks[j]))
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


class _Exchange:
    """The ring's hops between processes.  At step ``s`` each of this rank's
    shards ``i`` whose block ``j = (i - s) mod p`` lies on another rank
    receives it, and each of its shards ``j`` whose reader ``(j + s) mod p``
    lies on another rank sends its block there: a matched send and receive
    per tensor of the block, posted together (``distributed.post``).  Step
    ``s + 1``'s transfers are posted as step ``s`` begins, so they travel
    while step ``s`` computes; each shard has two receive buffers, one per
    parity of ``s``.  Step 0 reads only a shard's own block.

    Through host memory (gloo and CUDA tensors) a rank sends host copies of
    its blocks, made once, receives into pinned host buffers and copies a
    block to its shard's device buffer on the compute stream, in order with
    the hops; a host buffer is written again only after that copy is done.
    NCCL moves device tensors; its stream waits for the hops queued before
    a transfer is posted, and the hops after it wait for the transfer."""

    def __init__(self, mesh, blocks):
        self.mesh, self.ranks, self.rank = mesh, mesh.ranks, mesh.rank
        self.local = local_shards(mesh)
        template = blocks[self.local[0]]
        self.staged = distributed.through_host(template[0])
        self.out = {j: tuple(_host_copy(t) for t in blocks[j]) if self.staged else blocks[j]
                    for j in self.local}
        self.template = self.out[self.local[0]]
        self.inbox = {}      # (i, parity) -> the receive buffers
        self.on_dev = {}     # i -> the device buffers a staged block is copied to
        self.copied = {}     # parity -> event: the host-to-device copies are done
        self.works, self.arrived, self.ready = [], {}, {}

    def _buffers(self, i: int, parity: int):
        if (i, parity) not in self.inbox:
            self.inbox[i, parity] = tuple(
                torch.empty(t.shape, dtype=t.dtype, device=t.device, pin_memory=self.staged)
                for t in self.template)
        return self.inbox[i, parity]

    def _post(self, s: int) -> None:
        p, parity = len(self.mesh), s % 2
        for event in self.copied.pop(parity, ()):
            event.synchronize()

        def tag(j, k):
            return (parity * p + j) * len(self.template) + k

        sends = [(t, self.ranks[(j + s) % p], tag(j, k))
                 for j in self.local if self.ranks[(j + s) % p] != self.rank
                 for k, t in enumerate(self.out[j]) if t.numel()]
        recv_from = sorted(((i - s) % p, i) for i in self.local
                           if self.ranks[(i - s) % p] != self.rank)
        recvs = [(t, self.ranks[j], tag(j, k)) for j, i in recv_from
                 for k, t in enumerate(self._buffers(i, parity)) if t.numel()]
        self.works = distributed.post(sends, recvs)
        self.arrived = {i: self._buffers(i, parity) for _, i in recv_from}

    def begin(self, s: int) -> None:
        """Wait for step ``s``'s transfers and post step ``s + 1``'s."""
        if s > 0:
            for work in self.works:
                work.wait()
            if self.staged:
                for i, host in self.arrived.items():
                    if i not in self.on_dev:
                        self.on_dev[i] = tuple(torch.empty_like(t, device=self.mesh[i])
                                               for t in host)
                    for t_dev, t_host in zip(self.on_dev[i], host):
                        t_dev.copy_(t_host, non_blocking=True)
                self.copied[s % 2] = [torch.cuda.Event() for _ in _devices(self.mesh)]
                for event, dev in zip(self.copied[s % 2], _devices(self.mesh)):
                    event.record(torch.cuda.current_stream(dev))
                self.arrived = {i: self.on_dev[i] for i in self.arrived}
            self.ready = self.arrived
        if s + 1 < len(self.mesh):
            self._post(s + 1)

    def block(self, i: int):
        """What arrived for shard ``i`` at the current step."""
        return self.ready[i]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _build_local_matvec(kernel, mesh, Xs, q, mask, QA_cost, cost_inv, degree, gamma, coef0,
                        mode, K_locs=None, backend: BackendType = BackendType.torch,
                        precision: str | None = None):
    """A·v of the sharded system: ``v`` (D,) on the home device -> ``A v``
    there, the Gram product computed shard by shard (this process's
    shards; ``K_locs`` maps them to their slabs of K).

    ``precision`` is the tier of the per-iteration products (``linear`` and
    ``implicit`` modes; ``None``: the backend's fixed tier) — the adaptive
    two-tier CG builds the same matvec at two tiers, as the single-device
    ``build_operator`` does."""
    p, mine = len(mesh), local_shards(mesh)
    dtype = Xs[mine[0]].dtype
    m = Xs[mine[0]].shape[0]
    tier = resolve_tier(fixed_tier(backend) if precision is None else precision, dtype)

    def corrections(Kv, v):
        return _local_corrections(Kv, v, q, mask, QA_cost, cost_inv, p)

    if mode == "linear":
        if kernel != KernelType.linear:
            raise ValueError("mode='linear' requires the linear kernel")
        # as the single-device operator: plain products on the tier's operands,
        # the bf16 parts upcast once
        Xo = {i: tier_operands(tier, Xs[i], pad=False) for i in mine}
        if tier != "exact":
            Xo = {i: tuple(t.float() for t in ops) for i, ops in Xo.items()}
        XoT = {i: tuple(t.T for t in ops) for i, ops in Xo.items()}

        def matvec(v):
            v_on = _scatter(v, mesh)
            parts = {i: tier_matmul(tier, XoT[i],
                                    tier_operands(tier, v_on[mesh[i]][i * m:(i + 1) * m]))
                     for i in mine}
            # the one reduction of f floats, then u back to every device
            u = _reduce(mesh, parts)
            uo_on = {dev: tier_operands(tier, u_dev) for dev, u_dev in _scatter(u, mesh).items()}
            Kv = _gather(mesh, {i: tier_matmul(tier, Xo[i], uo_on[mesh[i]]) for i in mine})
            return corrections(Kv, v)

    elif mode == "cached":

        def matvec(v):
            v_on = _scatter(v, mesh)
            return corrections(_gather(mesh, {i: K_locs[i] @ v_on[mesh[i]] for i in mine}), v)

    elif mode == "implicit":
        hop_fn = gram_matvec if uses_kernels(backend, dtype) else gram_matvec_plain
        sq = {i: row_sqnorms(Xs[i]) for i in mine}
        ops = {i: tier_operands(tier, Xs[i]) for i in mine}  # split or cast once per operator
        ring = _Ring(mesh, [(*ops[j], sq[j]) if j in ops else None for j in range(p)])
        kw = {"degree": degree, "gamma": gamma, "coef0": coef0, "tier": tier}

        def matvec(v):
            v_on = _scatter(v, mesh)
            acc = {}
            for i, j in ring.hops():
                block = ring.fetch(i, j)
                *ops_j, sq_j = block
                # K(X_i, X_j) v_j from the operands alone: the float32 rows
                # of block j need not travel at a bf16 tier
                hop = hop_fn(kernel, Xs[i], v_on[mesh[i]][j * m:(j + 1) * m], sqx=sq[i],
                             sqy=sq_j, operands=(ops[i], tuple(ops_j)), **kw)
                ring.release(i, block)
                acc[i] = hop if i not in acc else acc[i] + hop
            return corrections(_gather(mesh, acc), v)

    else:
        raise ValueError(f"unknown sharded matvec mode '{mode}'")

    return matvec


def _check_system(mesh, Xs, backend) -> None:
    """The row blocks of this process's shards lie on their mesh devices,
    equal in shape; another rank's entries are None."""
    if len(Xs) != len(mesh):
        raise ValueError(f"{len(Xs)} row blocks for a mesh of {len(mesh)} shards")
    mine = local_shards(mesh)
    first = Xs[mine[0]]
    for i, (X, dev) in enumerate(zip(Xs, mesh)):
        if i not in mine:
            if X is not None:
                raise ValueError(f"shard {i} belongs to rank {mesh.ranks[i]}; this process "
                                 "holds None there (make_global_row_sharded)")
        elif X is None or X.device != dev or X.shape != first.shape:
            raise ValueError("the row blocks must be equal in shape and lie on their mesh "
                             f"devices (shard_system): got "
                             f"{None if X is None else (tuple(X.shape), X.device)}, expected "
                             f"{tuple(first.shape)} on {dev}")
    if backend == BackendType.cuda and any(dev.type != "cuda" for dev in _devices(mesh)):
        raise PLSSVMError(f"backend 'cuda' needs the system on CUDA devices, got {mesh}")


def _prepare_local(kernel, mesh, Xs, x_last, mask, gamma, coef0, cost, degree, mode,
                   backend, precond, precision=None):
    """Shared set-up of every sharded learn variant (full / setup / chunk):
    the q-vector, QA_cost, the A·v and the optional Jacobi diagonal, so there
    is one operator construction, mirroring the single ``build_operator`` of
    the one-device path.  ``precision`` is the matvec's tier (q, QA_cost and
    the cached K stay exact)."""
    _check_system(mesh, Xs, backend)
    mine = local_shards(mesh)
    home, dtype = _home(mesh), Xs[mine[0]].dtype
    kw = {"degree": degree, "gamma": gamma, "coef0": coef0}
    cost_inv = _cost_inv(cost, dtype, home)
    x_last = torch.as_tensor(x_last, dtype=dtype)
    xl_on = _scatter(_to(x_last, home), mesh)
    # q_i = k(x_i, x_last): local to each shard (x_last on every device)
    q = _gather(mesh, {i: gram_block(kernel, Xs[i], xl_on[mesh[i]][None, :], **kw)[:, 0]
                       for i in mine}) * mask
    QA_cost = kernel_scalar(kernel, xl_on[home], xl_on[home], **kw) + cost_inv

    K_locs = None
    if mode == "cached":
        # each shard's row slab of K against the gathered data (every rank's
        # rows); the gathered copies are dropped after the assembly
        mask_on = _scatter(mask, mesh)
        m = Xs[mine[0]].shape[0]
        X_full = _scatter(_gather(mesh, Xs), mesh)
        K_locs = {i: gram_block(kernel, Xs[i], X_full[mesh[i]], **kw)
                  * (mask_on[mesh[i]][i * m:(i + 1) * m, None] * mask_on[mesh[i]][None, :])
                  for i in mine}
        del X_full

    matvec = _build_local_matvec(kernel, mesh, Xs, q, mask, QA_cost, cost_inv, degree, gamma,
                                 coef0, mode, K_locs=K_locs, backend=backend,
                                 precision=precision)
    minv = None
    if precond == "jacobi":
        kii = _gather(mesh, {i: kernel_diag(kernel, row_sqnorms(Xs[i]), **kw) for i in mine})
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
    def prepare(Xs, x_last, mask, gamma, coef0, cost):
        return _prepare_local(kernel, mesh, Xs, x_last, mask, gamma, coef0, cost, degree, mode,
                              backend, precond)

    return _chunked_fns(prepare, partial(_psum_dot, num=len(mesh)))


def _chunked_fns(prepare, dot):
    """``(setup, chunk)`` over ``prepare(Xs, x_last, mask, gamma, coef0,
    cost) -> (q, QA_cost, cost_inv, matvec, minv)``, called once, by the
    first of the two that runs."""
    built = []

    def operator(Xs, x_last, mask, gamma, coef0, cost):
        if not built:
            built.append(prepare(Xs, x_last, mask, float(gamma), float(coef0), cost))
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
    (zero-padded rows are harmless: their alphas are zero).  Across
    processes each rank expands its own shards and gets the whole
    decision values."""

    def run(points, Xs_sv, alphas_s, bias, gamma, coef0):
        _check_system(mesh, Xs_sv, backend)
        fn = gram_matvec if uses_kernels(backend, points.dtype) else gram_matvec_plain
        P_on = _scatter(points, mesh)
        return _reduce(mesh, {i: fn(kernel, P_on[mesh[i]], alphas_s[i], Y=Xs_sv[i],
                                    degree=degree, gamma=float(gamma), coef0=float(coef0))
                              for i in local_shards(mesh)}) + bias

    return run


def make_sharded_w(mesh):
    """Multi-device ``w = X^T alpha`` (the linear predict's fast path,
    ``gpu_csvm.cpp:327-350``): each shard contracts its row slice, the
    partials of f floats are added in shard order on the home device."""

    def run(Xs, alphas_s):
        return _reduce(mesh, {i: Xs[i].T @ alphas_s[i] for i in local_shards(mesh)})

    return run


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def shard_rows(mesh, a, dtype: torch.dtype | None = None) -> list:
    """The ``len(mesh)`` equal row blocks of ``a`` (numpy or torch, rows a
    multiple of the mesh size), block ``i`` contiguous on ``mesh[i]``; on a
    mesh that spans processes, this process's blocks only (None for the
    others)."""
    a = _tensor(a)
    p = len(mesh)
    if a.shape[0] % p:
        raise ValueError(f"{a.shape[0]} rows do not divide evenly over the {p}-shard mesh; "
                         f"pad the system to a multiple of {p} rows first")
    blocks = a.chunk(p)
    return place_local(mesh, [blocks[i] for i in local_shards(mesh)], dtype)


def _whole(mesh, a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` whole on the home device."""
    return _tensor(a).to(device=_home(mesh), dtype=dtype)


def shard_system(mesh, X_pad, b_pad, mask, dtype: torch.dtype | None = None):
    """Place the padded system on the mesh: the rows of ``X_pad`` sharded,
    ``b_pad`` and ``mask`` whole on the home device.  Returns ``(Xs, b,
    mask)``."""
    return shard_rows(mesh, X_pad, dtype), _whole(mesh, b_pad, dtype), _whole(mesh, mask, dtype)


def _solve(matvec, q, QA_cost, b, mask, eps, imax, minv, p: int):
    """CG over a row-sharded operator, the learn's seven outputs ``(x, s, t,
    QA_cost, iterations, delta, delta0)``, every dot product reduced in
    shard order."""
    dot = partial(_psum_dot, num=p)
    res = cg_solve(matvec, b, mask, eps, int(imax), minv=minv, dot=dot)
    s = _psum([c.sum() for c in res.x.chunk(p)])
    return res.x, s, dot(q, res.x), QA_cost, res.iterations, res.delta, res.delta0


def _cost_inv(cost, dtype, home) -> torch.Tensor:
    return (torch.tensor(1.0, dtype=dtype, device=home)
            / torch.as_tensor(cost, dtype=dtype, device=home))


# ---------------------------------------------------------------------------
# the feature-sharded learn
# ---------------------------------------------------------------------------

def _feature_block_rows(D: int, itemsize: int) -> int:
    """Rows of a partial Gram block: :data:`FEATURE_BLOCK_BYTES` of it, a
    multiple of ``ROW_BLOCK_SIZE``, at least ``ROW_BLOCK_SIZE``, at most
    ``D``."""
    rows = FEATURE_BLOCK_BYTES // max(1, D * itemsize) // ROW_BLOCK_SIZE * ROW_BLOCK_SIZE
    return min(D, max(ROW_BLOCK_SIZE, rows))


def _prepare_feature_local(kernel, mesh, Xs, x_lasts, mask, gamma, coef0, cost, degree,
                           precond):
    """Set-up of the feature-sharded learns (``sharded.py:192-276`` of the
    JAX package): q and QA_cost from the linear terms reduced over the
    shards, the A·v and the optional Jacobi diagonal.  ``Xs`` are the
    ``(D, f/p)`` column blocks of X and ``x_lasts`` the matching slices of
    ``x_last`` (this process's shards); what is returned lies whole on the
    home device, where CG runs as on one device.

    linear: ``K v = sum_p X_p (X_p^T v)``.  poly/rbf: for each row block,
    ``G_blk = sum_p X_{blk,p} X_p^T`` reduced on the home device in shard
    order (:func:`_reduce`; across processes every rank's partials are
    all-gathered first, the O(D²) bytes the JAX package's ``psum`` moves),
    then the kernel transform and ``K_blk v``.  The blocks are as tall as
    :func:`_feature_block_rows` allows; a Gram entry is the same sum
    whatever the block's height."""
    _check_system(mesh, Xs, BackendType.torch)
    mine = local_shards(mesh)
    home, dtype = _home(mesh), Xs[mine[0]].dtype
    D = Xs[mine[0]].shape[0]
    cost_inv = _cost_inv(cost, dtype, home)

    # q and QA_cost from the reduced partial linear terms (generate_q and
    # device_reduction, gpu_csvm.cpp:160-183)
    g_last = _reduce(mesh, {i: Xs[i] @ x_lasts[i] for i in mine})
    sq_last = _reduce(mesh, {i: torch.dot(x_lasts[i], x_lasts[i]) for i in mine})
    sq = _reduce(mesh, {i: row_sqnorms(Xs[i]) for i in mine})
    if kernel == KernelType.linear:
        q, QA = g_last, sq_last
    elif kernel == KernelType.polynomial:
        q = integer_pow(gamma * g_last + coef0, degree)
        QA = integer_pow(gamma * sq_last + coef0, degree)
    else:
        q = torch.exp(-gamma * torch.clamp(sq + sq_last - 2.0 * g_last, min=0.0))
        QA = torch.ones((), dtype=dtype, device=home)
    q = q * mask
    QA_cost = QA + cost_inv
    XTs = {i: Xs[i].T for i in mine}

    if kernel == KernelType.linear:

        def matvec(v):
            v_on = _scatter(v, mesh)
            Kv = _reduce(mesh, {i: Xs[i] @ (XTs[i] @ v_on[mesh[i]]) for i in mine})
            return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    else:
        rows = _feature_block_rows(D, dtype.itemsize)

        def matvec(v):
            outs = []
            for r0 in range(0, D, rows):
                G = _reduce(mesh, {i: Xs[i][r0:r0 + rows] @ XTs[i] for i in mine})
                K = kernel_transform(kernel, G, degree, gamma, coef0, sq[r0:r0 + rows], sq)
                outs.append(K @ v)
            return _corrections(torch.cat(outs), v, q, mask, QA_cost, cost_inv)

    minv = None
    if precond == "jacobi":
        minv = jacobi_minv_from_kii(kernel_diag(kernel, sq, degree, gamma, coef0), q, mask,
                                    QA_cost, cost_inv)
    return q, QA_cost, cost_inv, matvec, minv


def make_feature_sharded_learn(mesh, kernel: KernelType, degree: int, precond: str = "none"):
    """Multi-device learn with the **feature axis** sharded
    (``sharded.py:279-328`` of the JAX package): the reference's own
    multi-GPU split (``feature_ranges_``, ``gpu_csvm.cpp:130-157``), linear
    only there (``CUDA/csvm.cu:61-63``), here for all three kernels, since
    poly and rbf depend on the features only through the linear Gram.  Worth
    it where ``f / p`` dwarfs ``D``.

    Returns ``fn(Xs, x_lasts, b, mask, gamma, coef0, cost, eps, imax) -> (x,
    s, t, QA_cost, iterations, delta, delta0)`` with the arguments from
    :func:`shard_system_feature`.  Across processes every rank gets the
    whole result, the one-process learn's bits."""

    def run(Xs, x_lasts, b, mask, gamma, coef0, cost, eps, imax):
        q, QA_cost, _ci, matvec, minv = _prepare_feature_local(
            kernel, mesh, Xs, x_lasts, mask, float(gamma), float(coef0), cost, degree, precond)
        res = cg_solve(matvec, b, mask, eps, int(imax), minv=minv)
        return (res.x, torch.sum(res.x), torch.dot(q, res.x), QA_cost, res.iterations,
                res.delta, res.delta0)

    return run


def make_feature_sharded_learn_fns(mesh, kernel: KernelType, degree: int,
                                   precond: str = "none"):
    """Chunked feature-sharded learn, ``(setup, chunk)`` with the signatures
    of :func:`make_sharded_learn_fns` (``x_last`` given as the slices of
    :func:`shard_system_feature`); the operator is built once per pair, and
    the state is whole on the home device, so a checkpoint has the
    single-device format (``sharded.py:331-381`` of the JAX package).
    Across processes the state is whole and the same bits on every rank,
    so one rank writes the checkpoint and any launch resumes from it."""

    def prepare(Xs, x_lasts, mask, gamma, coef0, cost):
        return _prepare_feature_local(kernel, mesh, Xs, x_lasts, mask, gamma, coef0, cost,
                                      degree, precond)

    return _chunked_fns(prepare, torch.dot)


def shard_system_feature(mesh, X_pad, x_last, b_pad, mask, dtype: torch.dtype | None = None):
    """Place the padded system on the mesh with the features sharded
    (``sharded.py:384-402``): ``(Xs, x_lasts, b, mask)``, the ``(D, f/p)``
    column blocks of ``X_pad`` and the slices of ``x_last`` on their
    devices, ``b`` and ``mask`` whole on the home device.  On a mesh that
    spans processes every rank passes the whole padded system and places
    its own column blocks (None for the others), as
    :func:`shard_sparse_system` does."""
    X = _tensor(X_pad)
    p = len(mesh)
    if X.shape[1] % p:
        raise ValueError(f"feature count {X.shape[1]} must divide evenly over the {p}-shard "
                         f"mesh for feature sharding; pad the feature axis to a multiple of "
                         f"{p} first")
    blocks = X.chunk(p, 1)
    Xs = place_local(mesh, [blocks[i] for i in local_shards(mesh)], dtype)
    return (Xs, shard_rows(mesh, x_last, dtype), _whole(mesh, b_pad, dtype),
            _whole(mesh, mask, dtype))


# ---------------------------------------------------------------------------
# the sparse learns
# ---------------------------------------------------------------------------

def _per_shard(mesh, A: np.ndarray, dtype: torch.dtype | None = None) -> list:
    """Row ``s`` of ``A`` on ``mesh[s]``, for this process's shards (None
    for the others)."""
    mine = set(local_shards(mesh))
    return [torch.from_numpy(np.ascontiguousarray(A[s])).to(device=dev, dtype=dtype)
            if s in mine else None for s, dev in enumerate(mesh)]


def shard_sparse_system(mesh, h, b_pad, mask, dtype: torch.dtype | None = None):
    """Place a padded ELL+COO packing (``ops/sparse.HybridSparse``) on the
    mesh, rows sharded (``sharded.py:596-638``).  The ELL slabs shard by
    row; the COO tail is split by owning shard, its rows rebased to the
    shard and padded to one count for all shards with entries of value 0 at
    row and column 0, which add nothing.  Returns ``(vals, cols, trow, tcol,
    tval, b, mask)``: five lists of per-shard tensors (the tail's as vectors
    of that count) and ``b``, ``mask`` whole on the home device.  On a mesh
    that spans processes every rank passes the whole packing, as the JAX
    package's workers group the tails, and places its own shards."""
    p = len(mesh)
    n = h.ell.values.shape[0]
    if n % p:
        raise ValueError(f"padded rows {n} must divide over the {p}-shard mesh")
    rows_per = n // p
    trows, tcols, tvals = (t.cpu().numpy() for t in (h.coo_rows, h.coo_cols, h.coo_vals))
    sid = trows // rows_per
    # m_max == 0 when the ELL cap absorbed every nonzero: the products then
    # skip the tail
    m_max = int(np.bincount(sid, minlength=p).max()) if trows.size else 0
    R = np.zeros((p, m_max), np.int32)
    C = np.zeros((p, m_max), np.int32)
    V = np.zeros((p, m_max), tvals.dtype)
    for s in range(p):
        sel = sid == s
        k = int(sel.sum())
        R[s, :k] = trows[sel] - s * rows_per
        C[s, :k] = tcols[sel]
        V[s, :k] = tvals[sel]
    return (shard_rows(mesh, h.ell.values, dtype), shard_rows(mesh, h.ell.cols),
            _per_shard(mesh, R), _per_shard(mesh, C), _per_shard(mesh, V, dtype),
            _whole(mesh, b_pad, dtype), _whole(mesh, mask, dtype))


def _packing(f: int, vals, cols, trow, tcol, tval) -> HybridSparse:
    """A shard's ELL+COO rows as an ``ops/sparse.HybridSparse``."""
    return HybridSparse(ell=ELLMatrix(values=vals, cols=cols, shape=(vals.shape[0], f)),
                        coo_rows=trow, coo_cols=tcol, coo_vals=tval)


def _prepare_sparse_linear(mesh, vals, cols, trow, tcol, tval, x_last, mask, cost, precond):
    """Set-up of the row-sharded sparse linear learn (``sharded.py:974-1010``
    of the JAX package): ``K v`` is the rows of ``X_p u`` with ``u = sum_p
    X_p^T v_p`` (the scatter-add ``hybrid_rmatvec``) reduced on the home
    device (:func:`_reduce`, the JAX package's ``psum``); nnz-proportional
    work per shard, f floats per shard and A·v between devices."""
    _check_system(mesh, vals, BackendType.torch)
    p, mine, home = len(mesh), local_shards(mesh), _home(mesh)
    dtype, m = vals[mine[0]].dtype, vals[mine[0]].shape[0]
    x_last = _to(torch.as_tensor(x_last, dtype=dtype), home)
    cost_inv = _cost_inv(cost, dtype, home)
    hs = {i: _packing(x_last.shape[0], vals[i], cols[i], trow[i], tcol[i], tval[i])
          for i in mine}
    xl_on = _scatter(x_last, mesh)
    q = _gather(mesh, {i: hybrid_matvec(hs[i], xl_on[mesh[i]]) for i in mine}) * mask
    QA_cost = torch.dot(x_last, x_last) + cost_inv

    def matvec(v):
        v_on = _scatter(v, mesh)
        u = _reduce(mesh, {i: hybrid_rmatvec(hs[i], v_on[mesh[i]][i * m:(i + 1) * m])
                           for i in mine})
        u_on = _scatter(u, mesh)
        Kv = _gather(mesh, {i: hybrid_matvec(hs[i], u_on[mesh[i]]) for i in mine})
        return _local_corrections(Kv, v, q, mask, QA_cost, cost_inv, p)

    minv = None
    if precond == "jacobi":
        # linear kernel: kii = the rows' squared norms (ELL + COO tail)
        kii = _gather(mesh, {i: hybrid_row_sqnorms(hs[i]) for i in mine})
        minv = jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)
    return q, QA_cost, cost_inv, matvec, minv


def make_sharded_sparse_linear_learn(mesh, precond: str = "none"):
    """Row-sharded sparse linear-kernel learn over the ELL+COO packing
    (``sharded.py:946-1018``), for data whose sparse form spans several
    devices; beyond the reference, whose multi-GPU path is dense, feature
    split and linear only (``gpu_csvm.cpp:130-157``).

    Returns ``fn(vals, cols, trow, tcol, tval, x_last, b, mask, cost, eps,
    imax) -> (x, s, t, QA_cost, iterations, delta, delta0)`` with the system
    from :func:`shard_sparse_system` and ``x_last`` dense; across processes
    every rank gets the whole result."""

    def run(vals, cols, trow, tcol, tval, x_last, b, mask, cost, eps, imax):
        q, QA_cost, _ci, matvec, minv = _prepare_sparse_linear(
            mesh, vals, cols, trow, tcol, tval, x_last, mask, cost, precond)
        return _solve(matvec, q, QA_cost, b, mask, eps, imax, minv, len(mesh))

    return run


def shard_sparse_tiled_system(mesh, th, b_pad, mask, dtype: torch.dtype | None = None):
    """Place a padded tiled-ELL packing (``ops/sparse.TiledHybrid``) on the
    mesh, rows sharded, for the panel ring (``sharded.py:641-678``).  The
    heavy rows are grouped by owning shard and padded to one count for all
    shards; a padding slot carries the row ``m_loc``, one past the shard,
    which places nothing.  Returns ``(tvals, tlcols, heavy, hrow, b,
    mask)``: four lists of per-shard tensors and ``b``, ``mask`` whole on
    the home device."""
    p = len(mesh)
    tell = th.tell
    n = tell.vals.shape[0]
    if n % p:
        raise ValueError(f"padded rows {n} must divide over the {p}-shard mesh")
    m_loc = n // p
    hidx = np.asarray(th.heavy_idx)
    heavy = th.heavy.cpu().numpy()
    sid = hidx // m_loc
    h_max = int(np.bincount(sid, minlength=p).max()) if hidx.size else 0
    H = np.zeros((p, h_max, tell.padded_features), heavy.dtype)
    R = np.full((p, h_max), m_loc, np.int32)
    for s in range(p):
        sel = sid == s
        k = int(sel.sum())
        H[s, :k] = heavy[sel]
        R[s, :k] = hidx[sel] - s * m_loc
    return (shard_rows(mesh, tell.vals, dtype), shard_rows(mesh, tell.lcols),
            _per_shard(mesh, H, dtype), _per_shard(mesh, R),
            _whole(mesh, b_pad, dtype), _whole(mesh, mask, dtype))


def _heavy_places(mesh, hrow, m: int) -> list:
    """Every shard's heavy-row places as host ints, one list per shard; a
    padding slot (row ``m``) becomes -1, which no panel holds.  Across
    processes one all-gather brings the other ranks' (a few int32 per
    shard); every shard has the same number of slots."""
    mine = local_shards(mesh)
    if not hrow[mine[0]].numel():
        return [[] for _ in mesh]
    home = _home(mesh)
    places = torch.stack([_to(hrow[i], home) for i in mine])
    if spans_processes(mesh):
        places = torch.cat(distributed.all_gather(places))
    return [[r if r < m else -1 for r in row] for row in places.tolist()]


def _prepare_sparse_panel_local(kernel, mesh, tvals, tlcols, heavy, hrow, x_last, mask, gamma,
                                coef0, cost, degree, *, ntiles: int, Lt: int, panel_rows: int,
                                backend: BackendType, precond: str, precision: str | None = None):
    """Set-up of the panel ring (``sharded.py:718-836`` of the JAX package):
    q, QA_cost, the A·v and the Jacobi diagonal of the tiled-ELL shards of
    :func:`shard_sparse_tiled_system`.

    Each shard's rows are cut into panels of ``panel_rows``.  A shard's own
    panels never leave it: they are densified, and their tier operands
    prepared, once per operator.  The tiled slabs, heavy rows and row norms
    of the other shards walk the ring (:class:`_Ring`); each panel of the
    block in flight is densified and prepared once per hop, in the hop's
    outer loop, so one such panel is alive at a time (XLA's CSE leaves the
    JAX package one densify per panel too; eager PyTorch would otherwise
    redo it for every local panel).  Every panel pair is ``K(X_I, X_J)
    v_J``: K2 on the ``cuda`` backend for float32, ``p² nP²`` launches per
    A·v, else its plain version; at ``precision``, else the backend's fixed
    tier, as the JAX hop passes no precision.  Each process runs the hops
    of its own shards (:meth:`_Ring.hops`), ``p² nP² / ranks`` launches.
    The heavy rows' places of every shard are read to the host once, here
    (one all-gather across processes), not from each block in flight as the
    JAX ring's carried ``bhr``: that would sync the host every hop."""
    _check_system(mesh, tvals, backend)
    p, mine, home = len(mesh), local_shards(mesh), _home(mesh)
    dtype, m = tvals[mine[0]].dtype, tvals[mine[0]].shape[0]
    fp = ntiles * TILE
    x_last = _to(torch.as_tensor(x_last, dtype=dtype), home)
    f = x_last.shape[0]
    cost_inv = _cost_inv(cost, dtype, home)
    bounds = list(range(0, m, panel_rows)) + [m]
    nP = len(bounds) - 1
    heavy_rows = _heavy_places(mesh, hrow, m)
    placed = {(dev, j): _heavy_by_panel(heavy_rows[j], bounds[:-1], dev)
              for dev in _devices(mesh) for j in range(p)}

    def densify(j, J, vals, lcols, hv, dev):
        """Panel J of shard j's rows, on ``dev``."""
        panel = densify_tiled(vals[bounds[J]:bounds[J + 1]], lcols[bounds[J]:bounds[J + 1]],
                              ntiles, Lt)
        where = placed[dev, j][J]
        if where is not None:
            panel[where[0]] = hv[where[1]].to(dtype)
        return panel

    # row norms and <x_i, x_last>: the light rows from the packing, the heavy
    # rows' from their dense copies
    xl_on = _scatter(x_last if f == fp else torch.cat([x_last, x_last.new_zeros(fp - f)]), mesh)
    sq, g_last = {}, {}
    for i in mine:
        dev = mesh[i]
        sq_i = torch.sum(tvals[i] * tvals[i], dim=1)
        g_i = tiled_matvec(tvals[i], tlcols[i], xl_on[dev], ntiles, Lt)
        ks = [k for k, r in enumerate(heavy_rows[i]) if r >= 0]
        if ks:
            rows = torch.tensor([heavy_rows[i][k] for k in ks], device=dev)
            hv = heavy[i][torch.tensor(ks, device=dev)].to(dtype)
            sq_i[rows] += torch.sum(hv * hv, dim=1)
            g_i[rows] += hv @ xl_on[dev]
        sq[i], g_last[i] = sq_i, g_i
    q, QA_cost, kii = sparse_q_qa_kii(int(kernel), degree, gamma, coef0, _gather(mesh, g_last),
                                      torch.dot(x_last, x_last), _gather(mesh, sq), mask,
                                      cost_inv)

    hop_fn = gram_matvec if uses_kernels(backend, dtype) else gram_matvec_plain
    tier = resolve_tier(fixed_tier(backend) if precision is None else precision, dtype)
    kw = {"degree": degree, "gamma": gamma, "coef0": coef0, "tier": tier}
    local = {i: [densify(i, J, tvals[i], tlcols[i], heavy[i], mesh[i]) for J in range(nP)]
             for i in mine}
    local_ops = {i: [tier_operands(tier, panel) for panel in panels]
                 for i, panels in local.items()}
    ring = _Ring(mesh, [(tvals[j], tlcols[j], heavy[j], sq[j]) if j in sq else None
                        for j in range(p)])

    def hop(i, j, v_j):
        """``K(X_i, X_j) v_j`` over every panel pair, block j's panels in
        the outer loop."""
        dev = mesh[i]
        block = None if j == i else ring.fetch(i, j)
        sq_j = sq[i] if block is None else block[3]
        outs = [None] * nP
        for J in range(nP):
            if block is None:  # hop 0: the shard's own block, densified already
                panel, ops = local[i][J], local_ops[i][J]
            else:
                panel = densify(j, J, *block[:3], dev)
                ops = tier_operands(tier, panel)
            lo, hi = bounds[J], bounds[J + 1]
            for I in range(nP):
                part = hop_fn(kernel, local[i][I], v_j[lo:hi], Y=panel,
                              sqx=sq[i][bounds[I]:bounds[I + 1]], sqy=sq_j[lo:hi],
                              operands=(local_ops[i][I], ops), **kw)
                outs[I] = part if outs[I] is None else outs[I] + part
        if block is not None:
            ring.release(i, block)
        return torch.cat(outs)

    def matvec(v):
        v_on = _scatter(v, mesh)
        acc = {}
        for i, j in ring.hops():
            part = hop(i, j, v_on[mesh[i]][j * m:(j + 1) * m])
            acc[i] = part if i not in acc else acc[i] + part
        return _local_corrections(_gather(mesh, acc), v, q, mask, QA_cost, cost_inv, p)

    minv = None
    if precond == "jacobi":
        minv = jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)
    return q, QA_cost, cost_inv, matvec, minv


def make_sharded_sparse_panel_learn(mesh, kernel: KernelType, degree: int, *, ntiles: int,
                                    Lt: int, panel_rows: int, precond: str = "none",
                                    backend: BackendType = BackendType.torch):
    """Ring-sharded streaming poly/rbf learn over tiled-ELL shards with
    transient dense panels (``sharded.py:681-844``): the sparse regime
    beyond one device's memory (BASELINE.json config 5).  Each device holds
    its tiled slab and its own densified panels; the slabs walk the ring
    once per A·v and every panel pair runs K2 (``backend='cuda'``, float32)
    or its plain version.  Neither K nor the whole dense X is held by one
    device.

    Returns ``fn(tvals, tlcols, heavy, hrow, x_last, b, mask, gamma, coef0,
    cost, eps, imax) -> (x, s, t, QA_cost, iterations, delta, delta0)`` with
    the system from :func:`shard_sparse_tiled_system` and ``x_last``
    dense; across processes every rank gets the whole result."""

    def run(tvals, tlcols, heavy, hrow, x_last, b, mask, gamma, coef0, cost, eps, imax):
        q, QA_cost, _ci, matvec, minv = _prepare_sparse_panel_local(
            kernel, mesh, tvals, tlcols, heavy, hrow, x_last, mask, float(gamma),
            float(coef0), cost, degree, ntiles=ntiles, Lt=Lt, panel_rows=panel_rows,
            backend=backend, precond=precond)
        return _solve(matvec, q, QA_cost, b, mask, eps, imax, minv, len(mesh))

    return run


def _gather_tile(m: int) -> int:
    """The largest of 512, 256, ..., 1 that divides a shard's ``m`` rows."""
    return next(b for b in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if m % b == 0)


def _prepare_sparse_gather_local(kernel, mesh, vals, cols, trow, tcol, tval, x_last, mask,
                                 gamma, coef0, cost, degree, precond):
    """Set-up of the gather ring (``sharded.py:878-935`` of the JAX
    package): the ELL+COO shards of :func:`shard_sparse_system` walk the
    ring, and each hop contracts the shard's rows against the block in
    flight with ``ops/sparse.make_streaming_cross_contrib`` (the
    nnz-proportional ``gather`` strategy, row tiles of :func:`_gather_tile`
    rows, column panels of at most 128)."""
    _check_system(mesh, vals, BackendType.torch)
    p, mine, home = len(mesh), local_shards(mesh), _home(mesh)
    dtype, m = vals[mine[0]].dtype, vals[mine[0]].shape[0]
    x_last = _to(torch.as_tensor(x_last, dtype=dtype), home)
    f = x_last.shape[0]
    cost_inv = _cost_inv(cost, dtype, home)
    shards = {i: (vals[i], cols[i], trow[i], tcol[i], tval[i]) for i in mine}
    hs = {i: _packing(f, *shards[i]) for i in mine}
    xl_on = _scatter(x_last, mesh)
    sq = {i: hybrid_row_sqnorms(hs[i]) for i in mine}
    g_last = _gather(mesh, {i: hybrid_matvec(hs[i], xl_on[mesh[i]]) for i in mine})
    q, QA_cost, kii = sparse_q_qa_kii(int(kernel), degree, gamma, coef0, g_last,
                                      torch.dot(x_last, x_last), _gather(mesh, sq), mask,
                                      cost_inv)
    bm = _gather_tile(m)
    contribs = {i: make_streaming_cross_contrib(
        int(kernel), degree, gamma, coef0, row_vals=vi, row_cols=ci, row_sq=sq[i], row_trow=ri,
        row_tcol=tci, row_tval=tvi, f=f, bm=bm, bn=min(bm, 128), strategy="gather")
        for i, (vi, ci, ri, tci, tvi) in shards.items()}
    ring = _Ring(mesh, [(*shards[j], sq[j]) if j in shards else None for j in range(p)])

    def matvec(v):
        v_on = _scatter(v, mesh)
        acc = {}
        for i, j in ring.hops():
            block = ring.fetch(i, j)
            part = contribs[i](*block, v_on[mesh[i]][j * m:(j + 1) * m])
            ring.release(i, block)
            acc[i] = part if i not in acc else acc[i] + part
        return _local_corrections(_gather(mesh, acc), v, q, mask, QA_cost, cost_inv, p)

    minv = None
    if precond == "jacobi":
        minv = jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)
    return q, QA_cost, cost_inv, matvec, minv


def make_sharded_sparse_streaming_learn(mesh, kernel: KernelType, degree: int,
                                        precond: str = "none"):
    """Ring-sharded streaming poly/rbf learn over ELL+COO shards with the
    ``gather`` contraction (``sharded.py:847-943``): the extreme-sparsity
    arm of the regime beyond one device's memory.  Each device holds its
    ELL+COO slab and at most one block in flight; neither K nor a dense
    panel is built.  Moderate densities take
    :func:`make_sharded_sparse_panel_learn`.

    Returns ``fn(vals, cols, trow, tcol, tval, x_last, b, mask, gamma, coef0,
    cost, eps, imax) -> (x, s, t, QA_cost, iterations, delta, delta0)`` with
    the system from :func:`shard_sparse_system` and ``x_last`` dense."""

    def run(vals, cols, trow, tcol, tval, x_last, b, mask, gamma, coef0, cost, eps, imax):
        q, QA_cost, _ci, matvec, minv = _prepare_sparse_gather_local(
            kernel, mesh, vals, cols, trow, tcol, tval, x_last, mask, float(gamma),
            float(coef0), cost, degree, precond)
        return _solve(matvec, q, QA_cost, b, mask, eps, imax, minv, len(mesh))

    return run
