"""The LS-SVM estimator: learn / predict / accuracy / write_model.

Port of the JAX package's ``models/base.py`` on one device: the algorithm
core ``plssvm::csvm<T>`` (``src/plssvm/csvm.cpp:40-411``) with the device
orchestration of ``gpu_csvm`` (``gpu_csvm.cpp:47-412``).  The learn step is
eager PyTorch on the ``CSVM``'s ``torch.device``: q-vector, QA_cost, the
A·v operator and a host-driven CG loop.  Data at or below
``sparse_threshold`` density keeps its CSR form and takes the JAX
package's sparse tiers (:meth:`CSVM._learn_sparse`, ``models/sparse_learn.py``).

Several devices (``Parameter.devices``, else ``PLSSVM_DEVICES``, else every
visible CUDA device; on the CPU the count asked for is taken as logical
shards of the one device) take the sharded learns of
``parallel/sharded.py``, by the JAX package's rules and under its mode
names: dense data row-sharded (``sharded_<mode>[p]``), or feature-sharded
where each device's slice of the features would still outnumber the rows
(``sharded_feature[p]``; ``PLSSVM_SHARD_AXIS=rows|features`` forces the
axis); sparse data row-sharded as ELL+COO slabs (linear,
``sharded_sparse_linear[p]``), densified onto the dense sharded learn where
dense X fits the budget over all devices, on one device where the Gram
matrix fits, else ringed (``sharded_sparse_implicit[p]``: tiled slabs on K2
panel pairs, or the ``gather`` arm).  With ``checkpoint_path`` or
``verbose_cg`` a dense learn, sharded or not, runs CG in chunks under
:meth:`CSVM._drive_chunked_cg`.

Padding: the CG system of size ``dept = n - 1`` is zero-padded to
``round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))`` on one device and to
``round_up(dept, PAD_SIZE * devices)`` on several, the JAX package's
lengths, so padded CG vectors compare one to one.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import weakref

import numpy as np
import scipy.sparse as sp
import torch

from ..constants import PAD_SIZE, ROW_BLOCK_SIZE
from ..exceptions import PLSSVMError
from ..io.libsvm import ParsedData
from ..io.model import write_model_file
from ..ops import _build
from ..ops.gram_matvec import (gram_matvec, gram_matvec_plain, resolve_tier, row_sqnorms,
                               tier_operands)
from ..ops.kernel_functions import gram_block, kernel_scalar
from ..ops.matvec import (_k_cache_budget_bytes, build_operator, choose_mode,
                          choose_sharded_mode, fixed_tier, jacobi_minv, resolve_mxu_plan,
                          symmetric_enabled, tier_precision, uses_kernels)
from ..ops.sparse import host_tensor, load_csr_rows, stage_csr_rows
from ..params import Parameter
from ..solver import cg as cg_loop
from ..solver.cg import cg_init, cg_run, cg_solve, cg_solve_adaptive
from ..types import BackendType, KernelType, TargetPlatform
from ..utils import timing
from ..utils.timing import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if dtype in _TORCH_DTYPES.values():
        return dtype
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise PLSSVMError(f"Unsupported real type '{dtype}' (float32 or float64)!") from None


class _DenseSystem:
    """The device tensors of a dense learn's padded system: ``X`` (D, f),
    zero beyond the data rows, ``mask``, ``q``, ``QA_cost``, ``cost_inv``,
    the row norms ``sq`` and each tier's operands, and the A·v operators
    built on them (``ops``, by the first learn).  A system kept in its
    layout (``solver.cg.layout``) takes each later learn's values into the
    same tensors, which the layout's CUDA graphs read."""

    def __init__(self, D: int, f: int, dtype: torch.dtype, device: torch.device):
        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.X = zeros(D, f)
        self.mask, self.q, self.sq = zeros(D), zeros(D), zeros(D)
        self.QA_cost, self.cost_inv = zeros(), zeros()
        self.operands: dict = {}
        self.ops: list | None = None

    def load(self, dept: int, staged, b_host: torch.Tensor, x_last: torch.Tensor):
        """Copy a learn's rows ``staged`` into ``X``
        (:func:`~..ops.sparse.load_csr_rows`), zero the rest, set ``mask``;
        returns the zero-padded ``b`` and ``x_last`` on the device."""
        X, dev = self.X, self.X.device
        timing.count("h2d_bytes", b_host.nbytes + x_last.nbytes)
        load_csr_rows(X, dept, staged)
        self.mask.zero_()
        self.mask[:dept] = 1.0
        b = torch.zeros(X.shape[0], dtype=X.dtype, device=dev)
        b[:dept].copy_(b_host, non_blocking=True)
        return b, x_last.to(dev, non_blocking=True)

    def prepare(self, mode: str, tiers: list) -> dict:
        """The row norms, and for the ``implicit`` mode each tier's split or
        cast of ``X`` (``tier_operands``), in the kept tensors; returns the
        operands by tier."""
        self.sq.copy_(row_sqnorms(self.X))
        if mode != "implicit":
            return {}
        for tier in tiers:
            fresh = tier_operands(tier, self.X)
            kept = self.operands.setdefault(tier, fresh)
            for dst, src in zip(kept, fresh):
                if dst is not src:
                    dst.copy_(src)
        return self.operands


class CSVM:
    """Least-Squares SVM solved with Conjugate Gradients.

    Mirrors the public API of ``plssvm::csvm<T>`` (``csvm.hpp:106-179``):
    ``learn``, ``predict``, ``predict_label``, ``accuracy``, ``write_model``.
    """

    def __init__(self, params: Parameter) -> None:
        # ctor validation (csvm.cpp:41-57)
        if params.data is None:
            raise PLSSVMError("No data points provided!")
        if params.data.num_points == 0:
            raise PLSSVMError("Data set is empty!")
        if params.data.num_features == 0:
            raise PLSSVMError("No features provided for the data points!")
        if params.alphas is not None and len(params.alphas) != params.data.num_points:
            raise PLSSVMError(
                f"Number of weights ({len(params.alphas)}) must match the number of "
                f"data points ({params.data.num_points})!"
            )

        self.params = params
        self.kernel = params.kernel
        self.degree = int(params.degree)
        self.gamma = float(params.gamma)
        self.coef0 = float(params.coef0)
        self.cost = float(params.cost)
        self.epsilon = float(params.epsilon)
        self.print_info = bool(params.print_info)
        self.dtype = _torch_dtype(params.dtype)
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.device = self._resolve_device(params.target)
        self.backend = self._resolve_backend(params.backend, self.device)
        self._num_devices()  # an invalid count raises here, not in learn()

        self.data = params.data  # ParsedData (dense + CSR)
        self.values = params.values  # labels (+1/-1) or None
        self.alphas = None if params.alphas is None else np.asarray(params.alphas, np.float64)
        self.bias_ = -float(params.rho)  # csvm.cpp:42
        self.QA_cost_ = 0.0
        self.w_: np.ndarray | None = None
        self.last_cg_info: dict = {}
        self.last_cg_loop: dict = {}
        #: optional sink ``(label, ms)`` (``utils.timing.Timings``) for the
        #: learns' spans: ``setup`` (packing, transfer, operators, and in the
        #: chunked learn the initial residual) and ``cg`` (the solve, or each
        #: chunk), the device synchronised around each; ``None`` takes no
        #: spans and adds no synchronisation unless a ``torch.profiler``
        #: records (``utils.timing.span``)
        self.timings = None

        self.num_data_points = self.data.num_points
        self.num_features = self.data.num_features

        # cached device copy of the support vectors and their row norms
        self._X_all_dev = None
        self._X_all_sq = None
        self._mesh_cache = None
        self._padded_sv_cache = None

    # ------------------------------------------------------- device / backend

    def _num_devices(self) -> int:
        """Devices to span, mirroring the reference's use of every visible
        GPU (``CUDA/csvm.cu:52``; ``base.py:333-348`` of the JAX package):
        ``Parameter.devices``, then ``PLSSVM_DEVICES``, then every visible
        CUDA device, capped at what is visible.  On the CPU the count asked
        for (default one) is taken as logical shards of the one device."""
        visible = torch.cuda.device_count() if self.device.type == "cuda" else None
        try:
            if self.params.devices is not None:
                n = int(self.params.devices)
            else:
                env = os.environ.get("PLSSVM_DEVICES", "")
                n = int(env) if env else (visible or 1)
        except (TypeError, ValueError) as exc:
            raise PLSSVMError(
                f"Invalid device count (Parameter.devices / PLSSVM_DEVICES): "
                f"{exc}"
            ) from None
        return max(1, n if visible is None else min(n, visible))

    def _mesh(self, ndev: int) -> list:
        """The devices of this process, also where a process group spans
        several (the JAX ``CSVM`` would span every process's devices)."""
        from ..parallel.mesh import make_local_mesh

        if self._mesh_cache is None or len(self._mesh_cache) != ndev:
            devices = None if self.device.type == "cuda" else [self.device]
            self._mesh_cache = make_local_mesh(ndev, devices=devices)
        return self._mesh_cache

    def _shard_axis(self, dept: int, f: int, ndev: int) -> str:
        """Partition axis of dense data on several devices
        (``base.py:371-386`` of the JAX package): ``PLSSVM_SHARD_AXIS`` forces
        ``rows`` / ``features``; ``auto`` shards rows unless each device's
        feature slice would still exceed the system size (``f / ndev > D``)."""
        axis = os.environ.get("PLSSVM_SHARD_AXIS", "auto")
        if axis not in ("auto", "rows", "features"):
            raise PLSSVMError(
                f"Invalid PLSSVM_SHARD_AXIS '{axis}' "
                "(expected auto, rows, or features)")
        if axis != "auto":
            return axis
        return "features" if f // ndev > dept else "rows"

    @staticmethod
    def _resolve_device(target: TargetPlatform) -> torch.device:
        if target == TargetPlatform.cpu:
            return torch.device("cpu")
        if torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        if target == TargetPlatform.gpu_nvidia:
            raise PLSSVMError(
                "Target platform 'gpu_nvidia' requested, but no CUDA device is visible!")
        return torch.device("cpu")

    @staticmethod
    def _resolve_backend(backend: BackendType, device: torch.device) -> BackendType:
        on_gpu = device.type == "cuda"
        if backend == BackendType.automatic:
            return BackendType.cuda if on_gpu else BackendType.torch
        if backend == BackendType.cuda and not on_gpu:
            raise PLSSVMError(
                "Backend 'cuda' requested, but the target device is the CPU "
                f"({'no CUDA device is visible' if not torch.cuda.is_available() else 'target platform cpu'})!")
        return backend

    def device_description(self) -> str:
        """Resolved device and backend, as the CLIs print them."""
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "CPU")
        return f"device: {self.device} ({name}), backend: {self.backend}"

    # ------------------------------------------------------------------ learn

    def _use_sparse(self) -> bool:
        """Where the JAX package keeps the CSR representation and takes a
        sparse path (``base.py:327-331``)."""
        return self.data.density <= float(self.params.sparse_threshold)

    def learn(self) -> None:
        """Train: assemble the reduced system and solve with CG
        (``csvm.cpp:207-267``)."""
        if self.values is None:
            raise PLSSVMError(
                "No labels given for training! Maybe the data is only usable for prediction?"
            )
        if self.num_data_points != len(self.values):
            raise PLSSVMError(
                f"Number of labels ({len(self.values)}) must match the number of "
                f"data points ({self.num_data_points})!"
            )

        if not timing.profiling():
            self._learn()
            return
        # profiled: the root span ``learn`` (into ``utils.timing.TRACED``
        # alone, so :attr:`timings` keeps disjoint spans) and the counter
        # ``alloc_segments``, the segments the caching allocator took from
        # CUDA (its ``cudaMalloc`` calls) inside it on every card the learn
        # may span, 0 on the CPU
        cards = self._cards()
        before = self._allocated_segments(cards)
        with span(None, "learn", self.device):
            self._learn()
        timing.count("alloc_segments", self._allocated_segments(cards) - before)

    def _cards(self) -> list:
        """The CUDA devices a learn may span: the CSVM's device alone, or
        the distinct devices of the mesh of :meth:`_num_devices` shards;
        none on the CPU."""
        if self.device.type != "cuda":
            return []
        ndev = self._num_devices()
        return [self.device] if ndev == 1 else list(dict.fromkeys(self._mesh(ndev)))

    @staticmethod
    def _allocated_segments(cards) -> int:
        """``segment.all.allocated`` of the caching allocator, summed over
        ``cards``."""
        return sum(int(torch.cuda.memory_stats(d).get("segment.all.allocated", 0))
                   for d in cards)

    def _learn(self) -> None:
        y = np.asarray(self.values, np.float64)
        n, f = self.data.csr.shape
        dept = n - 1

        if dept == 0:
            # degenerate single-point system: alpha = [0], bias = y[0]
            self.alphas = np.zeros(1)
            self.bias_ = float(y[0])
            self.w_ = None
            return

        start = time.perf_counter()
        loop_before = dict(cg_loop.counts)
        imax = self.params.max_iter if self.params.max_iter is not None else f
        # don't spread a tiny system over devices: rows per shard >= PAD_SIZE
        # (the analog of devices_ = min(device_count, num_features),
        # CUDA/csvm.cu:52, with rows as the scaling axis)
        ndev_req = self._num_devices()
        ndev = min(ndev_req, max(1, dept // PAD_SIZE))
        if (not self._use_sparse() and ndev_req > 1
                and self._shard_axis(dept, f, ndev_req) == "features"):
            # wide dense data (f / p > D): the reference's own multi-GPU split
            # (feature_ranges_, gpu_csvm.cpp:130-157) for all three kernels
            mode, out = self._learn_dense_feature_sharded(dept, f, y, imax, ndev_req)
        elif self._use_sparse() and ndev > 1:
            mode, out = self._learn_sparse_sharded(dept, f, y, imax, ndev)
        elif not self._use_sparse() and ndev > 1:
            # every visible device, as the reference's learn()
            # (gpu_csvm.cpp:130-157)
            mode, out = self._learn_dense_sharded(dept, f, y, imax, ndev)
        else:
            D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            learn = self._learn_sparse if self._use_sparse() else self._learn_dense
            mode, out = learn(D, dept, f, y, imax)
        x, s, t, QA_cost, iters, delta, delta0 = out[:7]
        D = x.shape[0]  # padded system size (depends on the strategy)
        # the learns that take the adaptive plan also return the fast-tier
        # iteration count (== iters on one fixed tier)
        k_fast = int(out[7]) if len(out) > 7 else int(iters)
        x = x.cpu().numpy().astype(np.float64)[:dept]
        s_np = float(s)
        self.QA_cost_ = float(QA_cost)

        # bias = y_last + QA_cost * sum(x) - q.x ; alpha_last = -sum(x)
        # (csvm.cpp:257-258)
        self.bias_ = float(y[-1]) + self.QA_cost_ * s_np - float(t)
        self.alphas = np.concatenate([x, [-s_np]])
        self.w_ = None
        self.last_cg_info = {
            "iterations": int(iters),
            "delta": float(delta),
            "delta0": float(delta0),
            "mode": mode,
            "dept": dept,
            "padded": D,
            # adaptive two-tier CG: iterations spent on the fast tier before
            # (possible) escalation to the accurate tier
            "fast_iterations": k_fast,
            "escalated": int(iters) > k_fast,
        }
        # the device loop of solver/cg.py (no counterpart in the JAX
        # package's last_cg_info): steps issued (eager steps and chunk slots,
        # masked no-ops after the stop included), steps executed, host reads,
        # the last run's chunk size, and whether the loop replayed CUDA graphs
        self.last_cg_loop = {
            "steps": cg_loop.counts["steps"] - loop_before["steps"],
            "executed": cg_loop.counts["executed"] - loop_before["executed"],
            "host_reads": cg_loop.counts["host_reads"] - loop_before["host_reads"],
            "chunk": cg_loop.last_run["chunk"],
            "graph": cg_loop.counts["replays"] > loop_before["replays"],
        }

        if self.print_info:
            elapsed = (time.perf_counter() - start) * 1000.0
            print(
                f"Finished after {int(iters)} iterations with a residuum of "
                f"{float(delta)} (target: {self.epsilon**2 * float(delta0)})."
            )
            if self.last_cg_info["escalated"]:
                print(
                    f"Adaptive precision: {k_fast} iterations on the fast bf16 tier, "
                    f"{int(iters) - k_fast} after escalating to the accurate tier."
                )
            print(f"Solved minimization problem (r = b - Ax) using CG in {elapsed:.0f}ms.")

    def _padded_vectors(self, D, dept, y):
        b_pad = np.zeros(D, dtype=self._np_dtype)
        b_pad[:dept] = y[:dept] - y[-1]  # b = y[:-1] - y[-1] (csvm.cpp:236-240)
        mask = np.zeros(D, dtype=self._np_dtype)
        mask[:dept] = 1.0
        return b_pad, mask

    def _to_device(self, a: np.ndarray, device=None) -> torch.Tensor:
        """``a`` in the learn's dtype on ``device`` (default: the CSVM's),
        its bytes added to the counter ``h2d_bytes``."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=self._np_dtype))
        timing.count("h2d_bytes", t.nbytes)
        return t.to(self.device if device is None else device)

    @contextlib.contextmanager
    def _span(self, label: str, device=None):
        """A timed span (``utils.timing.span``) into :attr:`timings` and,
        while a profiler records, ``utils.timing.TRACED``, the device
        synchronised around it; nothing where neither is on.  A ``cg`` span
        also records its part ``cg/capture``: the CUDA-graph warm-up steps
        and captures that ran inside it (``solver.cg.spent``)."""
        traced = timing.profiling()
        if self.timings is None and not traced:
            yield
            return
        before = cg_loop.spent["capture_ms"]
        with span(self.timings, label, self.device if device is None else device):
            yield
        if label == "cg":
            timing.record(self.timings, "cg/capture", cg_loop.spent["capture_ms"] - before,
                          traced)

    def _dense_system(self, D, dept, f, y, mode, tiers):
        """The padded system of a dense learn on the device: ``(b, m, q,
        QA_cost, minv, ops)`` with ``ops`` the A·v operators at ``tiers``
        (``None``: the backend's fixed tier).  Sparse data (the sparse
        ``dense`` tier) is densified on the device from its CSR rows.

        The parts of the ``setup`` span: ``load`` (the kernel library,
        built or loaded by a process's first learn that launches kernels;
        ``ops/_build.load``), ``pad`` (the rows in page-locked host
        memory, in the learn's dtype), ``h2d`` (the zero-padded system on
        the device and the copies into it), ``operands`` (the row norms and
        each tier's split or cast, once for all operators) and ``system``
        (q, QA_cost, the Jacobi preconditioner).  An ``implicit`` system
        keeps its tensors and operators in its layout
        (:func:`~..solver.cg.layout`): a later learn of the layout writes
        into the same tensors, so its CG replays the step graphs captured on
        them (:class:`_DenseSystem`)."""
        kw = {"degree": self.degree, "gamma": self.gamma, "coef0": self.coef0}
        with self._span("setup/load"):
            if uses_kernels(self.backend, self.dtype):
                _build.load()  # built or loaded once per process
        with self._span("setup/pad"):
            if self._use_sparse():
                x_last = self.data.csr[-1].toarray().ravel()
                staged = stage_csr_rows(self.data.csr, dept, self.dtype, self.device)
            else:
                rows = self.data.stored_rows()
                rows = self.data.dense if rows is None else rows
                x_last, staged = rows[-1], (host_tensor(rows[:dept], self.dtype, self.device),)
            x_last = host_tensor(x_last, self.dtype, self.device)
            b_host = host_tensor(y[:dept] - y[-1], self.dtype, self.device)  # csvm.cpp:236-240
        # the operators' tiers as they resolve now (a fixed tier follows
        # PLSSVM_MATMUL_PRECISION, read when called)
        resolved = [resolve_tier(fixed_tier(self.backend) if t is None else t, self.dtype)
                    for t in tiers]
        key = ("dense", D, f, self.dtype, self.device, int(self.kernel), self.degree,
               self.gamma, self.coef0, mode, tuple(resolved), str(self.backend),
               symmetric_enabled())
        kept = cg_loop.layout(key, self.device) if mode == "implicit" else None
        system = None if kept is None else kept.buffers
        if system is None:
            system = _DenseSystem(D, f, self.dtype, self.device)
        with self._span("setup/h2d"):
            b, x_last = system.load(dept, staged, b_host, x_last)
        with self._span("setup/operands"):
            operands = system.prepare(mode, resolved)
        with self._span("setup/system"):
            cost_inv = (torch.tensor(1.0, dtype=self.dtype, device=self.device)
                        / torch.tensor(self.cost, dtype=self.dtype, device=self.device))
            X, m, sq = system.X, system.mask, system.sq
            # q_i = k(x_i, x_last)  (q_kernel.cu:16-49); padding rows masked out
            q = gram_block(self.kernel, X, x_last[None, :], Xi_sqnorm=sq, **kw)[:, 0] * m
            # QA_cost = k(x_last, x_last) + 1/C  (csvm.cpp:243)
            QA_cost = kernel_scalar(self.kernel, x_last, x_last, **kw) + cost_inv
            minv = None
            if self.params.precond == "jacobi":
                minv = jacobi_minv(self.kernel, X, q, m, QA_cost, cost_inv,
                                   self.degree, self.gamma, self.coef0, sq=sq)
            system.q.copy_(q)
            system.QA_cost.copy_(QA_cost)
            system.cost_inv.copy_(cost_inv)
        if system.ops is None:
            system.ops = [build_operator(self.kernel, X, system.q, m, system.QA_cost,
                                         system.cost_inv, mode=mode, backend=self.backend,
                                         precision=tier, sq=sq, operands=operands.get(tier),
                                         **kw) for tier in resolved]
            if kept is not None:
                for op in system.ops:
                    op.matvec.layout = weakref.ref(kept)
                kept.buffers = system
        return b, m, system.q, system.QA_cost, minv, system.ops

    def _learn_dense(self, D, dept, f, y, imax, mode=None):
        """The body of the JAX package's ``_learn_jit`` (``base.py:44-92``)
        as eager torch: q-vector, QA_cost, operator, CG.  ``mode`` forces the
        operator's mode (the sparse ``dense`` tier runs ``implicit``,
        ``base.py:871-879``).  Where
        :func:`~..ops.matvec.resolve_mxu_plan` gives a plan, the operator is
        built at its two tiers and CG runs
        :func:`~..solver.cg.cg_solve_adaptive` (``base.py:76-88``).  With a
        checkpoint path or ``verbose_cg`` the chunked CG loop runs instead, on
        the fixed tier (``base.py:539-544``): a checkpoint's state does not
        depend on a tier, and the adaptive solve is one uninterrupted run.
        The system and operators are the ``setup`` span of :attr:`timings`,
        the solve the ``cg`` span."""
        if mode is None:
            mode = choose_mode(self.kernel, dept, self.dtype, num_features=f,
                               backend=self.backend)
        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            return self._learn_dense_checkpointed(D, dept, f, y, imax, mode)
        plan = resolve_mxu_plan(mode, self.dtype, self.backend)
        tiers = [None] if plan is None else [tier_precision(t) for t in plan]
        with self._span("setup"):
            b, m, q, QA_cost, minv, ops = self._dense_system(D, dept, f, y, mode, tiers)
        with self._span("cg"):
            if plan is None:
                res = cg_solve(ops[0].matvec, b, m, self.epsilon, imax, minv=minv)
                k_fast = res.iterations
            else:
                res = cg_solve_adaptive(ops[0].matvec, ops[1].matvec, b, m, self.epsilon,
                                        imax, minv=minv)
                k_fast = res.fast_iterations
        s = torch.sum(res.x)
        t = torch.dot(q, res.x)
        return mode, (res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0, k_fast)

    def _learn_dense_checkpointed(self, D, dept, f, y, imax, mode):
        """Dense learn with periodic CG-state checkpoints (resume-capable)
        and optional per-iteration output (``base.py:556-587`` of the JAX
        package; an extension over the reference, whose only checkpoint is
        the final model file).  ``cg_init`` is the set-up and ``cg_run`` to
        ``imax_end`` a chunk, Jacobi ``minv`` in both.  The operator is built
        once and shared by every chunk: a rebuild per chunk would redo the
        ``cached`` mode's K every interval."""
        with self._span("setup"):
            b, m, q0, QA0, minv, ops = self._dense_system(D, dept, f, y, mode, [None])
            matvec = ops[0].matvec

        def setup():
            return q0, QA0, cg_init(matvec, b, m, minv=minv)

        def chunk(q, QA_cost, imax_end, state):
            return cg_run(matvec, b, m, self.epsilon, imax_end, state, minv=minv)

        q, QA_cost, state = self._drive_chunked_cg(setup, chunk, imax, dept)
        s = torch.sum(state.x)
        t = torch.dot(q, state.x)
        return mode, (state.x, s, t, QA_cost, state.k, state.delta, state.delta0)

    def _drive_chunked_cg(self, setup, chunk, imax, dept, device=None):
        """Host-side chunked CG loop shared by the dense and the sharded
        learns (``base.py:491-528`` of the JAX package): periodic checkpoints
        and optional per-iteration residual output
        (``gpu_csvm.cpp:245-247``).  ``setup() -> (q, QA_cost, state)``;
        ``chunk(q, QA_cost, imax_end, state) -> state``.  A checkpoint's
        tensors are loaded onto ``device`` (default: the CSVM's) in the
        learn's dtype, its ``k`` exactly, so the 50-step residual refresh
        falls where it would have without the interruption."""
        from ..solver.checkpoint import load_cg_checkpoint, save_cg_checkpoint

        device = self.device if device is None else device
        path = self.params.checkpoint_path
        interval = max(1, int(self.params.checkpoint_interval))
        if self.params.verbose_cg:
            interval = 1  # per-iteration residual output (gpu_csvm.cpp:245-247)

        loaded = None
        if path is not None:
            loaded = load_cg_checkpoint(path, device=device, dtype=self.dtype)
        if loaded is not None:
            state, q, QA_cost, meta = loaded
            if (int(meta.get("dept", -1)) != dept
                    or int(meta.get("kernel", -1)) != int(self.kernel)):
                raise PLSSVMError(
                    f"Checkpoint '{path}' does not match this training problem!"
                )
            if self.print_info:
                print(f"Resumed CG from checkpoint '{path}' at iteration {int(state.k)}.")
        else:
            with self._span("setup", device):
                q, QA_cost, state = setup()

        target = float(self.epsilon) ** 2 * float(state.delta0)
        meta = {"dept": dept, "kernel": int(self.kernel)}
        # float(state.delta) waits for the device: once per chunk boundary
        while int(state.k) < imax and float(state.delta) > target:
            if self.params.verbose_cg and self.print_info:
                # reference per-iteration line (gpu_csvm.cpp:245-247)
                print(
                    f"Start Iteration {int(state.k) + 1} (max: {imax}) with current "
                    f"residuum {float(state.delta)} (target: {target}). "
                )
            end = min(int(state.k) + interval, imax)
            with self._span("cg", device):
                state = chunk(q, QA_cost, end, state)
            if path is not None:
                save_cg_checkpoint(path, state, q, QA_cost, meta)
        return q, QA_cost, state

    def _learn_dense_sharded(self, dept, f, y, imax, ndev):
        """Row-sharded multi-device learn (``parallel/sharded.py``;
        ``base.py:439-489`` of the JAX package): no new flags, the same
        outputs, the twin of the reference's multi-device ``learn()``
        (``gpu_csvm.cpp:130-157``)."""
        from ..parallel.sharded import (make_sharded_learn, make_sharded_learn_fns,
                                        shard_system)

        # every shard PAD_SIZE-aligned; the kernels mask ragged tiles themselves
        D = _round_up(dept, PAD_SIZE * ndev)
        b_pad, mask = self._padded_vectors(D, dept, y)
        X = self.data.dense
        X_pad = np.zeros((D, f), dtype=self._np_dtype)
        X_pad[:dept] = X[:dept]
        mode = choose_sharded_mode(self.kernel, dept, self.dtype, ndev, num_features=f,
                                   backend=self.backend)
        mesh = self._mesh(ndev)
        with self._span("setup", mesh):
            Xs, b, m = shard_system(mesh, X_pad, b_pad, mask)
            x_last = self._to_device(X[-1], mesh[0])
        precond = str(self.params.precond)
        mode_name = f"sharded_{mode}[{ndev}]"

        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            fns = make_sharded_learn_fns(mesh, self.kernel, self.degree, mode,
                                         backend=self.backend, precond=precond)
            return mode_name, self._learn_sharded_chunked(fns, Xs, x_last, b, m, imax, dept,
                                                          mesh[0])

        learn = make_sharded_learn(
            mesh, self.kernel, self.degree, mode, backend=self.backend, precond=precond,
            mxu_plan=resolve_mxu_plan(mode, self.dtype, self.backend),
            span=functools.partial(self._span, device=mesh))
        return mode_name, learn(Xs, x_last, b, m, self.gamma, self.coef0, self.cost,
                                self.epsilon, imax)

    def _learn_dense_feature_sharded(self, dept, f, y, imax, ndev):
        """Feature-sharded multi-device learn (``base.py:388-437`` of the JAX
        package): the features of the padded system, padded with zeros to a
        multiple of ``ndev``, split over the mesh; with a checkpoint path or
        ``verbose_cg`` CG runs in chunks."""
        from ..parallel.sharded import (make_feature_sharded_learn,
                                        make_feature_sharded_learn_fns, shard_system_feature)

        D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
        b_pad, mask = self._padded_vectors(D, dept, y)
        fp = _round_up(f, ndev)
        X = self.data.dense
        X_pad = np.zeros((D, fp), dtype=self._np_dtype)
        X_pad[:dept, :f] = X[:dept]
        x_last = np.zeros(fp, dtype=self._np_dtype)
        x_last[:f] = X[-1]
        mesh = self._mesh(ndev)
        with self._span("setup", mesh):
            Xs, x_lasts, b, m = shard_system_feature(mesh, X_pad, x_last, b_pad, mask)
        precond = str(self.params.precond)
        mode_name = f"sharded_feature[{ndev}]"
        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            fns = make_feature_sharded_learn_fns(mesh, self.kernel, self.degree, precond=precond)
            return mode_name, self._learn_sharded_chunked(fns, Xs, x_lasts, b, m, imax, dept,
                                                          mesh[0])
        learn = make_feature_sharded_learn(mesh, self.kernel, self.degree, precond=precond,
                                           span=functools.partial(self._span, device=mesh))
        return mode_name, learn(Xs, x_lasts, b, m, self.gamma, self.coef0, self.cost,
                                self.epsilon, imax)

    def _learn_sharded_chunked(self, fns, Xs, x_last, b, m, imax, dept, home):
        """The chunked arm of the dense sharded learns: ``fns = (setup,
        chunk)`` of ``parallel/sharded.py`` under :meth:`_drive_chunked_cg`,
        ``sum(x)`` and ``q.x`` taken on the host in float64, as the JAX
        package does (``base.py:423-428, 475-480``)."""
        setup_fn, chunk_fn = fns
        scalars = (self.gamma, self.coef0, self.cost)

        def setup():
            return setup_fn(Xs, x_last, b, m, *scalars)

        def chunk(q, QA_cost, imax_end, state):
            return chunk_fn(Xs, b, m, x_last, *scalars, self.epsilon, imax_end, state)

        q, QA_cost, state = self._drive_chunked_cg(setup, chunk, imax, dept, device=home)
        x_np = state.x.cpu().numpy().astype(np.float64)
        t = q.cpu().numpy().astype(np.float64) @ x_np
        return state.x, x_np.sum(), t, QA_cost, state.k, state.delta, state.delta0

    # ----------------------------------------------------------- sparse learn

    def _plan_sparse_panel(self, csr, dept, D, ndev: int = 1):
        """``(TiledHybrid, use_cuda, sweep)`` when the streaming ``panel``
        strategy applies at this density and packing, else ``None``
        (``base.py:694-754``): the density pre-check, the skew-robust
        packing, the half-dense guard, and the sweep schedule with its
        memory envelope.  ``use_cuda`` is ``ops.matvec.uses_kernels`` (the
        JAX package's ``use_pallas``, ``base.py:751-753``): the panel pairs
        run K1/K3 on the ``cuda`` backend at float32, their plain versions
        on the ``torch`` backend and for float64.  Each pair splits or casts
        its two panels itself and drops the copies with the pair, so the
        bf16 tiers add at most two panels' bytes to the sweep and the 4x
        envelope stands.

        ``ndev > 1`` plans the panel ring: the packing is built on the host,
        to be sharded, and the envelope applies to each device's ``1/ndev``
        share (its own panels and the one in flight), as if each shard had
        a device of its own."""
        from ..ops.sparse import TiledHybrid, panel_sweep_strategy, streaming_stream_strategy

        f = csr.shape[1]
        L_est = max(1, -(-int(csr.indptr[dept]) // max(1, dept)))
        if streaming_stream_strategy(L_est, f) != "panel":
            return None
        th = TiledHybrid.from_csr(csr[:dept], dtype=self._np_dtype, pad_rows=D,
                                  device=self.device if ndev == 1 else "cpu")
        itemsize = self.dtype.itemsize
        dense_bytes = D * th.tell.padded_features * itemsize
        packed_bytes = th.tell.vals.numel() * (itemsize + 4) + th.heavy.numel() * itemsize
        # a packing at >= half the padded-dense size is not sparse enough (or
        # too skewed for the heavy-row spill): the gather arm is memory-safe
        if 2 * packed_bytes > dense_bytes:
            return None
        physical = self._device_memory_bytes()
        use_cuda = uses_kernels(self.backend, self.dtype)
        if ndev > 1:
            if 4 * dense_bytes // ndev > physical:
                return None
            return th, use_cuda, "unrolled"
        sweep = panel_sweep_strategy(2, dense_bytes, physical)
        if sweep == "unrolled":
            if 4 * dense_bytes > physical:
                return None  # forced unrolled beyond its envelope
        else:
            eff_budget = min(_k_cache_budget_bytes(), physical // 3)
            if packed_bytes + eff_budget > (9 * physical) // 10:
                return None
        return th, use_cuda, sweep

    def _device_memory_bytes(self) -> int:
        """Physical memory of the CSVM's device: the card's total on CUDA,
        else ample (1 << 40, the JAX package's host fallback)."""
        if self.device.type == "cuda":
            return int(torch.cuda.mem_get_info(self.device)[1])
        return 1 << 40

    def _sparse_fit(self, D: int, f: int, ndev: int = 1) -> tuple:
        """``(PLSSVM_SPARSE_MODE, gram_fits, dense_x_fits)`` at ``D`` rows of
        ``f`` features on ``ndev`` devices: the Gram within the K-cache budget
        and, on one device, twice it (K and its transient) within memory; X
        within the devices' budgets, and 5/2 a device's share within its
        memory (the JAX package's factors)."""
        itemsize = self.dtype.itemsize
        budget, physical = _k_cache_budget_bytes(), self._device_memory_bytes()
        gram_bytes, x_bytes = D * D * itemsize, D * f * itemsize
        gram_fits = gram_bytes <= budget and (ndev > 1 or 2 * gram_bytes <= physical)
        dense_x_fits = x_bytes <= budget * ndev and 5 * x_bytes // (2 * ndev) <= physical
        return os.environ.get("PLSSVM_SPARSE_MODE", "auto"), gram_fits, dense_x_fits

    def _reject_chunk_flags_on_sparse(self):
        """Sparse learns cannot chunk CG for checkpoints / per-iteration
        output (``base.py:784-791``)."""
        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            raise PLSSVMError(
                "--checkpoint/--verbose_cg are not supported on the sparse "
                "learn path; set sparse_threshold=0 to force the dense path"
            )

    def _learn_sparse_sharded(self, dept, f, y, imax, ndev):
        """Sparse data on ``ndev`` devices (``base.py:589-692`` of the JAX
        package), the first arm that applies:

        1. linear: the row-sharded ELL+COO learn, ``sharded_sparse_linear[p]``;
        2. dense X within the K-cache budget of all devices together, and
           each device's share with its bf16 operands within its memory:
           densify and take the dense sharded learn;
        3. the (D, D) Gram within the budget (wide data), or a forced
           ``PLSSVM_SPARSE_MODE``: the one-device sparse tiers;
        4. a panel plan (:meth:`_plan_sparse_panel` with ``ndev``): the panel
           ring, else the ``gather`` ring, both ``sharded_sparse_implicit[p]``.

        The ring arms refuse the chunked-CG flags, as the sparse tiers do."""
        from ..ops.sparse import stream_panel_rows
        from ..parallel.sharded import (make_sharded_sparse_linear_learn,
                                        make_sharded_sparse_panel_learn,
                                        make_sharded_sparse_streaming_learn,
                                        shard_sparse_tiled_system)

        precond = str(self.params.precond)
        if self.kernel == KernelType.linear:
            self._reject_chunk_flags_on_sparse()
            mesh, system, x_last = self._sparse_sharded_system(dept, y, ndev)
            learn = make_sharded_sparse_linear_learn(mesh, precond=precond)
            return (f"sharded_sparse_linear[{ndev}]",
                    learn(*system[:5], x_last, *system[5:], self.cost, self.epsilon, imax))

        itemsize = self.dtype.itemsize
        D = _round_up(dept, PAD_SIZE * ndev)
        budget = _k_cache_budget_bytes()
        sparse_mode, gram_fits, dense_x_fits = self._sparse_fit(D, f, ndev)
        if sparse_mode == "auto" and dense_x_fits:
            return self._learn_dense_sharded(dept, f, y, imax, ndev)
        if sparse_mode != "auto" or gram_fits:
            D1 = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            return self._learn_sparse(D1, dept, f, y, imax)

        self._reject_chunk_flags_on_sparse()
        mode_name = f"sharded_sparse_implicit[{ndev}]"
        scalars = (self.gamma, self.coef0, self.cost, self.epsilon, imax)
        plan = self._plan_sparse_panel(self.data.csr, dept, D, ndev=ndev)
        if plan is not None:
            th = plan[0]
            mesh = self._mesh(ndev)
            b_pad, mask = self._padded_vectors(D, dept, y)
            tvals, tlcols, heavy, hrow, b, m = shard_sparse_tiled_system(mesh, th, b_pad, mask)
            learn = make_sharded_sparse_panel_learn(
                mesh, self.kernel, self.degree, ntiles=th.tell.ntiles, Lt=th.tell.Lt,
                panel_rows=stream_panel_rows(D // ndev, th.tell.padded_features, itemsize,
                                             budget),
                precond=precond, backend=self.backend)
            return mode_name, learn(tvals, tlcols, heavy, hrow, self._sparse_x_last(mesh[0]), b,
                                    m, *scalars)
        mesh, system, x_last = self._sparse_sharded_system(dept, y, ndev)
        learn = make_sharded_sparse_streaming_learn(mesh, self.kernel, self.degree,
                                                    precond=precond)
        return mode_name, learn(*system[:5], x_last, *system[5:], *scalars)

    def _sparse_x_last(self, device) -> torch.Tensor:
        """The last data point, dense, on ``device``."""
        return self._to_device(self.data.csr[-1].toarray().ravel(), device)

    def _sparse_sharded_system(self, dept, y, ndev):
        """``(mesh, system, x_last)`` of the sparse linear and gather rings
        (``base.py:793-804``): the first ``dept`` rows packed ELL+COO on the
        host, padded to a multiple of ``PAD_SIZE * ndev`` rows and sharded
        (:func:`~..parallel.sharded.shard_sparse_system`)."""
        from ..ops.sparse import HybridSparse
        from ..parallel.sharded import shard_sparse_system

        D = _round_up(dept, PAD_SIZE * ndev)
        b_pad, mask = self._padded_vectors(D, dept, y)
        h = HybridSparse.from_csr(self.data.csr[:dept], dtype=self._np_dtype, pad_rows=D)
        mesh = self._mesh(ndev)
        return mesh, shard_sparse_system(mesh, h, b_pad, mask), self._sparse_x_last(mesh[0])

    def _learn_sparse(self, D, dept, f, y, imax):
        """The sparse tiers of ``base.py:806-968``.  Linear: the ELL+COO
        learn.  Poly/rbf, the fastest tier that fits, each guarded by the
        K-cache budget and the device's physical memory:

        1. ``gram``: the (D, D) Gram assembled once, cached GEMV CG;
        2. ``dense``: dense X only, the dense ``implicit`` learn (K1 on the
           ``cuda`` backend);
        3. ``implicit``: streaming CG from the packing, through transient
           dense panels on K1/K3 (``panel``) or the ELL ``gather`` arm.

        ``PLSSVM_SPARSE_MODE`` forces ``gram`` / ``dense`` / ``implicit``
        (the rules: :meth:`_sparse_fit`).  The host packing and the device
        set-up are ``setup`` spans of :attr:`timings`, the solve the ``cg``
        span."""
        from ..ops.sparse import HybridSparse, stream_panel_rows
        from .sparse_learn import (learn_gram, learn_sparse_implicit, learn_sparse_linear,
                                   learn_sparse_panel)

        self._reject_chunk_flags_on_sparse()
        precond = str(self.params.precond)
        csr = self.data.csr
        dev, np_dtype = self.device, self._np_dtype
        itemsize = self.dtype.itemsize
        sparse_mode, gram_fits, dense_x_fits = self._sparse_fit(D, f)
        if self.kernel != KernelType.linear and (
                sparse_mode == "dense"
                or (sparse_mode == "auto" and not gram_fits and dense_x_fits)):
            _, out = self._learn_dense(D, dept, f, y, imax, mode="implicit")
            return "sparse_dense_implicit", out
        with self._span("setup"):
            b_pad, mask = self._padded_vectors(D, dept, y)
            b, m = self._to_device(b_pad), self._to_device(mask)
            x_last = self._to_device(csr[-1].toarray().ravel())
        common = (self.cost, self.epsilon, imax)
        if self.kernel == KernelType.linear:
            with self._span("setup"):
                h = HybridSparse.from_csr(csr[:dept], dtype=np_dtype, pad_rows=D, device=dev)
                xt = HybridSparse.from_csr(csr[:dept].T.tocsr(), dtype=np_dtype, device=dev)
            out = learn_sparse_linear(h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols,
                                      h.coo_vals, x_last, b, m, *common, f=f, xt=xt,
                                      precond=precond, span=self._span)
            return "sparse_linear", out

        if sparse_mode == "implicit" or (sparse_mode != "gram" and not gram_fits):
            with self._span("setup"):
                plan = self._plan_sparse_panel(csr, dept, D)
            if plan is not None:
                th, use_cuda, sweep = plan
                budget = _k_cache_budget_bytes()
                if sweep == "windowed":
                    # the windowed transient follows the budget; cap it so the
                    # panels and the resident packing stay inside the device
                    budget = min(budget, self._device_memory_bytes() // 3)
                panel_rows = stream_panel_rows(D, th.tell.padded_features, itemsize, budget)
                with self._span("setup"):
                    # the heavy rows' O(n) vectors, built on the host
                    hs = np.zeros(D, dtype=np_dtype)
                    hg = np.zeros(D, dtype=np_dtype)
                    if len(th.heavy_idx):
                        hrows = csr[th.heavy_idx]
                        hs[th.heavy_idx] = np.asarray(hrows.multiply(hrows).sum(axis=1)).ravel()
                        hg[th.heavy_idx] = np.asarray((hrows @ csr[-1].T).todense()).ravel()
                out = learn_sparse_panel(
                    th.tell.vals, th.tell.lcols, x_last, b, m, self.gamma, self.coef0,
                    *common, kernel=self.kernel, degree=self.degree, ntiles=th.tell.ntiles,
                    Lt=th.tell.Lt, panel_rows=panel_rows, precond=precond, use_cuda=use_cuda,
                    heavy=th.heavy, heavy_rows=tuple(int(r) for r in th.heavy_idx),
                    heavy_sq_vec=self._to_device(hs), heavy_g_vec=self._to_device(hg),
                    mxu_plan=resolve_mxu_plan("implicit", self.dtype, self.backend),
                    sweep=sweep, span=self._span)
                return "sparse_implicit", out
            with self._span("setup"):
                h = HybridSparse.from_csr(csr[:dept], dtype=np_dtype, pad_rows=D, device=dev)
            out = learn_sparse_implicit(h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols,
                                        h.coo_vals, x_last, b, m, self.gamma, self.coef0,
                                        *common, kernel=self.kernel, degree=self.degree, f=f,
                                        precond=precond, span=self._span)
            return "sparse_implicit", out

        out = learn_gram(csr, D, dept, f, x_last, b, m, self.gamma, self.coef0, *common,
                         kernel=self.kernel, degree=self.degree, precond=precond,
                         backend=self.backend, dense_x_fits=dense_x_fits, span=self._span)
        return "sparse_gram", out

    # ---------------------------------------------------------------- predict

    def _X_all_device(self) -> torch.Tensor:
        if self._X_all_dev is None:
            self._X_all_dev = self._to_device(self.data.dense)
            self._X_all_sq = row_sqnorms(self._X_all_dev)
        return self._X_all_dev

    def _padded_sv(self, ndev: int):
        """Support vectors and alphas as ``ndev`` row blocks on the mesh,
        zero-padded so the axis splits evenly (padding rows carry zero
        alphas: harmless).  The support vectors' blocks are kept."""
        from ..parallel.sharded import shard_rows

        n, f = self.num_data_points, self.num_features
        Np = _round_up(n, ndev * 8)
        mesh = self._mesh(ndev)
        if self._padded_sv_cache is None or self._padded_sv_cache[0] != Np:
            X_sv = np.zeros((Np, f), dtype=self._np_dtype)
            X_sv[:n] = self.data.dense
            self._padded_sv_cache = (Np, shard_rows(mesh, X_sv))
        a_sv = np.zeros(Np, dtype=self._np_dtype)
        a_sv[:n] = self.alphas
        return self._padded_sv_cache[1], shard_rows(mesh, a_sv)

    def _check_points(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, np.float64)
        if points.ndim == 1:
            points = points[None, :]
        if points.shape[1] != self.num_features:
            raise PLSSVMError(
                f"Number of features per data point ({self.num_features}) must match "
                f"the number of features per predict point ({points.shape[1]})!"
            )
        return points

    def predict(self, points) -> np.ndarray:
        """Raw decision values (``gpu_csvm.cpp:52-127``).  While a profiler
        records, the root span ``predict`` with its parts ``stage`` (the
        float64 check, the alphas and points on the device), ``kernel``
        (K2, its plain version, the cross Gram or ``w``) and ``d2h`` (the
        decision values back in float64)."""
        with span(None, "predict", self.device):
            with span(None, "predict/stage", self.device):
                points = np.asarray(points, np.float64)
                single = points.ndim == 1
                if points.size == 0 and not single:
                    return np.zeros(0)
                points = self._check_points(points)
                if self.alphas is None:
                    raise PLSSVMError("No alphas provided for prediction!")
                alphas_dev = self._to_device(self.alphas)
                ndev = self._num_devices()
                expansion = self.kernel != KernelType.linear and not self._use_sparse()
                P = self._to_device(points) if expansion else None
            with span(None, "predict/kernel", self.device):
                out = self._decision_values(points, P, alphas_dev, ndev)
            with span(None, "predict/d2h", self.device):
                if isinstance(out, torch.Tensor):
                    out = out.cpu().numpy().astype(np.float64)
        return out[0] if single else out

    def _decision_values(self, points, P, alphas_dev, ndev):
        """The decision values of :meth:`predict`: a device tensor, or a
        host array where they are made on the host (``w``)."""
        if self.kernel == KernelType.linear:
            # w fast path (gpu_csvm.cpp:83-91)
            if self.w_ is None:
                if self._use_sparse():
                    # w = X^T alpha through sparse BLAS; X never densifies
                    self.w_ = np.asarray(self.data.csr.T @ self.alphas, np.float64).ravel()
                elif ndev > 1:
                    # multi-device update_w (gpu_csvm.cpp:327-350): each shard
                    # contracts its row slice, the partials are summed
                    from ..parallel.sharded import make_sharded_w

                    Xs_sv, a_sv = self._padded_sv(ndev)
                    w = make_sharded_w(self._mesh(ndev))(Xs_sv, a_sv)
                    self.w_ = w.cpu().numpy().astype(np.float64)
                else:
                    w = self._X_all_device().T @ alphas_dev
                    self.w_ = w.cpu().numpy().astype(np.float64)
            return points @ self.w_ + self.bias_
        if self._use_sparse():
            # kernel expansion from a cross Gram assembled on the host
            csr = self.data.csr
            Gc = np.asarray((csr @ points.T).T, np.float64)
            sq_sv = np.asarray(csr.multiply(csr).sum(axis=1)).ravel()
            return self._predict_cross_gram(Gc, np.sum(points * points, axis=1), sq_sv)
        if ndev > 1:
            # multi-device kernel expansion: the support-vector axis sharded,
            # the decision values summed (gpu_csvm.cpp:52-127 over all devices)
            from ..parallel.sharded import make_sharded_predict

            mesh = self._mesh(ndev)
            Xs_sv, a_sv = self._padded_sv(ndev)
            bias = torch.as_tensor(self.bias_, dtype=self.dtype, device=mesh[0])
            run = make_sharded_predict(mesh, self.kernel, self.degree, backend=self.backend)
            return run(P.to(mesh[0]), Xs_sv, a_sv, bias, self.gamma, self.coef0)
        X_sv = self._X_all_device()
        kw = {"Y": X_sv, "degree": self.degree, "gamma": self.gamma,
              "coef0": self.coef0, "sqy": self._X_all_sq}
        if uses_kernels(self.backend, self.dtype):
            Kv = gram_matvec(self.kernel, P, alphas_dev, **kw)  # K2
        else:
            # float64 and the torch backend stay on gram_block + matmul
            # (base.py:1073-1086 keeps f64 off the kernel)
            Kv = gram_matvec_plain(self.kernel, P, alphas_dev, **kw)
        return Kv + torch.as_tensor(self.bias_, dtype=self.dtype, device=self.device)

    def predict_label(self, points) -> np.ndarray:
        """sign(predict) (``csvm.cpp:343-366``; sign(0) = -1,
        ``operators.hpp:174-177``)."""
        values = self.predict(points)
        return np.where(np.asarray(values) > 0.0, 1.0, -1.0)

    def _predict_cross_gram(self, Gc, sq_points, sq_sv) -> torch.Tensor:
        """Decision values, on the device, from a host cross Gram ``Gc[p, i]
        = <p, x_i>`` (``base.py:1037-1056``): transform and expansion on the
        device."""
        from .sparse_learn import predict_from_cross_gram

        return predict_from_cross_gram(
            self._to_device(Gc), self._to_device(sq_points), self._to_device(sq_sv),
            self._to_device(self.alphas),
            torch.as_tensor(self.bias_, dtype=self.dtype, device=self.device),
            self.gamma, self.coef0, kernel=self.kernel, degree=self.degree)

    def predict_parsed(self, parsed) -> np.ndarray:
        """Predict a :class:`~..io.libsvm.ParsedData` batch, staying sparse
        when both the support vectors and the points are at or below
        ``sparse_threshold`` (``base.py:1095-1134``): neither is densified."""
        if self.alphas is None:
            raise PLSSVMError("No alphas provided for prediction!")
        if parsed.num_features != self.num_features:
            raise PLSSVMError(
                f"Number of features per data point ({self.num_features}) must match "
                f"the number of features per predict point ({parsed.num_features})!"
            )
        sparse_points = parsed.density <= float(self.params.sparse_threshold)
        if not (self._use_sparse() and sparse_points):
            return self.predict(parsed.dense)

        from ..ops.sparse import host_cross_gram_from_csr

        csr_p, csr = parsed.csr, self.data.csr
        if self.kernel == KernelType.linear:
            if self.w_ is None:
                self.w_ = np.asarray(csr.T @ self.alphas, np.float64).ravel()
            return np.asarray(csr_p @ self.w_, np.float64).ravel() + self.bias_
        Gc = host_cross_gram_from_csr(csr_p, csr)
        sq_p = np.asarray(csr_p.multiply(csr_p).sum(axis=1)).ravel()
        sq_sv = np.asarray(csr.multiply(csr).sum(axis=1)).ravel()
        return self._predict_cross_gram(Gc, sq_p, sq_sv).cpu().numpy().astype(np.float64)

    def predict_label_parsed(self, parsed) -> np.ndarray:
        return np.where(self.predict_parsed(parsed) > 0.0, 1.0, -1.0)

    # --------------------------------------------------------------- accuracy

    def accuracy(self, points=None, labels=None) -> float:
        """Fraction of sign-correct predictions (``csvm.cpp:270-318``)."""
        if points is None:
            if self.values is None:
                raise PLSSVMError(
                    "No labels given! Maybe the data is only usable for prediction?"
                )
            if self._use_sparse():
                predictions = self.predict_parsed(self.data)
                correct = int(np.sum(predictions * np.asarray(self.values) > 0.0))
                return correct / self.num_data_points
            points, labels = self.data.dense, self.values
        if labels is None:
            raise PLSSVMError(
                "No labels given! Maybe the data is only usable for prediction?"
            )
        points = np.asarray(points, np.float64)
        labels = np.atleast_1d(np.asarray(labels, np.float64))
        if points.ndim == 1:
            points = points[None, :]
        if len(points) != len(labels):
            raise PLSSVMError(
                f"Number of data points ({len(points)}) must match number of "
                f"correct labels ({len(labels)})!"
            )
        if len(points) == 0:
            return 0.0
        predictions = self.predict(points)
        correct = int(np.sum(predictions * labels > 0.0))
        return correct / len(points)

    # ------------------------------------------------------------ write_model

    def write_model(self, model_name: str) -> None:
        """Write the LIBSVM model checkpoint (``csvm.cpp:60-204``)."""
        if self.alphas is None:
            raise PLSSVMError("No alphas given! Maybe a call to 'learn()' is missing?")
        if self.values is None:
            raise PLSSVMError("No labels given! Maybe the data is only usable for prediction?")
        if self.num_data_points != len(self.values):
            raise PLSSVMError(
                f"Number of labels ({len(self.values)}) must match the number of "
                f"data points ({self.num_data_points})!"
            )

        start = time.perf_counter()
        header = write_model_file(
            model_name,
            kernel=self.kernel,
            rho=-self.bias_,
            data=self.data.csr if self._use_sparse() else self.data.dense,
            labels=self.values,
            alphas=self.alphas,
            degree=self.degree,
            gamma=self.gamma,
            coef0=self.coef0,
        )
        if self.print_info:
            print(f"\nOptimization finished\n{header}")
            n_sv = int(np.sum(self.values > 0)) + int(np.sum(self.values < 0))
            elapsed = (time.perf_counter() - start) * 1000.0
            print(
                f"Wrote model file ('{model_name}') with {n_sv} support vectors "
                f"in {elapsed:.0f}ms."
            )


def csvm_from_state(state: dict, **params) -> CSVM:
    """A :class:`CSVM` from the trained state of a JAX package ``CSVM``, as
    numpy arrays and numbers: ``kernel``, ``degree``, ``gamma``, ``coef0``,
    ``alphas``, ``bias_``, ``support_vectors`` (dense, one row per SV, or a
    scipy sparse matrix) and ``values`` (labels), and optionally
    ``sparse_threshold``.  This is all an LS-SVM holds, so both packages then
    predict the same thing; sparse support vectors stay CSR, and at or below
    the threshold the port predicts through its sparse branch, as the JAX
    model does.  ``params`` go to :class:`Parameter` (``dtype``,
    ``backend``, ``target``, ``print_info``, ...)."""
    values = np.asarray(state["values"], np.float64)
    if "sparse_threshold" in state:
        params.setdefault("sparse_threshold", float(state["sparse_threshold"]))
    p = Parameter(kernel=KernelType(int(state["kernel"])), degree=int(state["degree"]),
                  gamma=float(state["gamma"]), coef0=float(state["coef0"]), **params)
    if sp.issparse(state["support_vectors"]):
        p.data = ParsedData(csr=sp.csr_matrix(state["support_vectors"], dtype=np.float64),
                            values=values)
    else:
        sv = np.asarray(state["support_vectors"], np.float64)
        p.data = ParsedData(csr=sp.csr_matrix(sv), values=values, _dense=sv)
    p.values = values
    p.alphas = np.asarray(state["alphas"], np.float64)
    p.rho = -float(state["bias_"])
    return CSVM(p)
