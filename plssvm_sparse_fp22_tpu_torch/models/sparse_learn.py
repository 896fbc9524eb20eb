"""The sparse learns (CSR-retained data), and the cross-Gram predict.

Port of the JAX package's ``models/sparse_learn.py``; each ``*_jit``
function there is a plain function here, without the suffix.  Selected by
:meth:`CSVM._learn_sparse` when the data's density is at or below
``Parameter.sparse_threshold``:

- linear kernel: :func:`learn_sparse_linear`, CG over ``K v = X (X^T v)``
  with the nnz-proportional ELL+COO products of ``ops/sparse.py``;
- polynomial/rbf, the memory-guarded tiers of ``_learn_sparse``: the Gram
  assembled once (:func:`learn_gram`), dense X on the dense implicit
  path (``CSVM._learn_dense``), or the streaming learns that recompute the
  kernel every iteration from the packing: :func:`learn_sparse_panel`
  (transient dense panels on K1/K3) and :func:`learn_sparse_implicit`
  (the ``gather`` arm).

Every learn returns ``(x, s, t, QA_cost, iterations, delta, delta0)``,
:func:`learn_sparse_panel` also the fast-tier iteration count: given a
``mxu_plan`` it runs the adaptive two-tier CG over panel operators at the
plan's two tiers, else one fixed tier (and the count equals the iteration
count).  Each takes ``span(label)``, a context manager (``CSVM._span``):
its device set-up runs in a ``setup`` span, its solve in a ``cg`` span.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.kernel_functions import integer_pow
from ..ops.matvec import _corrections, tier_precision, uses_kernels
from ..ops.matvec import jacobi_minv_from_kii as _diag_minv
from ..ops.sparse import (
    ELLMatrix,
    HybridSparse,
    host_gram_from_csr,
    hybrid_matvec,
    hybrid_row_sqnorms,
    load_csr_rows,
    make_streaming_gram_matvec,
    make_tiled_panel_matvec,
    make_tiled_panel_matvec_windowed,
    panel_sweep_strategy,
    sparse_q_qa_kii,
    stage_csr_rows,
    tiled_matvec,
    to_device,
)
from ..ops.sparse_gram import gram_from_rows, rows_matvec, split_rows
from ..solver.cg import cg_solve, cg_solve_adaptive
from ..types import KernelType
from ..utils import timing
from ..utils.timing import no_span


def _cost_inv(cost, like: torch.Tensor) -> torch.Tensor:
    one = torch.tensor(1.0, dtype=like.dtype, device=like.device)
    return one / torch.tensor(cost, dtype=like.dtype, device=like.device)


def _finish(res, q):
    s = torch.sum(res.x)
    t = torch.dot(q, res.x)
    return s, t


def learn_sparse_linear(vals, cols, coo_rows, coo_cols, coo_vals, x_last_dense, b_pad, mask,
                        cost, eps, imax, *, f, xt: HybridSparse, precond: str = "none",
                        span=no_span):
    """Linear-kernel learn over the ELL+COO hybrid packing: O(nnz) per CG
    iteration, robust to skewed row fills.  ``xt`` is the same packing of
    X^T (one row per feature), built once on the host: X^T v then
    contracts by rows, a gather and a row sum, like X u, instead of the
    JAX package's scatter-add over X's nonzeros (``hybrid_rmatvec``); only
    a skewed column's COO tail still adds by segments."""
    with span("setup"):
        cost_inv = _cost_inv(cost, vals)
        h = HybridSparse(ell=ELLMatrix(values=vals, cols=cols, shape=(vals.shape[0], f)),
                         coo_rows=coo_rows, coo_cols=coo_cols, coo_vals=coo_vals)
        q = hybrid_matvec(h, x_last_dense) * mask
        QA_cost = torch.dot(x_last_dense, x_last_dense) + cost_inv
        minv = None
        if precond == "jacobi":
            minv = _diag_minv(hybrid_row_sqnorms(h), q, mask, QA_cost, cost_inv)

    def matvec(v):
        Kv = hybrid_matvec(h, hybrid_matvec(xt, v))  # X (X^T v)
        return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    with span("cg"):
        res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s, t = _finish(res, q)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


def learn_sparse_panel(tvals, tlcols, x_last_dense, b_pad, mask, gamma, coef0, cost, eps,
                       imax, *, kernel, degree, ntiles, Lt, panel_rows,
                       precond: str = "none", use_cuda: bool = False, heavy=None,
                       heavy_rows: tuple = (), heavy_sq_vec=None, heavy_g_vec=None,
                       mxu_plan: tuple | None = None, sweep: str | None = None,
                       span=no_span):
    """Streaming poly/rbf learn, ``panel`` strategy: CG over the kernel
    matrix recomputed every iteration from the tiled-ELL packing through
    transient dense panels, the diagonal panel pairs on K1 and the others on
    K3 (``use_cuda``) or on their plain versions.  O(n·ntiles·Lt) resident
    memory, no (n, n) Gram.

    ``sweep`` picks the pair-sweep schedule (``unrolled`` or ``windowed``);
    ``None`` asks :func:`~..ops.sparse.panel_sweep_strategy`.  ``mxu_plan =
    (fast, accurate)`` runs the adaptive two-tier CG on the panel pairs
    (``sparse_learn.py:112-165`` of the JAX package); on the ``torch``
    backend its plain versions run the tiers, the counterpart of the JAX
    package's interpret mode."""
    cost_inv = _cost_inv(cost, tvals)
    nP = -(-tvals.shape[0] // panel_rows)
    if sweep is None:
        sweep = panel_sweep_strategy(nP)
    maker = make_tiled_panel_matvec_windowed if sweep == "windowed" else make_tiled_panel_matvec

    def make_kv(tier):
        return maker(tvals, tlcols, int(kernel), degree, gamma, coef0, ntiles=ntiles, Lt=Lt,
                     panel_rows=panel_rows, use_cuda=use_cuda, heavy=heavy,
                     heavy_rows=heavy_rows, heavy_sq_vec=heavy_sq_vec, precision=tier)

    with span("setup"):
        if mxu_plan is not None:
            kv_fast, sq = make_kv(tier_precision(mxu_plan[0]))
            kv_acc, _ = make_kv(tier_precision(mxu_plan[1]))
        else:
            kv_fn, sq = make_kv(None)

        f = x_last_dense.shape[0]
        fp = ntiles * 128
        x_last_p = x_last_dense
        if f != fp:
            x_last_p = torch.cat([x_last_dense, x_last_dense.new_zeros(fp - f)])
        g_last = tiled_matvec(tvals, tlcols, x_last_p, ntiles, Lt)
        if heavy_g_vec is not None:
            g_last = g_last + heavy_g_vec  # heavy rows' <x_i, x_last>, built on the host
        sq_last = torch.dot(x_last_dense, x_last_dense)
        q, QA_cost, kii = sparse_q_qa_kii(int(kernel), degree, gamma, coef0, g_last, sq_last,
                                          sq, mask, cost_inv)
        minv = None
        if precond == "jacobi":
            minv = _diag_minv(kii, q, mask, QA_cost, cost_inv)

    if mxu_plan is not None:
        def mv_fast(v):
            return _corrections(kv_fast(v), v, q, mask, QA_cost, cost_inv)

        def mv_acc(v):
            return _corrections(kv_acc(v), v, q, mask, QA_cost, cost_inv)

        with span("cg"):
            res = cg_solve_adaptive(mv_fast, mv_acc, b_pad, mask, eps, imax, minv=minv)
        k_fast = res.fast_iterations
    else:
        def matvec(v):
            return _corrections(kv_fn(v), v, q, mask, QA_cost, cost_inv)

        with span("cg"):
            res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
        k_fast = res.iterations
    s, t = _finish(res, q)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0, k_fast


def learn_sparse_implicit(vals, cols, coo_rows, coo_cols, coo_vals, x_last_dense, b_pad,
                          mask, gamma, coef0, cost, eps, imax, *, kernel, degree, f,
                          precond: str = "none", bm=None, bn=None, span=no_span):
    """Streaming poly/rbf learn, ``gather`` strategy: CG over the kernel
    matrix recomputed block by block from the ELL+COO packing every
    iteration with the nnz-proportional gather contraction: O(n·L) memory,
    no (n, n) Gram, no (n, f) densification.  The extreme-sparsity arm."""
    with span("setup"):
        cost_inv = _cost_inv(cost, vals)
        h = HybridSparse(ell=ELLMatrix(values=vals, cols=cols, shape=(vals.shape[0], f)),
                         coo_rows=coo_rows, coo_cols=coo_cols, coo_vals=coo_vals)
        kv_fn, sq = make_streaming_gram_matvec(h, int(kernel), degree, gamma, coef0, bm=bm,
                                               bn=bn)
        g_last = hybrid_matvec(h, x_last_dense)  # <x_i, x_last>
        sq_last = torch.dot(x_last_dense, x_last_dense)
        q, QA_cost, kii = sparse_q_qa_kii(int(kernel), degree, gamma, coef0, g_last, sq_last,
                                          sq, mask, cost_inv)
        minv = None
        if precond == "jacobi":
            minv = _diag_minv(kii, q, mask, QA_cost, cost_inv)

    def matvec(v):
        return _corrections(kv_fn(v), v, q, mask, QA_cost, cost_inv)

    with span("cg"):
        res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s, t = _finish(res, q)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


def _transform_gram(kernel: KernelType, G, sq, degree, gamma, coef0):
    """Kernel transform of a precomputed Gram matrix (diag = squared norms)."""
    return _transform_gram_cross(kernel, G, sq, sq, degree, gamma, coef0)


def learn_gram(csr, D, dept, f, x_last, b_pad, mask, gamma, coef0, cost, eps, imax, *, kernel,
               degree, precond: str = "none", backend=None, dense_x_fits: bool = True,
               span=no_span):
    """The ``gram`` tier: the linear Gram of ``csr``'s first ``dept`` rows
    padded to ``D``, then :func:`learn_from_gram`.  The Gram comes from the
    rows on the device (float32 on the CPU or the kernels' ``backend``,
    :mod:`~..ops.sparse_gram`), else from X scattered on the device and one
    product, else (very wide data, X over the budget) from the host SpGEMM.
    ``setup``'s parts: ``densify`` (staging, then the column split or the
    scatter), ``h2d``, ``gram`` and ``q``: the products with the last point
    ``x_last`` (on the device), from the same rows or X on the device
    (counted ``q_on_device``), else the host's sparse products."""
    from ..ops.sparse import device_gram_max_features  # read when called

    dev, dtype = b_pad.device, b_pad.dtype
    h2d = functools.partial(span, "setup/h2d")
    with span("setup"):
        if f <= device_gram_max_features() and dense_x_fits:
            with span("setup/densify"):
                staged = stage_csr_rows(csr, dept, dtype, dev)
            if len(staged) == 3 and dtype == torch.float32 and (
                    dev.type == "cpu" or uses_kernels(backend, dtype)):
                counts, cols, vals = to_device(staged, dev, h2d)
                with span("setup/densify"):
                    split = split_rows(counts, cols, vals, D, f)
                timing.count("densify_on_device")
                with span("setup/gram"):
                    G, sq = gram_from_rows(split)
                timing.count("gram_from_rows")
                timing.count("gram_heavy_cols", split.heavy)
                timing.count("gram_light_pairs", split.light_pairs)
                with span("setup/q"):
                    q_lin = rows_matvec(counts, cols, vals, x_last, D)
                    qa_lin = torch.dot(x_last, x_last)
            else:
                with span("setup/densify"):
                    Xd = torch.empty((D, f), dtype=dtype, device=dev)
                load_csr_rows(Xd, dept, staged, copies=h2d,
                              fill=functools.partial(span, "setup/densify"))
                with span("setup/gram"):
                    G = Xd @ Xd.T
                    sq = torch.sum(Xd * Xd, dim=1)
                with span("setup/q"):
                    q_lin = torch.zeros(D, dtype=dtype, device=dev)
                    q_lin[:dept] = Xd[:dept] @ x_last
                    qa_lin = torch.dot(x_last, x_last)
                del Xd
            timing.count("q_on_device")
        else:
            with span("setup/gram"):
                G_pad = torch.zeros((D, D), dtype=dtype)
                G_pad[:dept, :dept] = torch.from_numpy(host_gram_from_csr(csr, dept))
                sq_pad = G_pad.diagonal().clone()
            G, sq = to_device((G_pad, sq_pad), dev, h2d)
            with span("setup/q"):
                q_lin = torch.zeros(D, dtype=dtype)
                q_lin[:dept] = torch.from_numpy(
                    np.asarray((csr[:dept] @ csr[-1].T).todense()).ravel())
                qa_lin = float((csr[-1] @ csr[-1].T).toarray()[0, 0])
            (q_lin,) = to_device((q_lin,), dev)
            qa_lin = torch.tensor(qa_lin, dtype=dtype, device=dev)
    return learn_from_gram(G, sq, q_lin, qa_lin, b_pad, mask, gamma, coef0, cost, eps, imax,
                           kernel=kernel, degree=degree, precond=precond, span=span)


def learn_from_gram(G_pad, sq, q_lin, qa_lin, b_pad, mask, gamma, coef0, cost, eps, imax, *,
                    kernel, degree, precond: str = "none", span=no_span):
    """Cached-mode learn from an assembled linear Gram matrix.

    ``G_pad`` is (D, D) with ``G[i, j] = <x_i, x_j>`` over the first dept
    rows (zero padding elsewhere); ``sq`` the squared norms, ``q_lin[i] =
    <x_i, x_last>``, ``qa_lin = <x_last, x_last>``.  The kernel transform
    and every CG iteration run on the device."""
    with span("setup"):
        cost_inv = _cost_inv(cost, G_pad)
        if kernel == KernelType.polynomial:
            q = integer_pow(gamma * q_lin + coef0, degree) * mask
            QA_cost = integer_pow(gamma * qa_lin + coef0, degree) + cost_inv
        elif kernel == KernelType.rbf:
            d2 = sq + qa_lin - 2.0 * q_lin
            q = torch.exp(-gamma * torch.clamp(d2, min=0.0)) * mask
            QA_cost = torch.ones((), dtype=G_pad.dtype, device=G_pad.device) + cost_inv  # exp(0)
        else:
            q = q_lin * mask
            QA_cost = qa_lin + cost_inv

        K = _transform_gram(kernel, G_pad, sq, degree, gamma, coef0)
        K = K * (mask[:, None] * mask[None, :])
        minv = None
        if precond == "jacobi":
            minv = _diag_minv(torch.diagonal(K), q, mask, QA_cost, cost_inv)

    def matvec(v):
        return _corrections(K @ v, v, q, mask, QA_cost, cost_inv)

    with span("cg"):
        res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s, t = _finish(res, q)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


def predict_from_cross_gram(Gc, sq_points, sq_sv, alphas, bias, gamma, coef0, *, kernel,
                            degree):
    """Decision values from a cross Gram ``Gc[p, i] = <point_p, x_i>``
    assembled on the host."""
    K = _transform_gram_cross(kernel, Gc, sq_points, sq_sv, degree, gamma, coef0)
    return K @ alphas + bias


def _transform_gram_cross(kernel, Gc, sq_a, sq_b, degree, gamma, coef0):
    if kernel == KernelType.linear:
        return Gc
    if kernel == KernelType.polynomial:
        return integer_pow(gamma * Gc + coef0, degree)
    if kernel == KernelType.rbf:
        d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * Gc
        return torch.exp(-gamma * torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown kernel {kernel}")
