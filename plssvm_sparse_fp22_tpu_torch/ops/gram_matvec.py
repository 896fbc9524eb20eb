"""Fused Gram-matrix x vector products: the CUDA kernels and their plain
PyTorch versions.  The counterpart of the JAX package's
``ops/pallas_matvec.py``.

- **K1**, :func:`make_sym_matvec` / :func:`gram_matvec_sym`:
  ``K(X, X) v`` over lower-triangular tile pairs.  Replaces
  ``_gram_matvec_sym_kernel`` (``pallas_matvec.py:388``), driven there by
  ``make_sym_matvec``.  It is the ``implicit``-mode A·v of every CG
  iteration.
- **K2**, :func:`gram_matvec`: ``K(X, Y) v`` over every tile pair.
  Replaces ``_gram_matvec_kernel`` (``pallas_matvec.py:117``), driven there
  by ``gram_matvec_pallas``.  It is the poly/rbf predict.
- **K3**, :func:`pair_gram_contrib`: both directions ``K(Xi, Xj) v_j`` and
  ``K(Xi, Xj)^T v_i`` of one panel pair from one pass over every tile pair.
  Replaces ``pair_gram_contrib`` (``pallas_matvec.py:716``), which drives
  K1's body over two panels.  It is the cross-panel A·v of the streaming
  sparse learn.

K1 and K2 live in ``csrc/gram_matvec.cu``, K3 in ``csrc/pair_contrib.cu``;
both include ``csrc/gram_tile.cuh``, whose header says what bounds them on
the H100 and how the cross-CTA reduction stays deterministic.  All three
are exact float32: f32 inputs, FFMA products, f32 sums.

A wrapper dispatches on the device of its tensors.  On a CPU tensor it runs
the plain version; on a CUDA tensor it launches its kernel or raises — there
is no fallback.  Each launch adds one to :data:`launches`, so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import torch

from ..constants import CUDA_TILE, ROW_BLOCK_SIZE
from ..exceptions import BackendError, PLSSVMError
from ..types import KernelType
from . import _build
from .kernel_functions import gram_block

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"gram_matvec_sym": 0, "gram_matvec_rect": 0, "gram_pair_contrib": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def row_sqnorms(X: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` of every row, computed outside the kernels as
    ``make_sym_matvec`` of the JAX package does (``pallas_matvec.py:663``)."""
    return torch.sum(X * X, dim=1)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def gram_matvec_plain(kernel: KernelType, X, v, *, Y=None, degree=3, gamma=1.0,
                      coef0=0.0, sqx=None, sqy=None, row_block=ROW_BLOCK_SIZE):
    """``K(X, Y) v`` as ``gram_block`` + matmul, blocked over rows so it
    never holds more than one ``(row_block, N)`` kernel tile — the twin of
    the JAX package's blocked XLA implicit matvec (``matvec.py:288-306``)
    and of its non-Pallas predict (``base.py:151-152``)."""
    Y = X if Y is None else Y
    if kernel == KernelType.rbf:
        sqx = row_sqnorms(X) if sqx is None else sqx
        sqy = (sqx if Y is X else row_sqnorms(Y)) if sqy is None else sqy
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for r0 in range(0, X.shape[0], row_block):
        r1 = r0 + row_block
        Kb = gram_block(kernel, X[r0:r1], Y, degree, gamma, coef0,
                        Xi_sqnorm=None if sqx is None else sqx[r0:r1],
                        Xj_sqnorm=sqy)
        out[r0:r1] = Kb @ v
    return out


def gram_matvec_sym_plain(kernel: KernelType, X, v, *, degree=3, gamma=1.0,
                          coef0=0.0, sq=None, row_block=ROW_BLOCK_SIZE):
    """Plain version of K1: ``K(X, X) v`` (all of K, no symmetry)."""
    return gram_matvec_plain(kernel, X, v, degree=degree, gamma=gamma,
                             coef0=coef0, sqx=sq, sqy=sq, row_block=row_block)


def pair_gram_contrib_plain(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool,
                            sq_i=None, sq_j=None, degree=3, gamma=1.0, coef0=0.0,
                            row_block=ROW_BLOCK_SIZE):
    """Plain version of K3, the twin of ``pair_gram_contrib_xla``
    (``pallas_matvec.py:824-852``), blocked over Xi's rows so it never holds
    more than one ``(row_block, Dj)`` kernel tile.  Returns ``(out_i, out_j)``
    with ``out_i = K v_j`` and ``out_j = K^T v_i``; with ``same=True``
    (``Xj`` is ``Xi``) ``(K v_i, 0)``, whose sum is what the caller adds."""
    if kernel == KernelType.rbf:
        sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
        sq_j = (sq_i if same else row_sqnorms(Xj)) if sq_j is None else sq_j
    out_i = torch.empty(Xi.shape[0], dtype=Xi.dtype, device=Xi.device)
    out_j = torch.zeros(Xj.shape[0], dtype=Xi.dtype, device=Xi.device)
    for r0 in range(0, Xi.shape[0], row_block):
        r1 = r0 + row_block
        Kb = gram_block(kernel, Xi[r0:r1], Xj, degree, gamma, coef0,
                        Xi_sqnorm=None if sq_i is None else sq_i[r0:r1],
                        Xj_sqnorm=sq_j)
        out_i[r0:r1] = Kb @ v_j
        if not same:
            out_j += Kb.T @ v_i[r0:r1]
    return out_i, out_j


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise PLSSVMError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise PLSSVMError(
            f"{name} is {t.dtype}: the CUDA Gram kernels take float32 only "
            "(float64 and the bf16/TF32 tiers are the K4 precision work, not "
            "ported yet); train with --use_float or use the torch backend")
    if tuple(t.shape) != shape:
        raise PLSSVMError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise PLSSVMError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise BackendError(f"{what}: CUDA error {rc} at launch")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_sym(kernel, X, v, sq, degree, gamma, coef0):
    """K1 (replaces ``_gram_matvec_sym_kernel``, ``pallas_matvec.py:388``).
    Bound on the H100 by f32 FFMA throughput: X fits the L2 cache, and each
    128 x 128 tile reuses every loaded feature 128 times.  The lower-triangle
    pairs halve the flops; the slab holds one BM-long partial per (block,
    other block) and a second kernel sums it in a fixed order."""
    D, f = X.shape
    dev = X.device
    _check("X", X, (D, f), dev)
    _check("v", v, (D,), dev)
    _check("sq", sq, (D,), dev)
    out = torch.empty(D, dtype=torch.float32, device=dev)
    if D == 0:
        return out
    nb = _cdiv(D, CUDA_TILE)
    slab = torch.empty((nb, nb, CUDA_TILE), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.gram_matvec_sym(
            X.data_ptr(), sq.data_ptr(), v.data_ptr(), slab.data_ptr(),
            out.data_ptr(), D, f, int(kernel), int(degree), float(gamma),
            float(coef0), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "gram_matvec_sym")
    launches["gram_matvec_sym"] += 1
    return out


def _launch_rect(kernel, X, Y, v, sqx, sqy, degree, gamma, coef0):
    """K2 (replaces ``_gram_matvec_kernel``, ``pallas_matvec.py:117``).
    Bound by f32 FFMA throughput.  Y's rows are split over CTAs so a
    one-row predict still spreads over the card, but each CTA still runs a
    full 128-row tile of which all but one row is masked: small batches pay
    for 128 rows.  The slab holds one partial per tile pair, summed in a
    fixed order."""
    D, f = X.shape
    N = Y.shape[0]
    dev = X.device
    _check("X", X, (D, f), dev)
    _check("Y", Y, (N, f), dev)
    _check("v", v, (N,), dev)
    _check("sqx", sqx, (D,), dev)
    _check("sqy", sqy, (N,), dev)
    out = torch.zeros(D, dtype=torch.float32, device=dev)
    if D == 0 or N == 0:
        return out
    nbi, nbj = _cdiv(D, CUDA_TILE), _cdiv(N, CUDA_TILE)
    if nbi > 65535:
        raise PLSSVMError(f"gram_matvec: {D} rows exceed the kernel's grid "
                          f"({65535 * CUDA_TILE}); split the call")
    slab = torch.empty((nbi, nbj, CUDA_TILE), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.gram_matvec_rect(
            X.data_ptr(), Y.data_ptr(), sqx.data_ptr(), sqy.data_ptr(),
            v.data_ptr(), slab.data_ptr(), out.data_ptr(), D, N, f, int(kernel),
            int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "gram_matvec_rect")
    launches["gram_matvec_rect"] += 1
    return out


def _launch_pair(kernel, Xi, Xj, v_i, v_j, sq_i, sq_j, degree, gamma, coef0):
    """K3, cross panels (replaces ``pair_gram_contrib``,
    ``pallas_matvec.py:716``).  Bound by f32 FFMA throughput like K1, at
    twice K1's flops per output pair (no symmetry to skip).  One CTA per
    (i, j) tile pair writes ``K_ij v_j`` to ``slab_i[i][j]`` and
    ``K_ij^T v_i`` to ``slab_j[j][i]``; two fixed-order passes sum them."""
    Di, f = Xi.shape
    Dj = Xj.shape[0]
    dev = Xi.device
    _check("Xi", Xi, (Di, f), dev)
    _check("Xj", Xj, (Dj, f), dev)
    _check("v_i", v_i, (Di,), dev)
    _check("v_j", v_j, (Dj,), dev)
    _check("sq_i", sq_i, (Di,), dev)
    _check("sq_j", sq_j, (Dj,), dev)
    out_i = torch.zeros(Di, dtype=torch.float32, device=dev)
    out_j = torch.zeros(Dj, dtype=torch.float32, device=dev)
    if Di == 0 or Dj == 0:
        return out_i, out_j
    nbi, nbj = _cdiv(Di, CUDA_TILE), _cdiv(Dj, CUDA_TILE)
    if nbi > 65535:
        raise PLSSVMError(f"pair_gram_contrib: {Di} rows exceed the kernel's grid "
                          f"({65535 * CUDA_TILE}); use smaller panels")
    slab_i = torch.empty((nbi, nbj, CUDA_TILE), dtype=torch.float32, device=dev)
    slab_j = torch.empty((nbj, nbi, CUDA_TILE), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.gram_pair_contrib(
            Xi.data_ptr(), Xj.data_ptr(), sq_i.data_ptr(), sq_j.data_ptr(),
            v_i.data_ptr(), v_j.data_ptr(), slab_i.data_ptr(), slab_j.data_ptr(),
            out_i.data_ptr(), out_j.data_ptr(), Di, Dj, f, int(kernel), int(degree),
            float(gamma), float(coef0), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "gram_pair_contrib")
    launches["gram_pair_contrib"] += 1
    return out_i, out_j


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def make_sym_matvec(kernel: KernelType, X, *, degree=3, gamma=1.0, coef0=0.0):
    """Build ``v -> K(X, X) v`` (K1).  The row norms are computed once here,
    outside the returned closure, so a CG loop pays only for the kernel."""
    sq = row_sqnorms(X)

    def matvec(v):
        if X.is_cuda:
            return _launch_sym(kernel, X, v, sq, degree, gamma, coef0)
        return gram_matvec_sym_plain(kernel, X, v, degree=degree, gamma=gamma,
                                     coef0=coef0, sq=sq)

    return matvec


def gram_matvec_sym(kernel: KernelType, X, v, *, degree=3, gamma=1.0, coef0=0.0):
    """One-shot ``K(X, X) v`` through K1 — see :func:`make_sym_matvec`."""
    return make_sym_matvec(kernel, X, degree=degree, gamma=gamma, coef0=coef0)(v)


def gram_matvec(kernel: KernelType, X, v, *, Y=None, degree=3, gamma=1.0,
                coef0=0.0, sqx=None, sqy=None):
    """``K(X, Y) v`` through K2 (``Y`` defaults to ``X``): the poly/rbf
    predict, and the implicit A·v with the symmetric kernel disabled."""
    Y = X if Y is None else Y
    if not X.is_cuda:
        return gram_matvec_plain(kernel, X, v, Y=Y, degree=degree, gamma=gamma,
                                 coef0=coef0, sqx=sqx, sqy=sqy)
    sqx = row_sqnorms(X) if sqx is None else sqx
    sqy = (sqx if Y is X else row_sqnorms(Y)) if sqy is None else sqy
    return _launch_rect(kernel, X, Y, v, sqx, sqy, degree, gamma, coef0)


def pair_gram_contrib(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool, sq_i=None,
                      sq_j=None, degree=3, gamma=1.0, coef0=0.0):
    """Panel-pair contributions of ``K = k(Xi, Xj)`` without building K, with
    the JAX package's contract (``pallas_matvec.py:734-755``): returns
    ``(out_i, out_j)`` sliced to the real row counts, ``out_i = K v_j`` and
    ``out_j = K^T v_i``.  ``same=True`` (the diagonal panel, ``Xj`` is
    ``Xi``) only promises ``out_i + out_j = K(Xi, Xi) v_i``: it runs K1 on
    the panel and returns ``(K v_i, 0)``, counted under
    ``gram_matvec_sym``.  Padding rows must be zero, with zero ``v``."""
    sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
    if same:
        if not Xi.is_cuda:
            return pair_gram_contrib_plain(kernel, Xi, Xi, v_i, v_i, same=True, sq_i=sq_i,
                                           sq_j=sq_i, degree=degree, gamma=gamma,
                                           coef0=coef0)
        out = _launch_sym(kernel, Xi, v_i, sq_i, degree, gamma, coef0)
        return out, torch.zeros_like(out)
    sq_j = row_sqnorms(Xj) if sq_j is None else sq_j
    if not Xi.is_cuda:
        return pair_gram_contrib_plain(kernel, Xi, Xj, v_i, v_j, same=False, sq_i=sq_i,
                                       sq_j=sq_j, degree=degree, gamma=gamma, coef0=coef0)
    return _launch_pair(kernel, Xi, Xj, v_i, v_j, sq_i, sq_j, degree, gamma, coef0)
