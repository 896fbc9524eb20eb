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

Each runs at one of three precision tiers (**K4**, the arms of
``_resolve_decomp``, ``pallas_matvec.py:297-312``), chosen per call:

- ``exact``: float32 operands, FFMA products, f32 sums;
- ``bf16x3``: ``X = hi + lo`` split into two bf16 parts
  (:func:`split_bf16`), ``G ~ hi hi^T + hi lo^T + lo hi^T`` on bf16 tensor
  cores with f32 accumulation: f32-grade Gram entries;
- ``bf16cast``: operands rounded to bf16, one tensor-core product.

The transform and the two GEMVs of the epilogue stay f32 at every tier.
float64 always runs ``exact`` (``pallas_matvec.py:306-312``).  K1 and K2
live in ``csrc/gram_matvec.cu``, K3 in ``csrc/pair_contrib.cu``; both
include ``csrc/gram_tile.cuh``, whose header says what bounds them on the
H100 and how the cross-CTA reduction stays deterministic.

A wrapper dispatches on the device of its tensors.  On a CPU tensor it runs
the plain version at the same tier; on a CUDA tensor it launches its kernel
or raises — there is no fallback.  Each launch adds one to
:data:`launches` under ``"<kernel>/<tier>"``, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import os

import torch

from ..constants import CUDA_TILE, ROW_BLOCK_SIZE
from ..exceptions import BackendError, PLSSVMError
from ..types import KernelType
from . import _build
from .kernel_functions import kernel_transform

#: the precision tiers, in the order of their C codes (exact 0, bf16x3 1,
#: bf16cast 2)
TIERS = ("exact", "bf16x3", "bf16cast")
#: the JAX package's precision names (``PLSSVM_MATMUL_PRECISION``, the
#: adaptive plan's tiers) and the tier each runs
PRECISION_TIERS = {
    "highest": "exact",     # float32 FFMA
    "high": "bf16x3",       # three bf16 products of the hi/lo split (f32-grade)
    "default": "bf16cast",  # one bf16 tensor-core product
    "fastest": "bf16cast",
}
KERNEL_NAMES = ("gram_matvec_sym", "gram_matvec_rect", "gram_pair_contrib")

#: kernel launches per wrapper and tier since the last :func:`reset_launches`
launches = {f"{name}/{tier}": 0 for name in KERNEL_NAMES for tier in TIERS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def row_sqnorms(X: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` of every row, computed outside the kernels from the float32
    rows at every tier, as ``make_sym_matvec`` of the JAX package does
    (``pallas_matvec.py:663``)."""
    return torch.sum(X * X, dim=1)


# --------------------------------------------------------------------------
# precision tiers: the operand arms
# --------------------------------------------------------------------------

def pallas_tier() -> str:
    """The fixed tier of the kernels, from ``PLSSVM_MATMUL_PRECISION``
    (``highest`` exact, ``high`` bf16x3, ``default`` / ``fastest``
    bf16cast), read when called.  The JAX package defaults to ``high``
    because the MXU emulates f32 in six passes (``pallas_matvec.py:69-85``);
    Hopper has native f32 FFMA, so the port defaults to ``highest``, as for
    any other value (``adaptive`` included)."""
    name = os.environ.get("PLSSVM_MATMUL_PRECISION", "highest").lower()
    return PRECISION_TIERS.get(name, "exact")


def resolve_tier(tier: str | None, dtype: torch.dtype) -> str:
    """``None`` means :func:`pallas_tier`; the bf16 tiers apply to float32
    only, so float64 resolves to ``exact`` (``_resolve_decomp``,
    ``pallas_matvec.py:297-312``)."""
    tier = pallas_tier() if tier is None else tier
    if tier not in TIERS:
        raise PLSSVMError(f"unknown precision tier '{tier}' (one of {', '.join(TIERS)})")
    return tier if dtype == torch.float32 else "exact"


def split_bf16(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact split ``X = hi + lo`` with ``hi, lo`` in bfloat16
    (``_split_bf16``, ``pallas_matvec.py:282-290``): ``hi`` keeps the upper
    16 bits of each float32 (a truncation, so the cast to bf16 is exact),
    ``lo`` is the remainder rounded to bf16 to nearest even.  The JAX
    package's subtraction runs with denormals flushed (the TPU's float32 and
    XLA's CPU code both flush), so a subnormal remainder is flushed to a
    zero of its sign here too, and a subnormal ``x`` leaves ``+0``."""
    hi_f32 = (X.view(torch.int32) & -65536).view(torch.float32)
    r = X - hi_f32
    tiny = torch.finfo(torch.float32).tiny
    r = torch.where(X.abs() < tiny, 0.0, torch.where(r.abs() < tiny, r * 0.0, r))
    return hi_f32.to(torch.bfloat16), r.to(torch.bfloat16)


def tier_operands(tier: str, X: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands a tier's product reads (``_pair_operands``,
    ``pallas_matvec.py:315-327``): ``(X,)``, ``(hi, lo)`` or
    ``(bf16(X),)``."""
    if tier == "bf16x3":
        return split_bf16(X)
    if tier == "bf16cast":
        return (X.to(torch.bfloat16),)
    return (X,)


def tier_matmul(tier: str, A: tuple, B: tuple) -> torch.Tensor:
    """``A @ B`` from two operand tuples of one tier.  The bf16 parts are
    upcast to float32 and multiplied with TF32 off, so every product of two
    bf16 values is exact and the sums are f32; bf16x3 adds
    ``hi hi + hi lo + lo hi`` in that order."""
    if tier == "exact":
        return A[0] @ B[0]
    A = [a.float() for a in A]
    B = [b.float() for b in B]
    if tier == "bf16cast":
        return A[0] @ B[0]
    return A[0] @ B[0] + A[0] @ B[1] + A[1] @ B[0]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _rows(ops: tuple, r0: int, r1: int) -> tuple:
    return tuple(t[r0:r1] for t in ops)


def _transposed(tier: str, ops: tuple) -> tuple:
    """The j-side operands as the right factor of :func:`tier_matmul`,
    upcast once per call rather than once per row block."""
    return tuple((t if tier == "exact" else t.float()).T for t in ops)


def gram_matvec_plain(kernel: KernelType, X, v, *, Y=None, degree=3, gamma=1.0,
                      coef0=0.0, sqx=None, sqy=None, row_block=ROW_BLOCK_SIZE,
                      tier: str = "exact", operands=None):
    """``K(X, Y) v`` at ``tier``, blocked over rows so it never holds more
    than one ``(row_block, N)`` kernel tile — the twin of the JAX package's
    blocked XLA implicit matvec (``matvec.py:288-306``), of its non-Pallas
    predict (``base.py:151-152``) and, at a bf16 tier, of its interpret-mode
    Pallas kernels.  ``operands`` passes ``(Xo, Yo)`` from
    :func:`tier_operands` prepared once by the caller."""
    Y = X if Y is None else Y
    tier = resolve_tier(tier, X.dtype)
    if kernel == KernelType.rbf:
        sqx = row_sqnorms(X) if sqx is None else sqx
        sqy = (sqx if Y is X else row_sqnorms(Y)) if sqy is None else sqy
    if operands is None:
        Xo = tier_operands(tier, X)
        operands = (Xo, Xo if Y is X else tier_operands(tier, Y))
    Xo, YoT = operands[0], _transposed(tier, operands[1])
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for r0 in range(0, X.shape[0], row_block):
        r1 = r0 + row_block
        Kb = kernel_transform(kernel, tier_matmul(tier, _rows(Xo, r0, r1), YoT), degree,
                              gamma, coef0, None if sqx is None else sqx[r0:r1], sqy)
        out[r0:r1] = Kb @ v
    return out


def gram_matvec_sym_plain(kernel: KernelType, X, v, *, degree=3, gamma=1.0,
                          coef0=0.0, sq=None, row_block=ROW_BLOCK_SIZE,
                          tier: str = "exact", operands=None):
    """Plain version of K1: ``K(X, X) v`` (all of K, no symmetry);
    ``operands`` is X's :func:`tier_operands`."""
    return gram_matvec_plain(kernel, X, v, degree=degree, gamma=gamma, coef0=coef0,
                             sqx=sq, sqy=sq, row_block=row_block, tier=tier,
                             operands=None if operands is None else (operands, operands))


def pair_gram_contrib_plain(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool,
                            sq_i=None, sq_j=None, degree=3, gamma=1.0, coef0=0.0,
                            row_block=ROW_BLOCK_SIZE, tier: str = "exact"):
    """Plain version of K3, the twin of ``pair_gram_contrib_xla``
    (``pallas_matvec.py:824-852``), blocked over Xi's rows so it never holds
    more than one ``(row_block, Dj)`` kernel tile.  Returns ``(out_i, out_j)``
    with ``out_i = K v_j`` and ``out_j = K^T v_i``; with ``same=True``
    (``Xj`` is ``Xi``) ``(K v_i, 0)``, whose sum is what the caller adds."""
    tier = resolve_tier(tier, Xi.dtype)
    if kernel == KernelType.rbf:
        sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
        sq_j = (sq_i if same else row_sqnorms(Xj)) if sq_j is None else sq_j
    Xio = tier_operands(tier, Xi)
    XjoT = _transposed(tier, Xio if same else tier_operands(tier, Xj))
    out_i = torch.empty(Xi.shape[0], dtype=Xi.dtype, device=Xi.device)
    out_j = torch.zeros(Xj.shape[0], dtype=Xi.dtype, device=Xi.device)
    for r0 in range(0, Xi.shape[0], row_block):
        r1 = r0 + row_block
        Kb = kernel_transform(kernel, tier_matmul(tier, _rows(Xio, r0, r1), XjoT), degree,
                              gamma, coef0, None if sq_i is None else sq_i[r0:r1], sq_j)
        out_i[r0:r1] = Kb @ v_j
        if not same:
            out_j += Kb.T @ v_i[r0:r1]
    return out_i, out_j


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise PLSSVMError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise PLSSVMError(
            f"{name} is {t.dtype}, expected {dtype}: the CUDA Gram kernels take float32 "
            "only (bfloat16 operands at the bf16x3 and bf16cast tiers) and have no "
            "float64 version; train with --use_float or use the torch backend")
    if tuple(t.shape) != shape:
        raise PLSSVMError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise PLSSVMError(f"{name} must be contiguous")


def _check_operands(name: str, tier: str, ops: tuple, shape: tuple, device) -> tuple:
    """Check a tier's operand tuple; returns the two operand pointers (the
    second is NULL unless the tier is bf16x3)."""
    want = 2 if tier == "bf16x3" else 1
    if len(ops) != want:
        raise PLSSVMError(f"{name}: the {tier} tier takes {want} operand(s), got {len(ops)}")
    dtype = torch.float32 if tier == "exact" else torch.bfloat16
    for part, t in zip(("", "_lo"), ops):
        _check(name + part, t, shape, device, dtype)
    return ops[0].data_ptr(), (ops[1].data_ptr() if want == 2 else None)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise BackendError(f"{what}: CUDA error {rc} at launch")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_sym(kernel, tier, Xo, v, sq, degree, gamma, coef0):
    """K1 (replaces ``_gram_matvec_sym_kernel``, ``pallas_matvec.py:388``).
    Bound on the H100 by f32 FFMA throughput (exact) or by the tensor-core
    product and the epilogue (bf16 tiers): X fits the L2 cache, and each
    128 x 128 tile reuses every loaded feature 128 times.  The
    lower-triangle pairs halve the flops; the slab holds one BM-long
    partial per (block, other block) and a second kernel sums it in a fixed
    order."""
    D, f = Xo[0].shape
    dev = Xo[0].device
    x_hi, x_lo = _check_operands("X", tier, Xo, (D, f), dev)
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
            TIERS.index(tier), x_hi, x_lo, sq.data_ptr(), v.data_ptr(), slab.data_ptr(),
            out.data_ptr(), D, f, int(kernel), int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, f"gram_matvec_sym/{tier}")
    launches[f"gram_matvec_sym/{tier}"] += 1
    return out


def _launch_rect(kernel, tier, Xo, Yo, v, sqx, sqy, degree, gamma, coef0):
    """K2 (replaces ``_gram_matvec_kernel``, ``pallas_matvec.py:117``).
    Bound like K1.  Y's rows are split over CTAs so a one-row predict still
    spreads over the card, but each CTA still runs a full 128-row tile of
    which all but one row is masked: small batches pay for 128 rows.  The
    slab holds one partial per tile pair, summed in a fixed order."""
    D, f = Xo[0].shape
    N = Yo[0].shape[0]
    dev = Xo[0].device
    x_hi, x_lo = _check_operands("X", tier, Xo, (D, f), dev)
    y_hi, y_lo = _check_operands("Y", tier, Yo, (N, f), dev)
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
            TIERS.index(tier), x_hi, x_lo, y_hi, y_lo, sqx.data_ptr(), sqy.data_ptr(),
            v.data_ptr(), slab.data_ptr(), out.data_ptr(), D, N, f, int(kernel),
            int(degree), float(gamma), float(coef0),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, f"gram_matvec_rect/{tier}")
    launches[f"gram_matvec_rect/{tier}"] += 1
    return out


def _launch_pair(kernel, tier, Xio, Xjo, v_i, v_j, sq_i, sq_j, degree, gamma, coef0):
    """K3, cross panels (replaces ``pair_gram_contrib``,
    ``pallas_matvec.py:716``).  Bound like K1, at twice K1's flops per
    output pair (no symmetry to skip).  One CTA per (i, j) tile pair writes
    ``K_ij v_j`` to ``slab_i[i][j]`` and ``K_ij^T v_i`` to ``slab_j[j][i]``;
    two fixed-order passes sum them."""
    Di, f = Xio[0].shape
    Dj = Xjo[0].shape[0]
    dev = Xio[0].device
    xi_hi, xi_lo = _check_operands("Xi", tier, Xio, (Di, f), dev)
    xj_hi, xj_lo = _check_operands("Xj", tier, Xjo, (Dj, f), dev)
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
            TIERS.index(tier), xi_hi, xi_lo, xj_hi, xj_lo, sq_i.data_ptr(), sq_j.data_ptr(),
            v_i.data_ptr(), v_j.data_ptr(), slab_i.data_ptr(), slab_j.data_ptr(),
            out_i.data_ptr(), out_j.data_ptr(), Di, Dj, f, int(kernel), int(degree),
            float(gamma), float(coef0), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, f"gram_pair_contrib/{tier}")
    launches[f"gram_pair_contrib/{tier}"] += 1
    return out_i, out_j


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def make_sym_matvec(kernel: KernelType, X, *, degree=3, gamma=1.0, coef0=0.0,
                    tier: str | None = None):
    """Build ``v -> K(X, X) v`` (K1) at ``tier`` (``None``:
    :func:`pallas_tier`).  The row norms and the tier's split or cast of X
    are computed once here, outside the returned closure, as the JAX
    package does (``pallas_matvec.py:663-668``), so a CG loop pays only for
    the kernel."""
    tier = resolve_tier(tier, X.dtype)
    sq = row_sqnorms(X)
    Xo = tier_operands(tier, X)

    def matvec(v):
        if X.is_cuda:
            return _launch_sym(kernel, tier, Xo, v, sq, degree, gamma, coef0)
        return gram_matvec_sym_plain(kernel, X, v, degree=degree, gamma=gamma,
                                     coef0=coef0, sq=sq, tier=tier, operands=Xo)

    return matvec


def gram_matvec_sym(kernel: KernelType, X, v, *, degree=3, gamma=1.0, coef0=0.0,
                    tier: str | None = None):
    """One-shot ``K(X, X) v`` through K1 — see :func:`make_sym_matvec`."""
    return make_sym_matvec(kernel, X, degree=degree, gamma=gamma, coef0=coef0, tier=tier)(v)


def gram_matvec(kernel: KernelType, X, v, *, Y=None, degree=3, gamma=1.0,
                coef0=0.0, sqx=None, sqy=None, tier: str | None = None, operands=None):
    """``K(X, Y) v`` through K2 (``Y`` defaults to ``X``) at ``tier``
    (``None``: :func:`pallas_tier`): the poly/rbf predict, and the implicit
    A·v with the symmetric kernel disabled, which passes ``operands``
    (``(Xo, Yo)`` of :func:`tier_operands`) prepared once."""
    Y = X if Y is None else Y
    tier = resolve_tier(tier, X.dtype)
    if not X.is_cuda:
        return gram_matvec_plain(kernel, X, v, Y=Y, degree=degree, gamma=gamma,
                                 coef0=coef0, sqx=sqx, sqy=sqy, tier=tier, operands=operands)
    sqx = row_sqnorms(X) if sqx is None else sqx
    sqy = (sqx if Y is X else row_sqnorms(Y)) if sqy is None else sqy
    if operands is None:
        Xo = tier_operands(tier, X)
        operands = (Xo, Xo if Y is X else tier_operands(tier, Y))
    return _launch_rect(kernel, tier, *operands, v, sqx, sqy, degree, gamma, coef0)


def pair_gram_contrib(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool, sq_i=None,
                      sq_j=None, degree=3, gamma=1.0, coef0=0.0, tier: str | None = None):
    """Panel-pair contributions of ``K = k(Xi, Xj)`` without building K, with
    the JAX package's contract (``pallas_matvec.py:734-755``): returns
    ``(out_i, out_j)`` sliced to the real row counts, ``out_i = K v_j`` and
    ``out_j = K^T v_i``.  ``same=True`` (the diagonal panel, ``Xj`` is
    ``Xi``) only promises ``out_i + out_j = K(Xi, Xi) v_i``: it runs K1 on
    the panel and returns ``(K v_i, 0)``, counted under
    ``gram_matvec_sym``.  The panels are transient, so the tier's split or
    cast runs per call, once for both sides when ``same=True``
    (``pallas_matvec.py:319-326``).  Padding rows must be zero, with zero
    ``v``."""
    tier = resolve_tier(tier, Xi.dtype)
    sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
    if same:
        if not Xi.is_cuda:
            return pair_gram_contrib_plain(kernel, Xi, Xi, v_i, v_i, same=True, sq_i=sq_i,
                                           sq_j=sq_i, degree=degree, gamma=gamma,
                                           coef0=coef0, tier=tier)
        out = _launch_sym(kernel, tier, tier_operands(tier, Xi), v_i, sq_i, degree, gamma,
                          coef0)
        return out, torch.zeros_like(out)
    sq_j = row_sqnorms(Xj) if sq_j is None else sq_j
    if not Xi.is_cuda:
        return pair_gram_contrib_plain(kernel, Xi, Xj, v_i, v_j, same=False, sq_i=sq_i,
                                       sq_j=sq_j, degree=degree, gamma=gamma, coef0=coef0,
                                       tier=tier)
    return _launch_pair(kernel, tier, tier_operands(tier, Xi), tier_operands(tier, Xj), v_i,
                        v_j, sq_i, sq_j, degree, gamma, coef0)
