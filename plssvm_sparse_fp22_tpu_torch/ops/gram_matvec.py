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
include ``csrc/gram_tile.cuh`` (the exact tile, the slab reduction) and
``csrc/gram_tile_wgmma.cuh`` (the TMA-fed ``wgmma`` tile of every bf16
tier; K2 runs it in its row-only mode); ``gram_matvec.cu``'s header says
what bounds them on the H100 and how the cross-CTA reduction stays
deterministic.

Scratch.  The kernels' CTAs write per-tile-pair partial sums into a slab
that a second kernel sums in a fixed order (``csrc/gram_matvec.cu``).  A
whole slab grows as ``D²`` (8 GiB for K1 at D = 524288) where the JAX
kernels hold O(D) (``pallas_matvec.py:256, 355-358``), so each launch's slab
is bounded by :data:`SCRATCH_BYTES` (or the wrappers' ``scratch_bytes``
keyword): K1 walks strips of row blocks (:func:`sym_strip_blocks`), K2 and
K3 strips of X's (Xi's) rows, and each row's partials are still added in one
ascending order across the strips, so a stripped result is bitwise the
one-strip result.  :func:`gram_matvec_sym_strips_plain` and its two
siblings are the schedule's plain twins: per-tile-pair partials summed in
the kernels' order.

The bf16 operands (:func:`tier_operands`) carry their feature axis padded
with zeros to a multiple of 64 (``CUDA_FEATURE_PAD``): a zero feature
changes no dot product, the row norms are taken from the float32 rows, and
the TMA unit gets the 16-byte row stride it needs.  The plain versions take
the same padded operands.  The bf16x3 split of a CUDA matrix
(:func:`split_bf16`) is one launch of ``csrc/split_bf16.cu``, which writes
both parts already padded; the bf16cast operand is one ``Tensor.to``.

A wrapper dispatches on the device of its tensors.  On a CPU tensor it runs
the plain version at the same tier; on a CUDA tensor it launches its kernel
or raises — there is no fallback.  Each launch adds one to
:data:`launches` under ``"<kernel>/<tier>"`` (the split under
``"split_bf16"``; a call in several strips launches once per strip), so a
run can show that it went through the kernels.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from ..constants import CUDA_FEATURE_PAD, CUDA_TILE, ROW_BLOCK_SIZE
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

#: kernel launches per wrapper and tier, and of the split kernel, since the
#: last :func:`reset_launches`
launches = {**{f"{name}/{tier}": 0 for name in KERNEL_NAMES for tier in TIERS}, "split_bf16": 0}


#: calls of :func:`tier_operands` per tier since the last
#: :func:`reset_preparations`: a bf16 tier's call is a split or cast of a
#: whole matrix, so a schedule can show how often it pays for one
preparations = {tier: 0 for tier in TIERS}


#: bytes of scratch slab (per-tile-pair partial sums, ``CUDA_TILE`` floats
#: each) one launch of K1, K2 or K3 may hold.  At 256 MiB every shape the
#: smoke test runs (K1 up to D = 32768: 32 MiB) takes one strip, and K1 at
#: D = 524288 takes 64 strips of 64 row blocks where one slab would be 8 GiB
SCRATCH_BYTES = 256 * 1024**2
_SLOT_BYTES = CUDA_TILE * 4
#: K2 and K3 run one CTA per tile pair at the exact tier, on a grid whose
#: row axis holds at most this many row blocks
_GRID_ROWS = 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reset_preparations() -> None:
    for tier in preparations:
        preparations[tier] = 0


def counts_snapshot() -> tuple[dict, dict]:
    """Copies of :data:`launches` and :data:`preparations`."""
    return dict(launches), dict(preparations)


def counts_since(snapshot: tuple[dict, dict]) -> tuple[dict, dict]:
    """What :data:`launches` and :data:`preparations` counted since
    ``snapshot``: the entries that grew, by how much."""
    return tuple({k: now[k] - then[k] for k in now if now[k] != then[k]}
                 for now, then in zip((launches, preparations), snapshot))


def add_counts(added: tuple[dict, dict], times: int = 1) -> None:
    """Count ``added`` (of :func:`counts_since`) ``times`` more: a CUDA
    graph's replay launches what its capture counted, without running the
    wrappers' Python."""
    for counter, inc in zip((launches, preparations), added):
        for k, v in inc.items():
            counter[k] += times * v


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


def split_bf16_plain(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
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


def _padded(f: int) -> int:
    return _cdiv(f, CUDA_FEATURE_PAD) * CUDA_FEATURE_PAD


def _pad_features(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, f) with its feature axis padded with zeros to a multiple
    of ``CUDA_FEATURE_PAD``; ``t`` itself when f already is one."""
    rows, f = t.shape
    if _padded(f) == f:
        return t
    out = torch.zeros((rows, _padded(f)), dtype=t.dtype, device=t.device)
    out[:, :f] = t
    return out


def split_bf16(X: torch.Tensor, *, pad: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of :func:`split_bf16_plain`, with ``pad`` the last axis
    of both padded with zeros to a multiple of ``CUDA_FEATURE_PAD``.  A CUDA
    tensor (float32, contiguous) takes the split kernel, which writes the
    padded buffers in its one pass; a CPU tensor the plain version."""
    if X.is_cuda:
        return _launch_split(X, pad)
    parts = split_bf16_plain(X)
    return tuple(_pad_features(t) for t in parts) if pad else parts


def tier_operands(tier: str, X: torch.Tensor, *, pad: bool = True) -> tuple[torch.Tensor, ...]:
    """The operands a tier's product reads (``_pair_operands``,
    ``pallas_matvec.py:315-327``): ``(X,)``, ``(hi, lo)`` or
    ``(bf16(X),)``.  The bf16 parts of a matrix come in contiguous buffers
    whose feature axis is padded with zeros to a multiple of
    ``CUDA_FEATURE_PAD``, the row stride the wgmma tile's TMA loads need;
    ``pad=False`` (the ``linear`` mode's plain products) leaves the shape."""
    preparations[tier] += 1
    pad = pad and X.dim() == 2
    if tier == "bf16x3":
        return split_bf16(X, pad=pad)
    if tier == "bf16cast":
        cast = X.to(torch.bfloat16)
        return (_pad_features(cast) if pad else cast,)
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
    :func:`tier_operands` prepared once by the caller (padded features and
    all: the zero columns add nothing to any product)."""
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


def _pair_operands(tier: str, Xi, Xj, same: bool, operands) -> tuple:
    """``(Xio, Xjo)`` of a panel pair: the caller's, or prepared here, once
    for both sides when ``same``."""
    if operands is not None:
        return operands[0], (operands[0] if same else operands[1])
    Xio = tier_operands(tier, Xi)
    return Xio, (Xio if same else tier_operands(tier, Xj))


def pair_gram_contrib_plain(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool,
                            sq_i=None, sq_j=None, degree=3, gamma=1.0, coef0=0.0,
                            row_block=ROW_BLOCK_SIZE, tier: str = "exact", operands=None):
    """Plain version of K3, the twin of ``pair_gram_contrib_xla``
    (``pallas_matvec.py:824-852``), blocked over Xi's rows so it never holds
    more than one ``(row_block, Dj)`` kernel tile.  Returns ``(out_i, out_j)``
    with ``out_i = K v_j`` and ``out_j = K^T v_i``; with ``same=True``
    (``Xj`` is ``Xi``) ``(K v_i, 0)``, whose sum is what the caller adds.
    ``operands`` passes ``(Xio, Xjo)`` of :func:`tier_operands` prepared by
    the caller (``Xjo`` is not read when ``same``)."""
    tier = resolve_tier(tier, Xi.dtype)
    if kernel == KernelType.rbf:
        sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
        sq_j = (sq_i if same else row_sqnorms(Xj)) if sq_j is None else sq_j
    Xio, Xjo = _pair_operands(tier, Xi, Xj, same, operands)
    XjoT = _transposed(tier, Xjo)
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
# scratch strips: the plan and its plain twins
# --------------------------------------------------------------------------

def _slots(scratch_bytes: int) -> int:
    return int(scratch_bytes) // _SLOT_BYTES


def sym_strip_slots(nb: int, S: int) -> int:
    """The largest slab, in ``CUDA_TILE``-float slots, of K1's strips of
    ``S`` row blocks over ``nb``: the strip ``[i0, i1)`` takes
    ``(i1 - i0)(i0 + i1)`` (``sym_slot``, ``csrc/gram_tile.cuh``), so the
    largest is the last strip or the full one before it."""
    last = (nb - 1) // S * S
    worst = (nb - last) * (last + nb)
    return max(worst, S * (2 * last - S)) if last >= S else worst


def _no_strip(what: str, need: int, scratch_bytes: int):
    return PLSSVMError(f"{what}: a strip of one row block needs {need * _SLOT_BYTES} bytes of "
                       f"scratch, more than the {scratch_bytes} allowed")


@functools.lru_cache(maxsize=None)
def sym_strip_blocks(nb: int, scratch_bytes: int = SCRATCH_BYTES) -> int:
    """Row blocks per strip of K1 over ``nb`` row blocks: ``nb`` (one
    strip, the whole ``(nb, nb)`` slab) where that fits ``scratch_bytes``,
    else the most ``S`` with ``S (2 nb - S)`` slots within it, which bounds
    every strip's slab."""
    slots = _slots(scratch_bytes)
    if nb * nb <= slots:
        return nb
    excess = nb * nb - slots
    root = math.isqrt(excess)
    S = nb - (root + (root * root < excess))
    if S < 1:
        raise _no_strip("gram_matvec_sym", 2 * nb - 1, scratch_bytes)
    return S


def rect_strip_blocks(nbi: int, nbj: int, scratch_bytes: int = SCRATCH_BYTES,
                      sides: int = 1) -> int:
    """Row blocks of X per strip of K2 (``sides=1``: a ``(S, nbj)`` slab)
    or of Xi per strip of K3 (``sides=2``: ``(S, nbj)`` and ``(nbj, S)``),
    within ``scratch_bytes`` and the exact tier's grid."""
    S = min(nbi, _GRID_ROWS, _slots(scratch_bytes) // (sides * nbj))
    if S < 1:
        raise _no_strip("gram_matvec" if sides == 1 else "pair_gram_contrib", sides * nbj,
                        scratch_bytes)
    return S


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    out = t.new_zeros((rows, *t.shape[1:]))
    out[:t.shape[0]] = t
    return out


def _tile_partials(kernel, tier, Ao, Bo, sqa, sqb, va, vb, degree, gamma, coef0):
    """Every tile pair's partial sums of ``K = k(A, B)``, rows of both sides
    a multiple of ``CUDA_TILE`` (zero rows with zero ``v`` add nothing):
    ``row[a][b] = K_ab v_b`` ``(nA, nB, BM)`` and ``col[b][a] = K_ab^T v_a``
    ``(nB, nA, BM)``, the slots the kernels write."""
    T = CUDA_TILE
    K = kernel_transform(kernel, tier_matmul(tier, Ao, _transposed(tier, Bo)), degree, gamma,
                         coef0, None if sqa is None else sqa, sqb)
    nA, nB = K.shape[0] // T, K.shape[1] // T
    K4 = K.reshape(nA, T, nB, T)
    row = torch.einsum("arbc,bc->abr", K4, vb.reshape(nB, T))
    col = torch.einsum("arbc,ar->bac", K4, va.reshape(nA, T))
    return row, col


def _sum_slots(start: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``start + slots[:, 0] + slots[:, 1] + ...``, in that order, as the
    kernels' reductions add."""
    s = start
    for b in range(slots.shape[1]):
        s = s + slots[:, b]
    return s


def _strip_operands(kernel, tier: str, X, sq):
    """X's tier operands and (rbf) row norms, rows padded with zeros to a
    multiple of ``CUDA_TILE``."""
    Dp = _cdiv(X.shape[0], CUDA_TILE) * CUDA_TILE
    if kernel == KernelType.rbf:
        sq = _pad_rows(row_sqnorms(X) if sq is None else sq, Dp)
    return tuple(_pad_rows(t, Dp) for t in tier_operands(tier, X)), sq


def _padded_v(v):
    return _pad_rows(v, _cdiv(v.shape[0], CUDA_TILE) * CUDA_TILE)


def gram_matvec_sym_strips_plain(kernel: KernelType, X, v, *, degree=3, gamma=1.0,
                                 coef0=0.0, sq=None, tier: str = "exact",
                                 scratch_bytes: int = SCRATCH_BYTES):
    """Plain twin of K1's launch schedule under ``scratch_bytes``: for each
    strip of :func:`sym_strip_blocks` row blocks, every lower-triangle tile
    pair's partials into the strip's slots, then each row's slots added in
    ascending order, carried from strip to strip as the kernels carry them
    (``reduce_sym_strip_kernel``)."""
    T = CUDA_TILE
    D = X.shape[0]
    nb = _cdiv(D, T)
    S = sym_strip_blocks(nb, scratch_bytes)
    tier = resolve_tier(tier, X.dtype)
    ops, sqp = _strip_operands(kernel, tier, X, sq)
    vp = _padded_v(v)
    out = torch.zeros((nb, T), dtype=X.dtype, device=X.device)
    for i0 in range(0, nb, S):
        i1 = min(nb, i0 + S)
        r0, r1 = i0 * T, i1 * T
        row, col = _tile_partials(kernel, tier, _rows(ops, r0, r1), _rows(ops, 0, r1),
                                  None if sqp is None else sqp[r0:r1],
                                  None if sqp is None else sqp[:r1], vp[r0:r1], vp[:r1],
                                  degree, gamma, coef0)
        # the strip's row a takes pair (a, b)'s row side for b <= a, pair
        # (b, a)'s column side for a < b < i1
        a = torch.arange(i0, i1, device=X.device)[:, None]
        b = torch.arange(i1, device=X.device)[None, :]
        colside = torch.zeros_like(row)
        colside[:, i0:] = col[i0:i1]
        slots = torch.where((b <= a)[..., None], row, colside)
        out[i0:i1] = _sum_slots(torch.zeros_like(out[i0:i1]), slots)
        if i0:
            out[:i0] = _sum_slots(out[:i0], col[:i0])
    return out.reshape(-1)[:D]


def gram_matvec_strips_plain(kernel: KernelType, X, v, *, Y, degree=3, gamma=1.0, coef0=0.0,
                             sqx=None, sqy=None, tier: str = "exact",
                             scratch_bytes: int = SCRATCH_BYTES):
    """Plain twin of K2's schedule: strips of :func:`rect_strip_blocks` row
    blocks of X, each row's ``nbj`` tile partials added in ascending
    order."""
    T = CUDA_TILE
    nbi, nbj = _cdiv(X.shape[0], T), _cdiv(Y.shape[0], T)
    S = rect_strip_blocks(nbi, nbj, scratch_bytes)
    tier = resolve_tier(tier, X.dtype)
    (xo, sqx), (yo, sqy) = _strip_operands(kernel, tier, X, sqx), _strip_operands(kernel, tier,
                                                                                  Y, sqy)
    vp = _padded_v(v)
    out = torch.empty((nbi, T), dtype=X.dtype, device=X.device)
    for i0 in range(0, nbi, S):
        r0, r1 = i0 * T, min(nbi, i0 + S) * T
        row, _ = _tile_partials(kernel, tier, _rows(xo, r0, r1), yo,
                                None if sqx is None else sqx[r0:r1], sqy,
                                torch.zeros(r1 - r0, dtype=X.dtype, device=X.device), vp,
                                degree, gamma, coef0)
        out[i0:i0 + row.shape[0]] = _sum_slots(torch.zeros_like(row[:, 0]), row)
    return out.reshape(-1)[:X.shape[0]]


def pair_gram_contrib_strips_plain(kernel: KernelType, Xi, Xj, v_i, v_j, *, sq_i=None,
                                   sq_j=None, degree=3, gamma=1.0, coef0=0.0,
                                   tier: str = "exact", scratch_bytes: int = SCRATCH_BYTES):
    """Plain twin of K3's schedule on a cross pair: strips of
    :func:`rect_strip_blocks` (``sides=2``) row blocks of Xi; ``out_i``'s
    rows add their ``nbj`` partials, ``out_j`` adds each strip's column
    partials to what the earlier strips left, in ascending order."""
    T = CUDA_TILE
    nbi, nbj = _cdiv(Xi.shape[0], T), _cdiv(Xj.shape[0], T)
    S = rect_strip_blocks(nbi, nbj, scratch_bytes, sides=2)
    tier = resolve_tier(tier, Xi.dtype)
    (xio, sqi), (xjo, sqj) = (_strip_operands(kernel, tier, Xi, sq_i),
                              _strip_operands(kernel, tier, Xj, sq_j))
    vip, vjp = _padded_v(v_i), _padded_v(v_j)
    out_i = torch.empty((nbi, T), dtype=Xi.dtype, device=Xi.device)
    out_j = torch.zeros((nbj, T), dtype=Xi.dtype, device=Xi.device)
    for i0 in range(0, nbi, S):
        r0, r1 = i0 * T, min(nbi, i0 + S) * T
        row, col = _tile_partials(kernel, tier, _rows(xio, r0, r1), xjo,
                                  None if sqi is None else sqi[r0:r1], sqj, vip[r0:r1], vjp,
                                  degree, gamma, coef0)
        out_i[i0:i0 + row.shape[0]] = _sum_slots(torch.zeros_like(row[:, 0]), row)
        out_j = _sum_slots(out_j, col)
    return out_i.reshape(-1)[:Xi.shape[0]], out_j.reshape(-1)[:Xj.shape[0]]


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
    if tier != "exact" and shape[1] % CUDA_FEATURE_PAD:
        raise PLSSVMError(f"{name}: the {tier} tier takes operands whose feature axis is padded "
                          f"to a multiple of {CUDA_FEATURE_PAD} (tier_operands), got {shape[1]}")
    return ops[0].data_ptr(), (ops[1].data_ptr() if want == 2 else None)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise BackendError(f"{what}: CUDA error {rc} at launch")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_split(X: torch.Tensor, pad: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The split kernel (``csrc/split_bf16.cu``; replaces ``_split_bf16``,
    ``pallas_matvec.py:282``, nine eager passes and two padding copies in
    one).  Bound by bytes: 4 read and 4 written per value, which a thread
    moves as two 16-byte loads and a 16-byte store to each part."""
    if X.dim() not in (1, 2):
        raise PLSSVMError(f"split_bf16 takes a vector or a matrix, got shape {tuple(X.shape)}")
    _check("X", X, tuple(X.shape), X.device)
    rows, f = (1 if X.dim() == 1 else X.shape[0]), X.shape[-1]
    fp = _padded(f) if pad else f
    shape = (*X.shape[:-1], fp)
    hi = torch.empty(shape, dtype=torch.bfloat16, device=X.device)
    lo = torch.empty(shape, dtype=torch.bfloat16, device=X.device)
    if hi.numel() == 0:
        return hi, lo
    lib = _build.load()
    with torch.cuda.device(X.device):
        rc = lib.split_bf16_rows(X.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, f, fp,
                                 torch.cuda.current_stream(X.device).cuda_stream)
    _raise_on(rc, "split_bf16")
    launches["split_bf16"] += 1
    return hi, lo


def _launch_sym(kernel, tier, Xo, v, sq, degree, gamma, coef0, *,
                scratch_bytes: int = SCRATCH_BYTES):
    """K1 (replaces ``_gram_matvec_sym_kernel``, ``pallas_matvec.py:388``).
    Bound on the H100 by f32 FFMA throughput (exact) or by the bf16
    tensor-core product (bf16 tiers; at f = 256 the transform's special
    function op per element and the operand boxes pulled from the L2 weigh
    as much).  The exact tier runs one CTA per tile pair on an 8 x 8
    register tile; the bf16 tiers a persistent CTA per SM that feeds
    ``wgmma`` by TMA and overlaps one tile's epilogue with the next one's
    product (``csrc/gram_tile_wgmma.cuh``).  The lower-triangle pairs halve
    the flops; the slab holds one BM-long partial per (block, other block)
    and a second kernel sums it in a fixed order, one strip of
    :func:`sym_strip_blocks` row blocks per launch, the slab reused from
    strip to strip (stream order).  ``Xo`` is
    :func:`tier_operands` of X: ``f`` below is its padded feature count at
    a bf16 tier."""
    D, f = Xo[0].shape
    dev = Xo[0].device
    x_hi, x_lo = _check_operands("X", tier, Xo, (D, f), dev)
    _check("v", v, (D,), dev)
    _check("sq", sq, (D,), dev)
    out = torch.empty(D, dtype=torch.float32, device=dev)
    if D == 0:
        return out
    nb = _cdiv(D, CUDA_TILE)
    S = sym_strip_blocks(nb, scratch_bytes)
    slab = torch.empty(sym_strip_slots(nb, S) * CUDA_TILE, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i0 in range(0, nb, S):
            rc = lib.gram_matvec_sym(
                TIERS.index(tier), x_hi, x_lo, sq.data_ptr(), v.data_ptr(), slab.data_ptr(),
                out.data_ptr(), D, f, i0, min(nb, i0 + S), int(kernel), int(degree),
                float(gamma), float(coef0), stream)
            _raise_on(rc, f"gram_matvec_sym/{tier}")
            launches[f"gram_matvec_sym/{tier}"] += 1
    return out


def _launch_rect(kernel, tier, Xo, Yo, v, sqx, sqy, degree, gamma, coef0, *,
                 scratch_bytes: int = SCRATCH_BYTES):
    """K2 (replaces ``_gram_matvec_kernel``, ``pallas_matvec.py:117``).
    Bound like K1.  The exact tier runs one CTA per tile pair; the bf16
    tiers the persistent ``wgmma`` tile of ``csrc/gram_tile_wgmma.cuh`` with
    a row-only epilogue (no column side): with X's row block resident in
    shared memory and only Y streamed where it fits (f <= 576 at bf16cast,
    <= 320 at bf16x3), else with both operands streamed.  Y's rows are
    split over tiles so a one-row predict still spreads over the card, but
    each tile still runs all 128 rows: small batches pay for 128.  The slab
    holds one partial per tile pair, summed in a fixed order; X's rows run
    in strips of :func:`rect_strip_blocks` row blocks, one launch each."""
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
    S = rect_strip_blocks(nbi, nbj, scratch_bytes)
    rows = S * CUDA_TILE
    slab = torch.empty((S, nbj, CUDA_TILE), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, D, rows):
            r1 = min(D, r0 + rows)
            xs = _rows(Xo, r0, r1)
            rc = lib.gram_matvec_rect(
                TIERS.index(tier), xs[0].data_ptr(), xs[1].data_ptr() if x_lo else None,
                y_hi, y_lo, sqx[r0:].data_ptr(), sqy.data_ptr(), v.data_ptr(),
                slab.data_ptr(), out[r0:].data_ptr(), r1 - r0, N, f, int(kernel), int(degree),
                float(gamma), float(coef0), stream)
            _raise_on(rc, f"gram_matvec_rect/{tier}")
            launches[f"gram_matvec_rect/{tier}"] += 1
    return out


def _launch_pair(kernel, tier, Xio, Xjo, v_i, v_j, sq_i, sq_j, degree, gamma, coef0, *,
                 scratch_bytes: int = SCRATCH_BYTES):
    """K3, cross panels (replaces ``pair_gram_contrib``,
    ``pallas_matvec.py:716``).  Bound like K1, at twice K1's flops per
    output pair (no symmetry to skip); at the panel tier's f = 4096 the
    feature loop is nearly all of the time, which the bf16 tiers spend in
    the TMA-fed ``wgmma`` tile of ``csrc/gram_tile_wgmma.cuh``.  Each (i, j)
    tile pair writes ``K_ij v_j`` to ``slab_i[i][j]`` and ``K_ij^T v_i`` to
    ``slab_j[j][i]``; two fixed-order passes sum them.  Xi's rows run in
    strips of :func:`rect_strip_blocks` row blocks, one launch each, each
    strip's column side added to ``out_j`` in order.  ``Xio``, ``Xjo`` are
    the panels' :func:`tier_operands`, prepared by the caller once per
    panel."""
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
    S = rect_strip_blocks(nbi, nbj, scratch_bytes, sides=2)
    rows = S * CUDA_TILE
    slab_i = torch.empty((S, nbj, CUDA_TILE), dtype=torch.float32, device=dev)
    slab_j = torch.empty((nbj, S, CUDA_TILE), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, Di, rows):
            r1 = min(Di, r0 + rows)
            xs = _rows(Xio, r0, r1)
            rc = lib.gram_pair_contrib(
                TIERS.index(tier), xs[0].data_ptr(), xs[1].data_ptr() if xi_lo else None,
                xj_hi, xj_lo, sq_i[r0:].data_ptr(), sq_j.data_ptr(), v_i[r0:].data_ptr(),
                v_j.data_ptr(), slab_i.data_ptr(), slab_j.data_ptr(), out_i[r0:].data_ptr(),
                out_j.data_ptr(), r1 - r0, Dj, f, int(r0 > 0), int(kernel), int(degree),
                float(gamma), float(coef0), stream)
            _raise_on(rc, f"gram_pair_contrib/{tier}")
            launches[f"gram_pair_contrib/{tier}"] += 1
    return out_i, out_j


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def make_sym_matvec(kernel: KernelType, X, *, degree=3, gamma=1.0, coef0=0.0,
                    tier: str | None = None, scratch_bytes: int = SCRATCH_BYTES,
                    sq=None, operands=None):
    """Build ``v -> K(X, X) v`` (K1) at ``tier`` (``None``:
    :func:`pallas_tier`).  The row norms and the tier's split or cast of X
    are computed once here, outside the returned closure, as the JAX
    package does (``pallas_matvec.py:663-668``), so a CG loop pays only for
    the kernel; a caller that has them passes ``sq`` (:func:`row_sqnorms`)
    and ``operands`` (:func:`tier_operands` at the tier).
    ``scratch_bytes`` bounds the kernel's slab per launch (the plain version
    holds none)."""
    tier = resolve_tier(tier, X.dtype)
    sq = row_sqnorms(X) if sq is None else sq
    Xo = tier_operands(tier, X) if operands is None else operands

    def matvec(v):
        if X.is_cuda:
            return _launch_sym(kernel, tier, Xo, v, sq, degree, gamma, coef0,
                               scratch_bytes=scratch_bytes)
        return gram_matvec_sym_plain(kernel, X, v, degree=degree, gamma=gamma,
                                     coef0=coef0, sq=sq, tier=tier, operands=Xo)

    return matvec


def gram_matvec_sym(kernel: KernelType, X, v, *, degree=3, gamma=1.0, coef0=0.0,
                    tier: str | None = None, scratch_bytes: int = SCRATCH_BYTES):
    """One-shot ``K(X, X) v`` through K1 — see :func:`make_sym_matvec`."""
    return make_sym_matvec(kernel, X, degree=degree, gamma=gamma, coef0=coef0, tier=tier,
                           scratch_bytes=scratch_bytes)(v)


def gram_matvec(kernel: KernelType, X, v, *, Y=None, degree=3, gamma=1.0,
                coef0=0.0, sqx=None, sqy=None, tier: str | None = None, operands=None,
                scratch_bytes: int = SCRATCH_BYTES):
    """``K(X, Y) v`` through K2 (``Y`` defaults to ``X``) at ``tier``
    (``None``: :func:`pallas_tier`): the poly/rbf predict, and the implicit
    A·v with the symmetric kernel disabled, which passes ``operands``
    (``(Xo, Yo)`` of :func:`tier_operands`) prepared once.
    ``scratch_bytes`` bounds the kernel's slab per launch."""
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
    return _launch_rect(kernel, tier, *operands, v, sqx, sqy, degree, gamma, coef0,
                        scratch_bytes=scratch_bytes)


def pair_gram_contrib(kernel: KernelType, Xi, Xj, v_i, v_j, *, same: bool, sq_i=None,
                      sq_j=None, degree=3, gamma=1.0, coef0=0.0, tier: str | None = None,
                      operands=None, scratch_bytes: int = SCRATCH_BYTES):
    """Panel-pair contributions of ``K = k(Xi, Xj)`` without building K, with
    the JAX package's contract (``pallas_matvec.py:734-755``): returns
    ``(out_i, out_j)`` sliced to the real row counts, ``out_i = K v_j`` and
    ``out_j = K^T v_i``.  ``same=True`` (the diagonal panel, ``Xj`` is
    ``Xi``) only promises ``out_i + out_j = K(Xi, Xi) v_i``: it runs K1 on
    the panel and returns ``(K v_i, 0)``, counted under
    ``gram_matvec_sym``.  ``operands`` passes ``(Xio, Xjo)``, each panel's
    :func:`tier_operands`, from a caller that prepares a panel once for all
    of its pairs (the panel schedules of ``ops/sparse.py``); without it the
    tier's split or cast runs here, per call, once for both sides when
    ``same=True`` (``pallas_matvec.py:319-326``).  Padding rows must be
    zero, with zero ``v``.  ``scratch_bytes`` bounds the kernel's slabs per
    launch."""
    tier = resolve_tier(tier, Xi.dtype)
    sq_i = row_sqnorms(Xi) if sq_i is None else sq_i
    if same:
        if not Xi.is_cuda:
            return pair_gram_contrib_plain(kernel, Xi, Xi, v_i, v_i, same=True, sq_i=sq_i,
                                           sq_j=sq_i, degree=degree, gamma=gamma,
                                           coef0=coef0, tier=tier, operands=operands)
        Xio, _ = _pair_operands(tier, Xi, Xi, True, operands)
        out = _launch_sym(kernel, tier, Xio, v_i, sq_i, degree, gamma, coef0,
                          scratch_bytes=scratch_bytes)
        return out, torch.zeros_like(out)
    sq_j = row_sqnorms(Xj) if sq_j is None else sq_j
    if not Xi.is_cuda:
        return pair_gram_contrib_plain(kernel, Xi, Xj, v_i, v_j, same=False, sq_i=sq_i,
                                       sq_j=sq_j, degree=degree, gamma=gamma, coef0=coef0,
                                       tier=tier, operands=operands)
    Xio, Xjo = _pair_operands(tier, Xi, Xj, False, operands)
    return _launch_pair(kernel, tier, Xio, Xjo, v_i, v_j, sq_i, sq_j, degree, gamma, coef0,
                        scratch_bytes=scratch_bytes)
