"""The sparse gram tier's Gram ``G = X X^T`` from the CSR rows, on the device.

The JAX package forms this Gram with one product of the densified rows
(``plssvm_sparse_fp22_tpu/models/base.py:944-950``, XLA).  At text-like
sparsity nearly all of that product's work multiplies zeros: rcv1's rows
are 0.16 % dense, and its Gram needs sum over columns of count² = 2.6e9
multiply-adds where the dense product does D² f = 1.9e13.  So the float32
gram tier splits the columns by their counts (:func:`split_rows`):

- the **heavy** columns, those holding at least ``T`` rows, are scattered
  into a dense (D, h) slab, h padded to a multiple of 8, and one float32
  product ``slab @ slab.T`` (TF32 off, ``ops/kernel_functions.py``) writes
  G;
- the **light** columns' entries add their pairs into G
  (:func:`sparse_gram_pairs`): a kernel written for the card
  (``csrc/sparse_gram.cu``) on a CUDA tensor, :func:`sparse_gram_pairs_plain`
  on a CPU one.

A column goes to the slab where that costs less than its pairs
(:func:`split_threshold`): the slab's product costs D² per column at the
measured rate ``SPARSE_GRAM_SLAB_RATE``, the column's pairs count² at
``SPARSE_GRAM_PAIR_RATE``, so a column is heavy when its count reaches
``T = D sqrt(PAIR_RATE / SLAB_RATE)``, 0.14 D.  Inputs whose columns all
hold more than that come out all heavy, which is the dense product over the
occupied columns only; rcv1's split falls at T = 2861.  Every step is
ordered, so G is the same bits on every run; ``sq`` is G's diagonal, so the
rbf distance of a point to itself is exactly 0.

The rows arrive as :func:`~.sparse.stage_csr_rows` stages them: row counts,
column indices and values of rows in canonical form (sorted columns, no
repeats).  From the same rows :func:`rows_matvec` forms the tier's products
with the last point, ``q_lin = X x_last``, on their device, in a fixed order
(the kernel ``sparse_rows_matvec`` of ``csrc/sparse_gram.cu`` on a card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..constants import SPARSE_GRAM_PAIR_RATE, SPARSE_GRAM_SLAB_RATE
from ..exceptions import PLSSVMError
from . import _build
from .gram_matvec import _raise_on

#: kernel launches of :func:`sparse_gram_pairs` and :func:`rows_matvec`
#: since the last :func:`reset_launches`
launches = {"sparse_gram_pairs": 0, "sparse_rows_matvec": 0}

#: the slab's width is padded to a multiple of this (its product's tiles)
SLAB_PAD = 8

#: the lanes over which :func:`rows_matvec` deals a row's entries (the
#: kernel's warp)
ROW_LANES = 32


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass
class RowsSplit:
    """The rows of a Gram split by column: ``slab`` (D, hp) holds the heavy
    columns' entries (zero elsewhere, padding rows included); ``rptr``
    (dept + 1, int64), ``rcol`` (int32), ``rval``: the rows' light entries
    in stored order; ``cptr`` (f + 1, int64), ``crow`` (int32, ascending in
    each column), ``cval``: the light columns' lists.  ``threshold`` is T,
    ``heavy`` the heavy columns h, ``light_pairs`` sum of light count²."""

    slab: torch.Tensor
    rptr: torch.Tensor
    rcol: torch.Tensor
    rval: torch.Tensor
    cptr: torch.Tensor
    crow: torch.Tensor
    cval: torch.Tensor
    threshold: int
    heavy: int
    light_pairs: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_threshold(D: int) -> int:
    """T: the least count at which a column's pairs (count² at
    ``SPARSE_GRAM_PAIR_RATE``) cost at least its column of the slab's
    product (D² at ``SPARSE_GRAM_SLAB_RATE``)."""
    return max(1, math.ceil(D * math.sqrt(SPARSE_GRAM_PAIR_RATE / SPARSE_GRAM_SLAB_RATE)))


def split_rows(counts: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, D: int, f: int,
               *, threshold: int | None = None) -> RowsSplit:
    """Split the rows (``counts`` per row, int64; ``cols`` int64 and
    ``vals`` of every stored entry, row by row, each row's columns
    ascending) at T (:func:`split_threshold`, or ``threshold``) on their
    device: the column counts, the heavy columns' slab (D rows), the light
    entries by row and by column (a stable sort keeps each column's rows
    ascending).  One read of the split's numbers is the only wait for the
    device; integer counts are added in any order to the same result."""
    dev = vals.device
    dept, nnz = counts.shape[0], vals.shape[0]
    if dept > D:
        raise PLSSVMError(f"split_rows: {dept} rows do not fit {D}")
    if f == 0:
        raise PLSSVMError("split_rows: no features")
    rows = torch.repeat_interleave(torch.arange(dept, device=dev), counts, output_size=nnz)
    ones = torch.ones_like(cols)
    col_counts = torch.zeros(f, dtype=torch.int64, device=dev).index_add_(0, cols, ones)
    T = split_threshold(D) if threshold is None else threshold
    is_heavy = col_counts >= T
    light_counts = torch.where(is_heavy, 0, col_counts)
    h, P, nl = torch.stack([is_heavy.sum(), (light_counts * light_counts).sum(),
                            light_counts.sum()]).tolist()
    heavy_entry = is_heavy[cols]
    hidx = torch.nonzero_static(heavy_entry, size=nnz - nl).squeeze(1)
    lidx = torch.nonzero_static(~heavy_entry, size=nl).squeeze(1)
    slab = torch.zeros((D, _round_up(h, SLAB_PAD)), dtype=vals.dtype, device=dev)
    on_slab = torch.cumsum(is_heavy, 0) - 1                 # a heavy column's slab column
    slab.view(-1).index_copy_(0, rows[hidx] * slab.shape[1] + on_slab[cols[hidx]], vals[hidx])
    lrows, lcols, lvals = rows[lidx], cols[lidx], vals[lidx]
    rptr = torch.zeros(dept + 1, dtype=torch.int64, device=dev)
    rptr[1:] = torch.cumsum(torch.zeros(dept, dtype=torch.int64, device=dev)
                            .index_add_(0, lrows, ones[:nl]), 0)
    cptr = torch.zeros(f + 1, dtype=torch.int64, device=dev)
    cptr[1:] = torch.cumsum(light_counts, 0)
    order = torch.sort(lcols, stable=True).indices
    return RowsSplit(slab=slab, rptr=rptr, rcol=lcols.int(), rval=lvals, cptr=cptr,
                     crow=lrows[order].int(), cval=lvals[order], threshold=T, heavy=h,
                     light_pairs=P)


def gram_from_rows(split: RowsSplit) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G, sq)``: the (D, D) Gram of the split's rows, padding rows and
    columns zero, and its diagonal.  The slab's product writes G (or G
    starts at zero where no column is heavy), then the light pairs are
    added (:func:`sparse_gram_pairs`, where any are left)."""
    slab = split.slab
    D = slab.shape[0]
    if slab.shape[1]:
        G = slab @ slab.T
    else:
        G = torch.zeros((D, D), dtype=slab.dtype, device=slab.device)
    if split.rcol.numel():
        sparse_gram_pairs(G, split.rptr, split.rcol, split.rval, split.cptr, split.crow,
                          split.cval)
    return G, torch.diagonal(G).clone()


def sparse_gram_pairs_plain(G, rptr, rcol, rval, cptr, crow, cval) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, in place on ``G``: in round r,
    the r-th light entry (k, v) of every row i that has one adds ``v * w``
    to ``G[i, j]`` for each (j, w) of column k's list.  Within a round the
    (i, j) are distinct (one entry a row, distinct j in a list), and the
    rounds follow each row's stored order, so each ``G[i, j]`` takes its
    terms in the kernel's order, each product and sum rounded as there."""
    ld = G.shape[1]
    flat = G.view(-1)
    dev = G.device
    per_row = rptr[1:] - rptr[:-1]
    rnd = 0
    while True:
        rows = torch.nonzero(per_row > rnd).squeeze(1)
        if rows.numel() == 0:
            return G
        e = rptr[rows] + rnd
        k = rcol[e].long()
        lo = cptr[k]
        c = cptr[k + 1] - lo
        total = int(c.sum())
        which = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), c,
                                        output_size=total)
        start = torch.cumsum(c, 0) - c
        t = lo[which] + torch.arange(total, device=dev) - start[which]
        idx = rows[which] * ld + crow[t].long()
        flat[idx] = flat[idx] + rval[e][which] * cval[t]
        rnd += 1


def sparse_gram_pairs(G, rptr, rcol, rval, cptr, crow, cval, *, max_chunk: int = 0
                      ) -> torch.Tensor:
    """Add the light pairs into ``G`` (D, D) in place (:class:`RowsSplit`'s
    arrays over the first ``rptr.numel() - 1`` rows).  A CUDA tensor
    (float32, contiguous) takes the kernel, a CPU tensor the plain
    version.  ``max_chunk`` > 0 caps the floats of a row the kernel keeps
    in one block, so that a small G takes its chunked walk (which a D above
    some 57,000 takes anyway); the bits do not change."""
    if not G.is_cuda:
        return sparse_gram_pairs_plain(G, rptr, rcol, rval, cptr, crow, cval)
    return _launch_pairs(G, rptr, rcol, rval, cptr, crow, cval, max_chunk)


def _launch_pairs(G, rptr, rcol, rval, cptr, crow, cval, max_chunk=0):
    """The pair kernel (``csrc/sparse_gram.cu``; replaces no TPU kernel: the
    JAX package's dense product multiplies the zeros this skips).  Bound by
    the light pairs' updates, each a list entry read from the L2 and a float
    of shared memory, and by the touched rows of G, read and written once:
    a block keeps its row in shared memory and walks the row's light
    entries in order, a barrier between two."""
    D = G.shape[0]
    dev = G.device
    rows, nl = rptr.shape[0] - 1, rcol.shape[0]
    f = cptr.shape[0] - 1
    for name, t, shape, dtype in (("G", G, (D, D), torch.float32),
                                  ("rptr", rptr, (rows + 1,), torch.int64),
                                  ("rcol", rcol, (nl,), torch.int32),
                                  ("rval", rval, (nl,), torch.float32),
                                  ("cptr", cptr, (f + 1,), torch.int64),
                                  ("crow", crow, (nl,), torch.int32),
                                  ("cval", cval, (nl,), torch.float32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise PLSSVMError(f"sparse_gram_pairs: {name} is {t.dtype} {tuple(t.shape)} on "
                              f"{t.device}, expected {dtype} {shape} on {dev}, contiguous: "
                              "the kernel takes float32 only")
    if rows > D:
        raise PLSSVMError(f"sparse_gram_pairs: {rows} rows do not fit G's {D}")
    if rows == 0 or nl == 0:
        return G
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.sparse_gram_pairs(G.data_ptr(), D, rows, rptr.data_ptr(), rcol.data_ptr(),
                                   rval.data_ptr(), cptr.data_ptr(), crow.data_ptr(),
                                   cval.data_ptr(), max_chunk,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sparse_gram_pairs")
    launches["sparse_gram_pairs"] += 1
    return G


def rows_matvec(counts: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                D: int) -> torch.Tensor:
    """``q`` (D,): ``q[i] = sum_e vals[e] * x[cols[e]]`` over row i's
    entries (``counts`` per row, int64; ``cols`` int64 and ``vals`` row by
    row, as :func:`split_rows` takes them), zero from row
    ``counts.numel()`` on.  A CUDA tensor (float32, contiguous) takes the
    kernel, a CPU tensor :func:`rows_matvec_plain`, bit for bit the same:
    lane l of :data:`ROW_LANES` adds a row's entries l, l + 32, ... in turn,
    then the lanes' sums are added in halves.  On a card it reads nothing
    on the host."""
    rptr = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=vals.device)
    rptr[1:] = torch.cumsum(counts, 0)
    if not vals.is_cuda:
        return rows_matvec_plain(rptr, cols, vals, x, D)
    return _launch_rows_matvec(rptr, cols, vals, x, D)


def rows_matvec_plain(rptr, cols, vals, x, D) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (``rptr``: the rows' offsets into
    ``cols``, ``vals``): in round r, lane l of row i adds the row's entry
    ``r * ROW_LANES + l``, a rounded product to a rounded sum; then the
    lanes' sums are added in halves (lane l and lane l + h for h = 16, 8,
    ..., 1), the kernel's ``__shfl_down_sync`` tree."""
    dept, nnz = rptr.numel() - 1, vals.numel()
    dev = vals.device
    rows = torch.repeat_interleave(torch.arange(dept, device=dev), rptr[1:] - rptr[:-1],
                                   output_size=nnz)
    pos = torch.arange(nnz, device=dev) - rptr[rows]
    slot = rows * ROW_LANES + pos % ROW_LANES
    rnd = pos // ROW_LANES
    prod = vals * x[cols]
    part = torch.zeros(dept * ROW_LANES, dtype=vals.dtype, device=dev)
    for r in range(int(rnd.max()) + 1 if nnz else 0):
        now = rnd == r   # one entry a lane in a round
        part[slot[now]] = part[slot[now]] + prod[now]
    p = part.view(dept, ROW_LANES)
    while p.shape[1] > 1:
        h = p.shape[1] // 2
        p = p[:, :h] + p[:, h:]
    q = torch.zeros(D, dtype=vals.dtype, device=dev)
    q[:dept] = p[:, 0]
    return q


def _launch_rows_matvec(rptr, cols, vals, x, D):
    """The kernel ``sparse_rows_matvec`` (``csrc/sparse_gram.cu``; replaces
    no TPU kernel: the JAX package forms these products on the host with
    scipy).  A warp a row; bound by the entries' 12 bytes each and the
    gathered float of ``x``."""
    dev = vals.device
    rows, nnz, f = rptr.shape[0] - 1, vals.shape[0], x.shape[0]
    for name, t, shape, dtype in (("rptr", rptr, (rows + 1,), torch.int64),
                                  ("cols", cols, (nnz,), torch.int64),
                                  ("vals", vals, (nnz,), torch.float32),
                                  ("x", x, (f,), torch.float32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise PLSSVMError(f"rows_matvec: {name} is {t.dtype} {tuple(t.shape)} on "
                              f"{t.device}, expected {dtype} {shape} on {dev}, contiguous: "
                              "the kernel takes float32 only")
    if rows > D:
        raise PLSSVMError(f"rows_matvec: {rows} rows do not fit {D}")
    q = torch.empty(D, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.sparse_rows_matvec(q.data_ptr(), D, rows, rptr.data_ptr(), cols.data_ptr(),
                                    vals.data_ptr(), x.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sparse_rows_matvec")
    launches["sparse_rows_matvec"] += 1
    return q
