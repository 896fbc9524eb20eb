"""Sparse (CSR/ELL) feature matrices: packings, products and the streaming
Gram matvecs of the sparse learns.

Port of the JAX package's ``ops/sparse.py``.  The packings are built on the
host with numpy, as there, and their arrays become tensors on the device the
caller names.  What changed on the way:

- ``jax.ops.segment_sum`` becomes :func:`segment_sum`, an
  ``index_put_(accumulate=True)``.  On a CUDA tensor PyTorch runs that as a
  sort followed by one ordered sum per segment, so the sparse products are
  bitwise repeatable from run to run (``index_add_`` / ``scatter_add_`` add
  with atomics in no fixed order, and CG iteration counts would wander).
  On a CPU tensor it adds with atomics across threads.  The linear learn
  avoids most of it: it contracts ``X^T v`` by rows of a transposed
  packing (``models/sparse_learn.py``).
- :func:`densify_tiled` places the nonzeros with one index-put into a zeroed
  buffer.  The JAX package's broadcast compare exists because a TPU
  serialises scatter; the card does not.
- The panel matvecs are Python loops that call the panel-pair kernel K3
  (:func:`~.gram_matvec.pair_gram_contrib`) or its plain version.  The
  ``unrolled`` schedule densifies each panel once per matvec and keeps the
  sweep's panels alive, which is what XLA's common-subexpression
  elimination gave the JAX package; ``windowed`` keeps one i-panel and one
  j-panel alive.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..types import BackendType, KernelType
from .gram_matvec import (pair_gram_contrib, pair_gram_contrib_plain, resolve_tier,
                          tier_operands)
from .kernel_functions import integer_pow, kernel_diag
from .matvec import fixed_tier

#: column tile of the tiled packings (the TPU lane width, kept so packings
#: and padded widths match the JAX package's)
TILE = 128


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ``out[s] = sum(data[segment_ids == s])``
    along the first axis, repeatable on the card (see the module note)."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_put_((segment_ids.long(),), data, accumulate=True)


@dataclass
class ELLMatrix:
    """ELLPACK: row-major nonzeros padded to a uniform row length.

    ``values[i, l]`` / ``cols[i, l]`` hold the l-th nonzero of row i; padding
    slots have value 0 and column 0 (harmless: 0 * anything).
    """

    values: torch.Tensor  # (n, L)
    cols: torch.Tensor  # (n, L) int32
    shape: tuple[int, int]

    @property
    def row_capacity(self) -> int:
        return self.values.shape[1]

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None,
                 device="cpu") -> "ELLMatrix":
        """Pack a scipy CSR matrix; optionally zero-pad to ``pad_rows`` rows."""
        n, f = csr.shape
        rows_out = pad_rows if pad_rows is not None else n
        nnz_per_row = np.diff(csr.indptr)
        L = max(1, int(nnz_per_row.max()) if n else 1)
        values = np.zeros((rows_out, L), dtype=dtype)
        cols = np.zeros((rows_out, L), dtype=np.int32)
        # entry k of the CSR stream lands at (row(k), k - row_start(row(k)))
        rows = np.repeat(np.arange(n), nnz_per_row)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
        values[rows, pos] = csr.data
        cols[rows, pos] = csr.indices
        return ELLMatrix(values=_tensor(values, device), cols=_tensor(cols, device),
                         shape=(rows_out, f))


def ell_matvec(ell: ELLMatrix, u: torch.Tensor) -> torch.Tensor:
    """X @ u for dense u (f,): gather u at each nonzero column, row-sum."""
    return torch.sum(ell.values * u[ell.cols], dim=1)


def ell_rmatvec(ell: ELLMatrix, v: torch.Tensor) -> torch.Tensor:
    """X^T @ v for dense v (n,): add row contributions per column.

    Off the one-device learn's path: it forms X^T v as ``hybrid_matvec`` on
    the transposed packing, faster on the card; the sparse linear ring
    (``parallel/sharded.py``) takes this scatter form, the JAX package's
    (``sparse.py:74-93``), for each shard's partial."""
    contributions = (ell.values * v[:, None]).reshape(-1)
    return segment_sum(contributions, ell.cols.reshape(-1), ell.shape[1])


def ell_row_sqnorms(ell: ELLMatrix) -> torch.Tensor:
    """Row squared norms (for the RBF distance expansion)."""
    return torch.sum(ell.values * ell.values, dim=1)


@dataclass
class HybridSparse:
    """ELL + COO hybrid: rows are ELL-packed up to a capped row length and
    the overflow nonzeros of skewed rows spill into a COO tail, so one dense
    row does not inflate every row's padding.  The cap minimises
    ``n * Lcap + 3 * overflow`` over the nnz histogram."""

    ell: ELLMatrix
    coo_rows: torch.Tensor  # (m,) int32
    coo_cols: torch.Tensor  # (m,) int32
    coo_vals: torch.Tensor  # (m,)

    @property
    def shape(self) -> tuple[int, int]:
        return self.ell.shape

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None,
                 device="cpu") -> "HybridSparse":
        n, f = csr.shape
        nnz_per_row = np.diff(csr.indptr)
        max_l = int(nnz_per_row.max()) if n else 0
        counts = np.bincount(nnz_per_row, minlength=max_l + 1)
        tail = np.cumsum(counts[::-1])[::-1]  # tail[L] = #rows with nnz >= L
        suffix = np.concatenate([np.cumsum(tail[::-1])[::-1], [0]])
        overflow = suffix[1:]  # overflow[L] = sum_i max(0, nnz_i - L)
        Ls = np.arange(max_l + 1)
        Lcap = max(1, int(Ls[np.argmin(n * Ls + 3 * overflow)]))

        rows_out = pad_rows if pad_rows is not None else n
        values = np.zeros((rows_out, Lcap), dtype=dtype)
        cols = np.zeros((rows_out, Lcap), dtype=np.int32)
        rows = np.repeat(np.arange(n), nnz_per_row)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
        in_ell = pos < Lcap
        values[rows[in_ell], pos[in_ell]] = csr.data[in_ell]
        cols[rows[in_ell], pos[in_ell]] = csr.indices[in_ell]
        ell = ELLMatrix(values=_tensor(values, device), cols=_tensor(cols, device),
                        shape=(rows_out, f))
        tail_sel = ~in_ell
        return HybridSparse(
            ell=ell,
            coo_rows=_tensor(rows[tail_sel].astype(np.int32), device),
            coo_cols=_tensor(csr.indices[tail_sel].astype(np.int32), device),
            coo_vals=_tensor(csr.data[tail_sel].astype(dtype), device),
        )


def hybrid_matvec(h: HybridSparse, u: torch.Tensor) -> torch.Tensor:
    """X @ u over the ELL part + COO tail."""
    out = ell_matvec(h.ell, u)
    if h.coo_vals.shape[0]:
        out = out + segment_sum(h.coo_vals * u[h.coo_cols], h.coo_rows, h.ell.shape[0])
    return out


def hybrid_rmatvec(h: HybridSparse, v: torch.Tensor) -> torch.Tensor:
    """X^T @ v over the ELL part + COO tail (see :func:`ell_rmatvec`)."""
    out = ell_rmatvec(h.ell, v)
    if h.coo_vals.shape[0]:
        out = out + segment_sum(h.coo_vals * v[h.coo_rows], h.coo_cols, h.ell.shape[1])
    return out


def hybrid_row_sqnorms(h: HybridSparse) -> torch.Tensor:
    out = ell_row_sqnorms(h.ell)
    if h.coo_vals.shape[0]:
        out = out + segment_sum(h.coo_vals * h.coo_vals, h.coo_rows, h.ell.shape[0])
    return out


@dataclass
class TiledELL:
    """Tiled ELL: each row's nonzeros are bucketed per 128-wide column tile
    and padded to the worst per-(row, tile) fill ``Lt``.  ``lcols`` holds
    the column inside the tile; padding slots carry value 0 at local column
    0.  Storage is ``rows * ntiles * Lt`` values and int32 local columns."""

    vals: torch.Tensor  # (rows, ntiles * Lt)
    lcols: torch.Tensor  # (rows, ntiles * Lt) int32 in [0, 128)
    shape: tuple[int, int]  # logical (rows, f)
    ntiles: int
    Lt: int

    @property
    def padded_features(self) -> int:
        return self.ntiles * TILE

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None,
                 device="cpu") -> "TiledELL":
        tell, heavy_idx, _ = pack_tiled_hybrid(csr, dtype=dtype, pad_rows=pad_rows,
                                               cap=None, device=device)
        assert heavy_idx.size == 0  # cap=None packs every row
        return tell


@dataclass
class TiledHybrid:
    """Tiled-ELL light rows + a small dense block of heavy rows: ``Lt`` is
    capped at the memory-optimal value and the few rows whose worst tile
    fill exceeds it are carried dense, so one dense-ish row cannot inflate
    ``Lt`` to 128.  Memory is ``rows*ntiles*Lt + h*fp``."""

    tell: TiledELL  # light rows (heavy rows zeroed inside)
    heavy_idx: np.ndarray  # (h,) host int array: the heavy rows' positions
    heavy: torch.Tensor  # (h, ntiles*128) dense heavy rows

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None,
                 device="cpu") -> "TiledHybrid":
        tell, heavy_idx, heavy = pack_tiled_hybrid(csr, dtype=dtype, pad_rows=pad_rows,
                                                   device=device)
        return TiledHybrid(tell=tell, heavy_idx=heavy_idx, heavy=_tensor(heavy, device))

    @property
    def cells(self) -> int:
        """Storage in value-sized units: a light slot is a value and an int32
        column (2 units), a heavy cell 1."""
        return 2 * self.tell.vals.numel() + self.heavy.numel()


def pack_tiled_hybrid(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None,
                      cap: int | None = 0, device="cpu"):
    """Pack a CSR into ``(TiledELL light rows, heavy_idx, heavy_dense)``.

    ``cap=None`` disables the heavy split (Lt = global max fill); ``cap=0``
    picks the memory-optimal Lt over the row-max-fill histogram, minimising
    ``rows*ntiles*Lt*(itemsize + 4) + h(Lt)*ntiles*128*itemsize`` bytes where
    ``h(Lt)`` counts rows whose worst tile fill exceeds Lt."""
    csr = csr.tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    n, f = csr.shape
    rows_out = pad_rows if pad_rows is not None else n
    ntiles = max(1, -(-f // TILE))
    nnz_per_row = np.diff(csr.indptr)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = csr.indices
    tile = cols // TILE
    lcol = (cols % TILE).astype(np.int32)
    # slot inside each (row, tile) bucket: indices are sorted per row, so a
    # bucket's entries are contiguous in the CSR stream
    key = rows.astype(np.int64) * ntiles + tile
    if key.size:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        bucket_start = np.repeat(starts, np.diff(np.r_[starts, key.size]))
        slot = np.arange(key.size) - bucket_start
        bucket_fill = slot + 1
        rowmax = np.zeros(n, np.int64)
        np.maximum.at(rowmax, rows, bucket_fill)
        max_fill = int(bucket_fill.max())
    else:
        slot = np.zeros(0, np.int64)
        rowmax = np.zeros(n, np.int64)
        max_fill = 1

    if cap is None or max_fill <= 1:
        Lt = max(1, max_fill)
        heavy_mask = np.zeros(n, bool)
    else:
        itemsize = np.dtype(dtype).itemsize
        counts = np.bincount(rowmax, minlength=max_fill + 1)
        rows_above = counts[::-1].cumsum()[::-1]  # rows with rowmax >= k
        cands = np.arange(1, max_fill + 1)
        h = np.concatenate([rows_above[2:], [0]])  # rows with rowmax > Lt
        cost = (rows_out * ntiles * cands * (itemsize + 4)
                + h * (ntiles * TILE) * itemsize)
        Lt = int(cands[np.argmin(cost)]) if cap == 0 else min(int(cap), max_fill)
        heavy_mask = rowmax > Lt

    heavy_idx = np.flatnonzero(heavy_mask)
    light_sel = ~heavy_mask[rows] if rows.size else np.zeros(0, bool)
    vals = np.zeros((rows_out, ntiles * Lt), dtype=dtype)
    lcols = np.zeros((rows_out, ntiles * Lt), dtype=np.int32)
    pos = tile * Lt + slot
    vals[rows[light_sel], pos[light_sel]] = csr.data[light_sel]
    lcols[rows[light_sel], pos[light_sel]] = lcol[light_sel]
    heavy = np.zeros((len(heavy_idx), ntiles * TILE), dtype=dtype)
    if len(heavy_idx):
        heavy[:, :f] = csr[heavy_idx].toarray()
    tell = TiledELL(vals=_tensor(vals, device), lcols=_tensor(lcols, device),
                    shape=(rows_out, f), ntiles=ntiles, Lt=Lt)
    return tell, heavy_idx, heavy


def tiled_global_cols(ntiles: int, Lt: int, device="cpu") -> torch.Tensor:
    """Per-slot tile base offsets: global column = lcols + base."""
    return (torch.arange(ntiles * Lt, dtype=torch.int64, device=device) // Lt) * TILE


def densify_tiled(vals: torch.Tensor, lcols: torch.Tensor, ntiles: int, Lt: int):
    """Densify a tiled-ELL slab (m, ntiles*Lt) -> (m, ntiles*128) with one
    index-put into a zeroed buffer.  Padding slots carry value 0 at local
    column 0, the cell of a real entry of the same tile, so the put
    accumulates: every cell then receives at most one nonzero, and the
    result is exact and independent of the order of the writes."""
    m = vals.shape[0]
    fp = ntiles * TILE
    cols = lcols.long() + tiled_global_cols(ntiles, Lt, vals.device)[None, :]
    flat = (torch.arange(m, device=vals.device)[:, None] * fp + cols).reshape(-1)
    out = torch.zeros(m * fp, dtype=vals.dtype, device=vals.device)
    out.index_put_((flat,), vals.reshape(-1), accumulate=True)
    return out.view(m, fp)


def tiled_matvec(tell_vals, tell_lcols, u, ntiles: int, Lt: int):
    """X @ u from the tiled packing for a dense u of length >= ntiles*128
    (zero-padded): gather + row sum; padding slots hit the tile base with
    value 0."""
    gcols = tell_lcols.long() + tiled_global_cols(ntiles, Lt, u.device)[None, :]
    return torch.sum(tell_vals * u[gcols], dim=1)


def stream_panel_rows(D: int, fp: int, itemsize: int, budget_bytes: int) -> int:
    """Row count of the transient dense panels of the ``panel`` strategy:
    ``budget / (8 fp itemsize)`` rounded down to 256 rows, at least 256 (the
    JAX package's sizing, so both packages cut the same panels)."""
    per_row = max(1, 8 * fp * itemsize)
    C = budget_bytes // per_row
    C = max(256, (C // 256) * 256)
    return min(D, C)


def _heavy_by_panel(heavy_rows, starts, device):
    """For each panel starting at ``starts[p]`` (host ints, ascending), the
    local rows and the indices into ``heavy`` of its heavy rows, as index
    tensors, so a densify places all of them with one index-put (one
    launch per panel, not one copy per row)."""
    placed = []
    for p, lo in enumerate(starts):
        hi = starts[p + 1] if p + 1 < len(starts) else None
        ks = [k for k, r in enumerate(heavy_rows) if r >= lo and (hi is None or r < hi)]
        placed.append(None if not ks else (
            torch.tensor([int(heavy_rows[k]) - lo for k in ks], device=device),
            torch.tensor(ks, device=device)))
    return placed


def _pair_fn(use_cuda: bool, precision: str | None, dtype):
    """K3 (it raises on a CUDA tensor it cannot take) or its plain version,
    and the tier of its products: ``precision``, else the backend's fixed
    tier (:func:`~.matvec.fixed_tier`), resolved for the panels' dtype."""
    backend = BackendType.cuda if use_cuda else BackendType.torch
    tier = resolve_tier(fixed_tier(backend) if precision is None else precision, dtype)
    return (pair_gram_contrib if use_cuda else pair_gram_contrib_plain), tier


def make_tiled_panel_matvec(tell_vals, tell_lcols, kernel_int: int, degree: int,
                            gamma, coef0, *, ntiles: int, Lt: int, panel_rows: int,
                            use_cuda: bool, heavy=None, heavy_rows: tuple = (),
                            heavy_sq_vec=None, precision: str | None = None):
    """``v -> K(X, X) @ v`` for tiled-ELL-packed X through transient dense
    panels, ``unrolled`` schedule: each matvec densifies every panel once
    (:func:`densify_tiled`) and keeps them alive for the sweep over the
    lower-triangular panel pairs; a diagonal pair runs ``same=True`` (K1 on
    the card), every other pair K3 with both directions from one pass.

    Heavy rows (:class:`TiledHybrid`) replace their zeroed light rows after
    the densify; ``heavy_sq_vec`` (zero at light rows) completes the squared
    norms.  ``precision`` is the pairs' tier (:func:`_pair_fn`).  Each
    panel's operands for the tier (the bf16 split or cast,
    :func:`~.gram_matvec.tier_operands`) are prepared once per densify and
    handed to every pair that uses the panel; the JAX package splits inside
    each pair (``sparse.py:437-438``) and leaves the sharing to XLA, which
    eager PyTorch does not do.  Returns ``(matvec, sq)``."""
    kernel = KernelType(kernel_int)
    D = tell_vals.shape[0]
    bounds = list(range(0, D, panel_rows)) + [D]  # a ragged last panel is fine
    nP = len(bounds) - 1
    sq = torch.sum(tell_vals * tell_vals, dim=1)
    if heavy_sq_vec is not None:
        sq = sq + heavy_sq_vec
    fn, tier = _pair_fn(use_cuda, precision, tell_vals.dtype)
    kw = {"degree": degree, "gamma": gamma, "coef0": coef0, "tier": tier}
    placed = _heavy_by_panel(heavy_rows, bounds[:-1], tell_vals.device)

    def densify(p):
        base = densify_tiled(tell_vals[bounds[p]:bounds[p + 1]],
                             tell_lcols[bounds[p]:bounds[p + 1]], ntiles, Lt)
        if placed[p] is not None:
            base[placed[p][0]] = heavy[placed[p][1]]
        return base

    def matvec(v):
        v = v.to(tell_vals.dtype)
        panels = [densify(p) for p in range(nP)]
        ops = [tier_operands(tier, panel) for panel in panels]
        outs = [torch.zeros(bounds[p + 1] - bounds[p], dtype=tell_vals.dtype,
                            device=tell_vals.device) for p in range(nP)]
        for I in range(nP):
            loI, hiI = bounds[I], bounds[I + 1]
            for J in range(I + 1):
                loJ, hiJ = bounds[J], bounds[J + 1]
                oi, oj = fn(kernel, panels[I], panels[J], v[loI:hiI], v[loJ:hiJ],
                            same=J == I, sq_i=sq[loI:hiI], sq_j=sq[loJ:hiJ],
                            operands=(ops[I], ops[J]), **kw)
                outs[I] = outs[I] + oi
                outs[J] = outs[J] + oj
        return torch.cat(outs) if nP > 1 else outs[0]

    return matvec, sq


def panel_sweep_strategy(nP: int, dense_bytes: int | None = None,
                         physical_bytes: int | None = None) -> str:
    """Pair-sweep schedule of the ``panel`` matvec: ``unrolled`` (every
    panel alive for the sweep, each densified once per matvec) while four
    times the padded-dense bytes fit the device's memory, else ``windowed``
    (one i-panel and one j-panel alive).  ``PLSSVM_SPARSE_PANEL_SWEEP``
    forces either.  The factor 4 is the JAX package's measured transient
    envelope; the port's unrolled sweep holds the dense panels plus one
    pair's temporaries, so it is conservative here."""
    forced = os.environ.get("PLSSVM_SPARSE_PANEL_SWEEP", "auto")
    if forced in ("unrolled", "windowed"):
        return forced
    if nP <= 1:
        return "unrolled"  # single panel: the schedules coincide
    if dense_bytes is None or physical_bytes is None:
        return "unrolled"
    return "unrolled" if 4 * dense_bytes <= physical_bytes else "windowed"


def make_tiled_panel_matvec_windowed(tell_vals, tell_lcols, kernel_int: int, degree: int,
                                     gamma, coef0, *, ntiles: int, Lt: int,
                                     panel_rows: int, use_cuda: bool, heavy=None,
                                     heavy_rows: tuple = (), heavy_sq_vec=None,
                                     precision: str | None = None):
    """``v -> K(X, X) @ v`` for tiled-ELL-packed X, ``windowed`` schedule:
    the diagonal panels first (``same=True``), then the strict-lower panel
    pairs in i-major order, re-densifying the i-panel only when ``i``
    advances and each j-panel for its pair.  At most two dense panels are
    alive at a time.  Panels are uniform (``panel_rows`` rows; the packing
    is padded with zero rows to a panel multiple).  ``precision`` as for
    :func:`make_tiled_panel_matvec`; a panel's operands are prepared once
    per densify, so the i-panel's serve every pair of its row.  Returns
    ``(matvec, sq)`` like :func:`make_tiled_panel_matvec`."""
    kernel = KernelType(kernel_int)
    dtype, dev = tell_vals.dtype, tell_vals.device
    D = tell_vals.shape[0]
    P = min(panel_rows, D)
    nP = -(-D // P)
    Dp = nP * P
    if Dp != D:
        pad = Dp - D
        tell_vals = torch.cat([tell_vals, tell_vals.new_zeros((pad, tell_vals.shape[1]))])
        tell_lcols = torch.cat([tell_lcols, tell_lcols.new_zeros((pad, tell_lcols.shape[1]))])
    sq = torch.sum(tell_vals * tell_vals, dim=1)
    if heavy_sq_vec is not None:
        sq[:D] += heavy_sq_vec
    placed = _heavy_by_panel(heavy_rows, list(range(0, Dp, P)), dev)
    fn, tier = _pair_fn(use_cuda, precision, dtype)
    kw = {"degree": degree, "gamma": gamma, "coef0": coef0, "tier": tier}

    def densify(p):
        """Panel p and its operands for the tier."""
        base = densify_tiled(tell_vals[p * P:(p + 1) * P], tell_lcols[p * P:(p + 1) * P],
                             ntiles, Lt)
        if placed[p] is not None:
            base[placed[p][0]] = heavy[placed[p][1]]
        return base, tier_operands(tier, base)

    def matvec(v):
        v = v.to(dtype)
        v_pad = v if Dp == D else torch.cat([v, v.new_zeros(Dp - D)])
        out = torch.zeros(Dp, dtype=dtype, device=dev)
        for i in range(nP):
            s = slice(i * P, (i + 1) * P)
            Xd, Xdo = densify(i)
            oi, oj = fn(kernel, Xd, Xd, v_pad[s], v_pad[s], same=True, sq_i=sq[s],
                        sq_j=sq[s], operands=(Xdo, Xdo), **kw)
            out[s] += oi + oj
        icur, Xi, Xio = -1, None, None
        for i in range(nP):
            for j in range(i):
                if i != icur:
                    icur, (Xi, Xio) = i, densify(i)
                si, sj = slice(i * P, (i + 1) * P), slice(j * P, (j + 1) * P)
                Xj, Xjo = densify(j)
                oi, oj = fn(kernel, Xi, Xj, v_pad[si], v_pad[sj], same=False,
                            sq_i=sq[si], sq_j=sq[sj], operands=(Xio, Xjo), **kw)
                out[si] += oi
                out[sj] += oj
        return out[:D]

    return matvec, sq[:D]


def host_gram_from_csr(csr: sp.csr_matrix, dept: int | None = None) -> np.ndarray:
    """Dense Gram ``G = X X^T`` with scipy sparse BLAS (host, float64): the
    cached-mode set-up for poly/rbf over sparse features too wide for the
    device Gram; X itself is never densified."""
    Xs = csr if dept is None else csr[:dept]
    return np.asarray((Xs @ Xs.T).todense(), dtype=np.float64)


def host_cross_gram_from_csr(csr_a: sp.csr_matrix, csr_b: sp.csr_matrix) -> np.ndarray:
    """Dense cross Gram ``A B^T`` on the host (the sparse predict)."""
    return np.asarray((csr_a @ csr_b.T).todense(), dtype=np.float64)


def device_gram_from_ell(ell: ELLMatrix) -> torch.Tensor:
    """Dense Gram ``G = X X^T`` on the device from the ELL packing: one
    index-put densifies X (a transient (n, f) buffer, budget-gated by the
    caller) and one matrix product builds G."""
    n, f = ell.shape
    rows = torch.arange(n, device=ell.values.device)[:, None].expand_as(ell.cols)
    X = torch.zeros((n, f), dtype=ell.values.dtype, device=ell.values.device)
    X.index_put_((rows, ell.cols.long()), ell.values, accumulate=True)
    return X @ X.T


def _transform_block(kernel_int: int, G, sq_i, sq_j, degree, gamma, coef0):
    """Kernel transform of a streamed Gram block (``kernel_types.hpp:69-84``).
    ``kernel_int``: 0 linear, 1 polynomial, 2 rbf."""
    if kernel_int == 0:
        return G
    if kernel_int == 1:
        return integer_pow(gamma * G + coef0, degree)
    d2 = sq_i[:, None] + sq_j[None, :] - 2.0 * G
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def streaming_stream_strategy(L: int, f: int) -> str:
    """The streaming contraction: ``panel`` (transient dense panels on the
    pair kernel, O(n²·f) flops) unless the row fill is below f/1024, where
    the nnz-proportional ``gather`` wins.  ``PLSSVM_SPARSE_STREAM`` forces
    either (``mxu`` is the JAX package's legacy name for ``panel``).  The
    1024 is the JAX package's MXU-to-VPU rate ratio, not measured on the
    card."""
    forced = os.environ.get("PLSSVM_SPARSE_STREAM", "auto")
    if forced == "mxu":
        return "panel"
    if forced in ("panel", "gather"):
        return forced
    return "gather" if L * 1024 < f else "panel"


def make_streaming_gram_matvec(h: HybridSparse, kernel_int: int, degree: int, gamma,
                               coef0, *, bm: int | None = None, bn: int | None = None):
    """``v -> K(X, X) @ v`` streamed from the ELL+COO packing with the
    nnz-proportional ``gather`` contraction: O(n·L) resident memory, neither
    the (n, n) kernel matrix nor the (n, f) dense data is built.  Rows
    beyond the real data must be zero.  Returns ``(matvec, sq)``."""
    n, f = h.shape
    if bm is None:
        bm = 512 if n % 512 == 0 else 128
    if bn is None:
        bn = 128
    if n % bm != 0 or n % bn != 0:
        raise ValueError(f"padded rows {n} must divide by bm={bm}, bn={bn}")
    sq = hybrid_row_sqnorms(h)
    contrib = make_streaming_cross_contrib(
        kernel_int, degree, gamma, coef0, row_vals=h.ell.values, row_cols=h.ell.cols,
        row_sq=sq, row_trow=h.coo_rows, row_tcol=h.coo_cols, row_tval=h.coo_vals,
        f=f, bm=bm, bn=bn)

    def matvec(v):
        return contrib(h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols, h.coo_vals, sq, v)

    return matvec, sq


def sparse_q_qa_kii(kernel_int: int, degree: int, gamma, coef0, g_last, sq_last, sq,
                    mask, cost_inv):
    """``q_i = k(x_i, x_last)``, ``QA_cost`` and the kernel diagonal ``kii``
    from the linear building blocks ``g_last = <x_i, x_last>``, ``sq_last``
    and ``sq`` (all row-local)."""
    kii = kernel_diag(KernelType(kernel_int), sq, degree, gamma, coef0)
    if kernel_int == 1:  # polynomial
        q = integer_pow(gamma * g_last + coef0, degree) * mask
        QA = integer_pow(gamma * sq_last + coef0, degree) + cost_inv
    elif kernel_int == 2:  # rbf
        d2 = sq + sq_last - 2.0 * g_last
        q = torch.exp(-gamma * torch.clamp(d2, min=0.0)) * mask
        QA = torch.ones((), dtype=g_last.dtype, device=g_last.device) + cost_inv
    else:  # linear
        q = g_last * mask
        QA = sq_last + cost_inv
    return q, QA, kii


#: bytes of the (rows, L, bn) gather a ``gather``-arm step may hold at once;
#: row blocks beyond it are contracted in turn
GATHER_CHUNK_BYTES = 256 * 1024**2


def make_streaming_cross_contrib(kernel_int: int, degree: int, gamma, coef0, *,
                                 row_vals, row_cols, row_sq, row_trow, row_tcol,
                                 row_tval, f: int, bm: int, bn: int,
                                 strategy: str = "gather"):
    """The ``gather`` contraction core: ``contrib(panel_vals, panel_cols,
    panel_trow, panel_tcol, panel_tval, panel_sq, v) -> sum_j K(x_i, x_j)
    v_j`` over all panel rows, for every row of the ELL+COO row side closed
    over here.  Per ``bn``-row panel J the columns are densified transposed
    once (an index-put), then the row side contracts its ELL slots against
    it with a gather: O(nnz · bn) work.  The row side is taken ``bm``-row
    blocks at a time, as many as keep the gather within
    :data:`GATHER_CHUNK_BYTES`."""
    if strategy != "gather":
        raise ValueError(
            f"unknown streaming contraction strategy '{strategy}' "
            "(the dense-block path is make_tiled_panel_matvec)")
    n_rows, L = row_vals.shape
    if n_rows % bm != 0:
        raise ValueError(f"row side {n_rows} must divide by bm={bm}")
    dtype, dev = row_vals.dtype, row_vals.device
    has_row_tail = int(row_tval.shape[0]) > 0
    row_cols = row_cols.long()
    per_row = max(1, L * bn * row_vals.element_size())
    chunk = max(bm, (GATHER_CHUNK_BYTES // per_row) // bm * bm)
    row_in_bn = torch.arange(bn, device=dev)[:, None]

    def contrib(panel_vals, panel_cols, panel_trow, panel_tcol, panel_tval, panel_sq, v):
        m_panel, Lp = panel_vals.shape
        if m_panel % bn != 0:
            raise ValueError(f"panel side {m_panel} must divide by bn={bn}")
        has_panel_tail = int(panel_tval.shape[0]) > 0
        v = v.to(dtype)
        acc = torch.zeros(n_rows, dtype=dtype, device=dev)
        for j0 in range(0, m_panel, bn):
            # densify the J panel transposed: XJdT[col, j] += val (a cell gets
            # at most one nonzero; padding slots add 0)
            XJdT = torch.zeros((f, bn), dtype=dtype, device=dev)
            XJdT.index_put_((panel_cols[j0:j0 + bn].long(), row_in_bn.expand(bn, Lp)),
                            panel_vals[j0:j0 + bn], accumulate=True)
            if has_panel_tail:
                in_j = (panel_trow >= j0) & (panel_trow < j0 + bn)
                jloc = torch.clamp(panel_trow.long() - j0, 0, bn - 1)
                XJdT.index_put_((panel_tcol.long(), jloc),
                                torch.where(in_j, panel_tval, torch.zeros_like(panel_tval)),
                                accumulate=True)
            vJ, sqJ = v[j0:j0 + bn], panel_sq[j0:j0 + bn]
            if has_row_tail:
                # row-side tail: G[r, :] += val_e * XJdT[col_e, :] per tail entry e
                G_tail = segment_sum(row_tval[:, None] * XJdT[row_tcol.long()], row_trow,
                                     n_rows)
            out = torch.empty(n_rows, dtype=dtype, device=dev)
            for r0 in range(0, n_rows, chunk):
                r1 = min(n_rows, r0 + chunk)
                gath = XJdT[row_cols[r0:r1]]  # (rows, L, bn)
                G = torch.bmm(row_vals[r0:r1, None, :], gath)[:, 0, :]
                if has_row_tail:
                    G = G + G_tail[r0:r1]
                K = _transform_block(kernel_int, G, row_sq[r0:r1], sqJ, degree, gamma,
                                     coef0)
                out[r0:r1] = K @ vJ
            acc = acc + out
        return acc

    return contrib


#: widest feature count for which the device Gram assembly is used; beyond
#: it the host SpGEMM takes over (news20-scale data)
DEVICE_GRAM_MAX_FEATURES = 65536


def device_gram_max_features() -> int:
    """``PLSSVM_DEVICE_GRAM_MAX_FEATURES`` or :data:`DEVICE_GRAM_MAX_FEATURES`."""
    try:
        return int(os.environ.get("PLSSVM_DEVICE_GRAM_MAX_FEATURES",
                                  DEVICE_GRAM_MAX_FEATURES))
    except ValueError:
        return DEVICE_GRAM_MAX_FEATURES
