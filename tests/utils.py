"""Shared test helpers.

Mirrors the reference's comparison tooling: the mixed relative/absolute
floating-point compare with ``eps = 128 * scale * machine_eps``
(``tests/utility.hpp:118-136``).
"""

from __future__ import annotations

import numpy as np


def mixed_close(a, b, scale: float = 1.0, dtype=np.float64) -> bool:
    """Mixed rel/abs compare (``tests/utility.hpp:118-136``)."""
    eps = 128.0 * scale * np.finfo(dtype).eps
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    denom = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return bool(np.all(diff <= eps * denom))


def make_blobs(n: int, f: int, seed: int = 42, dtype=np.float64):
    """Two separable-ish gaussian blobs with +1/-1 labels."""
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.concatenate(
        [
            rng.normal(loc=+1.0, scale=1.0, size=(half, f)),
            rng.normal(loc=-1.0, scale=1.0, size=(n - half, f)),
        ]
    ).astype(dtype)
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def zipf_csr(n: int, f: int, nnz_per_row: float = 74.0, seed: int = 0,
             exponent: float = 1.1, offset: float = 10.0):
    """Text-like sparse rows in rcv1's shape (``lssvm_bench/data/sparse_docs.py``):
    log-normal row lengths around ``nnz_per_row``, Zipf-distributed columns
    over a permutation, positive values, rows of unit norm; canonical CSR,
    float64."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    p = (np.arange(f) + offset) ** -exponent
    p = p / p.sum()
    perm = rng.permutation(f)
    lengths = np.clip(np.round(rng.lognormal(np.log(nnz_per_row) - 0.32, 0.8, n)), 1, f)
    cols = perm[rng.choice(f, size=int(lengths.sum()), p=p)]
    rows = np.repeat(np.arange(n), lengths.astype(np.int64))
    csr = sp.csr_matrix((rng.random(rows.size) + 1e-3, (rows, cols)), shape=(n, f))
    csr.sum_duplicates()
    norms = np.sqrt(np.asarray(csr.multiply(csr).sum(axis=1)).ravel())
    out = sp.csr_matrix(sp.diags(1.0 / norms) @ csr)
    out.sum_duplicates()
    return out
