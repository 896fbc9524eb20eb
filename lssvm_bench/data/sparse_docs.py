"""Sparse text-like data in the shape of LIBSVM's rcv1.binary: log-normal
row lengths around ``nnz_per_row``, Zipf-distributed column ids over a
permutation of the columns, positive tf-idf-like values, rows of unit norm,
labels from a planted sparse linear rule with some flipped.  Sizes come from
the configuration; the seed changes the values and the pattern."""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from . import Dataset, generator


def _docs(g, n, f, spec, perm, idf, device):
    mean, sigma = float(spec["nnz_per_row"]), float(spec["row_length_sigma"])
    mu = math.log(mean) - sigma * sigma / 2.0
    z = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    lengths = torch.clamp(torch.round(torch.exp(mu + sigma * z)), 1, f).to(torch.int64)
    total = int(lengths.sum())
    ranks = torch.arange(f, device=device, dtype=torch.float64)
    p = (ranks + float(spec["zipf_offset"])) ** -float(spec["zipf_exponent"])
    cols = perm[torch.multinomial(p / p.sum(), total, replacement=True, generator=g)]
    rows = torch.repeat_interleave(torch.arange(n, device=device), lengths)
    tf = -torch.log(torch.rand(total, generator=g, device=device, dtype=torch.float64)) + 1e-3
    key, inverse = torch.unique(rows * f + cols, return_inverse=True)
    vals = torch.zeros(key.numel(), device=device, dtype=torch.float64)
    vals.index_add_(0, inverse, tf)
    r, c = key // f, key % f
    vals = vals * idf[c]
    norm = torch.zeros(n, device=device, dtype=torch.float64).index_add_(0, r, vals * vals)
    vals = vals / torch.sqrt(norm)[r]
    return r, c, vals


def make(config: dict, seed: int, device, test_sets: int = 0) -> Dataset:
    spec = config["data"]
    n, f = int(config["rows"]), int(config["features"])
    g = generator(seed, device)
    perm = torch.randperm(f, generator=g, device=device)
    ranks = torch.empty(f, device=device, dtype=torch.float64)
    ranks[perm] = torch.arange(f, device=device, dtype=torch.float64)
    idf = torch.log1p(ranks + float(spec["zipf_offset"]))  # rarer columns weigh more
    if test_sets:
        raise ValueError("sparse_docs makes no test sets yet")
    r, c, vals = _docs(g, n, f, spec, perm, idf, device)
    # the planted rule: a sparse weight vector, its median as threshold
    w = torch.randn(f, generator=g, device=device, dtype=torch.float64)
    w = w * (torch.rand(f, generator=g, device=device, dtype=torch.float64)
             < float(spec["rule_share"]))
    score = torch.zeros(n, device=device, dtype=torch.float64).index_add_(0, r, vals * w[c])
    y = torch.where(score > torch.median(score), 1.0, -1.0).to(torch.float64)
    flip = torch.rand(n, generator=g, device=device, dtype=torch.float64) < float(
        spec["label_noise"])
    y = torch.where(flip, -y, y)
    counts = torch.bincount(r, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    csr = sp.csr_matrix((vals.cpu().numpy(), c.cpu().numpy(), indptr), shape=(n, f))
    return Dataset(csr=csr, y=y.cpu().numpy())
