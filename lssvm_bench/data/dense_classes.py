"""Dense two-class data: per class a normal law whose mean is drawn per
feature from the seed, optionally squashed into (-1, 1) (``range: unit``)
as LIBSVM's scaled copies are.  ``one_hot: k`` makes the first k features
the 0/1 code of one of k categories, drawn per point from a law of its
class; a row then stores its nonzero entries alone, as a LIBSVM file of
such data does.  Sizes come from the configuration; the seed changes the
values, never the sizes."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from . import Dataset, generator


def _rows(g, n, law, share, squash, device):
    mean, spread, cats = law
    y = torch.where(torch.rand(n, generator=g, device=device, dtype=torch.float64) < share,
                    1.0, -1.0).to(torch.float64)
    z = torch.randn(n, mean.numel(), generator=g, device=device, dtype=torch.float64)
    x = z * spread + 0.5 * y[:, None] * mean
    x = torch.tanh(x) if squash else x
    if cats is not None:
        pick = torch.multinomial(cats[(y > 0).long()], 1, generator=g)
        code = torch.zeros(n, cats.shape[1], device=device, dtype=torch.float64)
        x = torch.cat([code.scatter_(1, pick, 1.0), x], dim=1)
    return x, y


def make(config: dict, seed: int, device, test_sets: int = 0) -> Dataset:
    spec = config["data"]
    n, f, nt = int(config["rows"]), int(config["features"]), int(config.get("test_rows", 0))
    k = int(spec.get("one_hot", 0))
    g = generator(seed, device)
    mean = torch.randn(f - k, generator=g, device=device, dtype=torch.float64)
    mean *= spec["separation"]
    spread = 0.5 + torch.rand(f - k, generator=g, device=device, dtype=torch.float64)
    cats = None
    if k:
        logits = torch.randn(2, k, generator=g, device=device, dtype=torch.float64)
        cats = torch.softmax(logits * spec["separation"], dim=1)
    squash = spec.get("range", "unit") == "unit"
    share = float(spec["positive_share"])
    law = (mean, spread, cats)
    X, y = _rows(g, n, law, share, squash, device)
    tests = [_rows(g, nt, law, share, squash, device)[0].cpu().numpy()
             for _ in range(test_sets)]
    X = X.cpu().numpy()
    # a file's parse: each row's nonzero entries, in column order
    return Dataset(csr=sp.csr_matrix(X), y=y.cpu().numpy(), dense=X, tests=tests)
