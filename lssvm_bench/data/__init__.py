"""Data generators, one module per kind, named by a configuration's
``data.kind``.  Each module has ``make(config, seed, device)`` returning a
:class:`Dataset`: the inputs of a run, drawn from the seed on the device in
a few large calls and handed to the program and to the reference alike."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp


@dataclass
class Dataset:
    """Training rows as a CSR matrix (float64, canonical), with the dense
    rows where the data is dense; labels in {-1, +1}; test sets of rows."""

    csr: sp.csr_matrix
    y: np.ndarray
    dense: np.ndarray | None = None
    tests: list = field(default_factory=list)

    @property
    def rows(self) -> int:
        return self.csr.shape[0]

    @property
    def features(self) -> int:
        return self.csr.shape[1]


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number; folded into the 64 bits a generator takes)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(config: dict, seed: int, device, test_sets: int = 0) -> Dataset:
    """The configuration's training set and ``test_sets`` test sets of its
    ``test_rows`` rows, from ``seed``."""
    kind = config["data"]["kind"]
    return importlib.import_module(f"{__name__}.{kind}").make(config, seed, device, test_sets)
