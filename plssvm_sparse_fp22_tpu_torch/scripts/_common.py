"""What the tools share: the device they run on, its synchronisation, the
card's name and power limit, and the JSON last line."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..io.libsvm import ParsedData
from ..params import Parameter
from ..types import BackendType


@contextlib.contextmanager
def environ(**env):
    """Set (a value) or unset (None) environment variables for the block:
    the port reads ``PLSSVM_MATMUL_PRECISION``, ``PLSSVM_SPARSE_MODE`` and
    the K-cache budget per call, so one process serves every tier."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device(cpu: bool) -> torch.device:
    """The CPU where ``cpu``, else the first card; no card and no ``--cpu``
    is an error, not a silent fall-back."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: run on an NVIDIA GPU, or pass --cpu for "
                         "the plain versions on the CPU")
    return torch.device("cuda", 0)


def backend_of(dev: torch.device) -> BackendType:
    return BackendType.cuda if dev.type == "cuda" else BackendType.torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card (the line that goes
    beside every number taken on it); None on the CPU."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)
    lines = out.stdout.strip().splitlines()
    return lines[dev.index or 0] if out.returncode == 0 and lines else \
        torch.cuda.get_device_name(dev)


def wall(dev: torch.device, fn) -> float:
    """Seconds of ``fn()``, the device synchronised before and after."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def two_blobs(n: int, f: int, seed: int = 11):
    """The JAX precision study's data (``scripts/precision_study.py``): two
    gaussian blobs at -0.4 and +0.4, float32, shuffled, labels +-1."""
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.vstack([rng.normal(-0.4, 1.0, size=(half, f)),
                   rng.normal(0.4, 1.0, size=(n - half, f))]).astype(np.float32)
    y = np.concatenate([-np.ones(half), np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def parameter(X: np.ndarray, y: np.ndarray, **kw) -> Parameter:
    """A one-device ``Parameter`` over dense rows, printing nothing."""
    p = Parameter(devices=1, print_info=False, **kw)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    return p


def emit(result: dict) -> dict:
    """Print ``result`` as the last line and return it."""
    print(json.dumps(result), flush=True)
    return result
