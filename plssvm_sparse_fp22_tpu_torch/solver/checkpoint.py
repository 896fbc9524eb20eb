"""CG-state checkpointing: save/resume training mid-solve.

Port of the JAX package's ``solver/checkpoint.py``, a capability extension
over the reference, whose only checkpoint is the final model file
(SURVEY.md §5).  The resumable :class:`~.cg.CGState` (iteration counter, x,
r, d, delta, delta0) plus the setup vectors (q, QA_cost) are everything
needed to continue a solve bit-exactly; the iteration counter keeps the
50-step residual refresh aligned across resumes.

Files are numpy ``.npz`` archives with the JAX package's keys (``version,
k, x, r, d, delta, delta0, q, QA_cost, meta_*``), written atomically (temp +
rename): numpy on disk, torch tensors in memory.  A file written by either
package loads in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .cg import CGState


CHECKPOINT_VERSION = 1


def _to_numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_cg_checkpoint(path: str, state: CGState, q, QA_cost, meta: dict) -> None:
    """Atomically write the CG state + setup vectors + metadata."""
    payload = {
        "version": CHECKPOINT_VERSION,
        "k": np.asarray(int(state.k)),
        "x": _to_numpy(state.x),
        "r": _to_numpy(state.r),
        "d": _to_numpy(state.d),
        "delta": _to_numpy(state.delta),
        "delta0": _to_numpy(state.delta0),
        "q": _to_numpy(q),
        "QA_cost": _to_numpy(QA_cost),
    }
    for key, value in meta.items():
        payload[f"meta_{key}"] = np.asarray(value)

    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_cg_checkpoint(path: str, device=None, dtype: torch.dtype | None = None):
    """Load ``(CGState, q, QA_cost, meta)`` or ``None`` if the file is
    absent or of another version.  The tensors go to ``device`` and
    ``dtype`` (``None``: the CPU, the dtype on disk); ``k`` is a Python
    int, as everywhere in :class:`~.cg.CGState`."""
    if not os.path.exists(path):
        return None

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    with np.load(path) as z:
        if int(z["version"]) != CHECKPOINT_VERSION:
            return None
        state = CGState(
            k=int(z["k"]),
            x=tensor(z["x"]),
            r=tensor(z["r"]),
            d=tensor(z["d"]),
            delta=tensor(z["delta"]),
            delta0=tensor(z["delta0"]),
        )
        q = tensor(z["q"])
        QA_cost = tensor(z["QA_cost"])
        meta = {
            key[len("meta_"):]: z[key] for key in z.files if key.startswith("meta_")
        }
    return state, q, QA_cost, meta
