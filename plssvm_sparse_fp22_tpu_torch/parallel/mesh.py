"""Device-mesh construction helpers.

Counterpart of the JAX package's ``parallel/mesh.py`` and of the
reference's device enumeration (``CUDA/csvm.cu:52-63``).  A mesh here is an
ordered list of ``torch.device`` entries, one per shard of the data axis,
and **one process drives all of them**, as the reference does
(``gpu_csvm.cpp:130-157``).  A list may name the same device more than
once: the shards are then logical, which runs the sharded learns on the
CPU, or a ring of several shards on one card.
"""

from __future__ import annotations

import torch


DATA_AXIS = "data"


def make_mesh(num_devices: int | None = None, devices=None) -> list[torch.device]:
    """The 1-D data mesh over the first ``num_devices`` entries of
    ``devices`` (default: every visible CUDA device, else the CPU).  With
    more shards asked for than devices given, the devices repeat in order
    (logical shards)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if num_devices is None:
        return devices
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num_devices}")
    return [devices[i % len(devices)] for i in range(num_devices)]
