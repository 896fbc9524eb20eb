"""Device-mesh construction helpers.

Counterpart of the JAX package's ``parallel/mesh.py`` and of the
reference's device enumeration (``CUDA/csvm.cu:52-63``).  A mesh here is an
ordered list of ``torch.device`` entries, one per shard of the data axis.
In one process it is a plain list and **the process drives all of its
devices**, as the reference does (``gpu_csvm.cpp:130-157``).  A list may
name the same device more than once: the shards are then logical, which
runs the sharded learns on the CPU, or a ring of several shards on one card.

Once a process group spans several processes (``parallel/distributed.py``),
:func:`make_mesh` returns a :class:`GlobalMesh`: every rank's shards in rank
order, each entry recorded with the rank that owns it.  A rank holds and
computes only its own shards; the device names of other ranks' shards are
theirs, not this process's.
"""

from __future__ import annotations

import torch


DATA_AXIS = "data"


class GlobalMesh(list):
    """A mesh that spans processes: the shards of every rank, in rank order,
    ``ranks[i]`` the owner of shard ``i`` and ``rank`` this process's rank.
    Every rank holds the same number of shards, as one contiguous run."""

    def __init__(self, devices, ranks, rank: int):
        super().__init__(torch.device(d) for d in devices)
        self.ranks, self.rank = tuple(ranks), rank
        world = max(self.ranks) + 1
        per = len(self) // world
        if world < 2 or self.ranks != tuple(r for r in range(world) for _ in range(per)):
            raise ValueError(f"a global mesh needs two ranks or more, each rank's shards in "
                             f"one run, in rank order and equal in number, got owners "
                             f"{self.ranks}")
        #: the shards this process holds, in order
        self.local = [i for i, r in enumerate(self.ranks) if r == rank]


def local_shards(mesh) -> list[int]:
    """The shards of ``mesh`` this process holds: all of a one-process
    mesh's."""
    return mesh.local if isinstance(mesh, GlobalMesh) else list(range(len(mesh)))


def spans_processes(mesh) -> bool:
    return isinstance(mesh, GlobalMesh)


def place_local(mesh, blocks, dtype: torch.dtype | None = None) -> list:
    """``blocks``, one per shard this process holds and in their order, each
    contiguous on its shard's device; None for the other ranks' shards."""
    out = [None] * len(mesh)
    for i, blk in zip(local_shards(mesh), blocks, strict=True):
        out[i] = blk.to(device=mesh[i], dtype=dtype).contiguous()
    return out


def make_local_mesh(num_devices: int | None = None, devices=None) -> list[torch.device]:
    """The 1-D data mesh of this process alone, over the first
    ``num_devices`` entries of ``devices`` (default: every visible CUDA
    device, else the CPU).  With more shards asked for than devices given,
    the devices repeat in order (logical shards)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if num_devices is None:
        return devices
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num_devices}")
    return [devices[i % len(devices)] for i in range(num_devices)]


def make_mesh(num_devices: int | None = None, devices=None) -> list[torch.device]:
    """The 1-D data mesh: :func:`make_local_mesh` in one process.  Where a
    process group of several ranks is up, the global mesh of
    ``num_devices`` shards (default: one per device of each rank), an equal
    share of them on each rank over that rank's ``devices`` (default: its
    own device, ``distributed.rank_device``); one ``all_gather_object``
    collects every rank's devices."""
    from . import distributed

    if distributed.world_size() == 1:
        return make_local_mesh(num_devices, devices)
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and (num_devices < world or num_devices % world):
        raise ValueError(f"{num_devices} shards do not divide evenly over {world} processes")
    local = make_local_mesh(None if num_devices is None else num_devices // world,
                            devices if devices is not None else [distributed.rank_device()])
    every = [None] * world
    dist.all_gather_object(every, [str(d) for d in local])
    return GlobalMesh([d for names in every for d in names],
                      [r for r, names in enumerate(every) for _ in names], rank)
