"""Several processes, one problem: ``torch.distributed`` set-up and transport.

Port of the JAX package's ``parallel/distributed.py``.  There,
``jax.distributed.initialize`` joins every host into one runtime and the
same ``shard_map`` learns span all chips.  Here :func:`initialize_distributed`
joins the processes into one ``torch.distributed`` process group,
``mesh.make_mesh`` then returns the global mesh (every rank's shards in
rank order), and the row-sharded learns, predict and ``w`` of
``parallel/sharded.py`` run across the processes: each rank computes its
own shards, the CG vectors are whole and bitwise equal on every rank, and
the shards' partials and rows cross ranks through the helpers below.

Every byte that crosses ranks passes through :func:`all_gather` or
:func:`post`; each adds what this rank sends and receives to
:data:`traffic` (``scripts/comms_check.py`` reads it per A·v).

Typical use, one process per rank::

    from plssvm_sparse_fp22_tpu_torch.parallel import distributed, mesh, sharded

    distributed.initialize_distributed("10.0.0.1:29500", num_processes=2, process_id=rank)
    m = mesh.make_mesh(4)                        # 2 shards on each of 2 ranks
    Xs = distributed.make_global_row_sharded(m, my_rows)
    learn = sharded.make_sharded_learn(m, kernel, degree, "implicit", backend=BackendType.cuda)

The transport is NCCL where the process sees a CUDA device and every rank
that ``LOCAL_WORLD_SIZE`` puts on the host has a card of its own, else
gloo: on the CPU, and for ranks that share a card, which NCCL refuses
(ranks that share a card without ``LOCAL_WORLD_SIZE`` pass
``backend="gloo"``).  Gloo moves CPU tensors only, so a CUDA tensor crosses ranks
through host memory, as the reference's ``device_reduction`` does
(``gpu_csvm.cpp:366-386``).  Every transfer is sent as its bytes, so blocks
of mixed dtypes (bf16 operands, float32 norms, int32 columns) travel alike.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..exceptions import PLSSVMError
from .mesh import local_shards, place_local

#: seconds the rendezvous and every collective may take before they raise
DEFAULT_TIMEOUT = 600.0

#: bytes this rank sent to and received from other ranks, per transport
#: helper, since the last :func:`reset_traffic`: an all-gather of ``n``
#: bytes sends them to each of the other ranks and receives as many from
#: each; a posted transfer counts its tensor's bytes once
traffic = {"all_gather/sent": 0, "all_gather/received": 0, "post/sent": 0, "post/received": 0}


def reset_traffic() -> None:
    for key in traffic:
        traffic[key] = 0


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           backend: str | None = None,
                           timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Join this process to the process group at ``coordinator_address``
    (``host:port``; rank 0 listens there) as rank ``process_id`` of
    ``num_processes``.  Returns whether more than one process is running.

    Idempotent: once a group is up, it returns ``world_size > 1``.  With no
    coordinator given, ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` of the environment are used; with none there either, it
    returns False and the process stays alone, as the JAX function does.
    A coordinator that was named but cannot be reached within ``timeout``
    seconds raises ``PLSSVMError``; it never falls back to one process.

    ``backend=None`` picks NCCL where CUDA is present and every rank on this
    host has a card of its own, else gloo; :func:`transport` reads the
    choice back.  The ranks on this host are ``LOCAL_WORLD_SIZE``, as
    ``torchrun`` sets it, and 1 where it is not set (one rank per host).
    Where ``LOCAL_WORLD_SIZE`` puts several ranks on the host and
    ``OMP_NUM_THREADS`` is not set, each runs PyTorch on one thread, as
    ``torchrun`` does: a thread per core in every rank oversubscribes the
    cores, and OpenMP threads spin between parallel regions."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")):
            return False
        init_method = "env://"
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '')}")
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ.get("RANK", -1)) if process_id is None else process_id
    else:
        init_method = f"tcp://{coordinator_address}"
        if num_processes is None or process_id is None:
            num_processes = int(os.environ.get("WORLD_SIZE", -1))
            process_id = int(os.environ.get("RANK", -1))
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise PLSSVMError(f"initialize_distributed needs a process count and a rank below it, "
                          f"got {num_processes} and {process_id}")
    if backend is None:
        backend = _default_backend()
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                                rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    except dist.DistError as exc:
        raise PLSSVMError(f"cannot join the process group at {coordinator_address} as rank "
                          f"{process_id} of {num_processes}: {exc}") from exc
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    if _local_world() > 1 and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)
    return num_processes > 1


def _local_world() -> int:
    """Ranks on this host, as ``LOCAL_WORLD_SIZE`` (which ``torchrun`` sets)
    says; 1 where it is not set."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def _default_backend() -> str:
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= _local_world()):
        return "nccl"
    return "gloo"


def world_size() -> int:
    """Processes in the group, 1 where none is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def transport() -> str | None:
    """The process group's backend (``"nccl"`` or ``"gloo"``), None where
    no group is up."""
    return dist.get_backend() if world_size() > 1 else None


def rank_device() -> torch.device:
    """This rank's device: the CUDA device of its local rank (``LOCAL_RANK``,
    else the rank) modulo the visible cards, so ranks that outnumber the
    cards share them; the CPU without CUDA."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if world_size() == 1:
        return torch.device("cuda", 0)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_global_row_sharded(mesh, local_rows) -> list:
    """This rank's block of rows as its shards of the global mesh: the
    block (numpy or torch) is cut into one equal row block per shard the
    rank holds, each contiguous on its device; the entries of other ranks'
    shards are None.  Rows never gather on one process.  On a one-process
    mesh, the rows are the whole array (``sharded.shard_rows``)."""
    a = torch.from_numpy(np.ascontiguousarray(local_rows)) \
        if isinstance(local_rows, np.ndarray) else local_rows
    n = len(local_shards(mesh))
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} local rows do not divide evenly over this process's "
                         f"{n} shards")
    return place_local(mesh, a.chunk(n))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, as a view that writes through."""
    return t.reshape(-1).view(torch.uint8)


def through_host(t: torch.Tensor) -> bool:
    """Whether ``t`` crosses ranks through host memory (gloo, CUDA)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` of every rank (equal shapes), in rank order, on ``t``'s
    device."""
    src = t.detach().cpu() if through_host(t) else t.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather([_bytes(o) for o in outs], _bytes(src))
    others = (len(outs) - 1) * src.numel() * src.element_size()
    traffic["all_gather/sent"] += others
    traffic["all_gather/received"] += others
    return [o.to(t.device) for o in outs] if src.device != t.device else outs


def post(sends, recvs) -> list:
    """Post the point-to-point transfers ``sends`` and ``recvs``, each a
    list of ``(tensor, peer, tag)``, together (``batch_isend_irecv``), and
    return their works.  Every rank must post the matching half at the same
    point of its program; a pair of ranks matches its transfers by tag on
    gloo and by order on NCCL, so both sides list them in one order.
    Tensors are contiguous and, on gloo, on the CPU."""
    ops = ([dist.P2POp(dist.isend, _bytes(t), peer, tag=tag) for t, peer, tag in sends]
           + [dist.P2POp(dist.irecv, _bytes(t), peer, tag=tag) for t, peer, tag in recvs])
    traffic["post/sent"] += sum(t.numel() * t.element_size() for t, _, _ in sends)
    traffic["post/received"] += sum(t.numel() * t.element_size() for t, _, _ in recvs)
    return dist.batch_isend_irecv(ops) if ops else []
