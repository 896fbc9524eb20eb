"""Weak scaling of the port's sharded CG: iterations/s over meshes of 1, 2
and 4 shards.

The twin of the JAX repository's ``scripts/scaling_bench.py``, with its
two experiments and its definition of ``weak_efficiency``:

- ``--scaling work`` (default): the rows grow with sqrt(p), keeping each
  shard's work per iteration of the O(D² f) implicit matvec about constant;
  ``weak_efficiency = (rate_p D_p² / p) / (rate_1 D_1² / 1)``, equal to
  ``rate_p / rate_1`` where the rounding of the rows is exact;
- ``--scaling rows``: every shard keeps ``--rows-per-dev`` rows, so the work
  per shard doubles with p; ``weak_efficiency = (rate_p D_p²) / (p rate_1
  D_1²)``, the useful per-shard rate relative to one shard.

``--data sparse`` runs the sparse learns on a ``--density`` matrix: the
sparse linear ring for the linear kernel, else the panel ring or the gather
ring, as the product picks (``ops/sparse.streaming_stream_strategy``).
The mesh (``parallel/mesh.py``) is the process's cards, one shard each,
for the p that there are cards for; ``--logical`` (and ``--cpu``) puts
every shard on the first device, which measures the sharded code's
overhead, not scaling, and the JSON says so.  Rates by the two-point slope
(``utils/timing.slope_rate``) of eps = 0 learns::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.scaling_bench [--cpu | --logical]
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.sparse import HybridSparse, TiledHybrid, stream_panel_rows, streaming_stream_strategy
from ..parallel import sharded
from ..parallel.mesh import make_local_mesh
from ..types import KernelType
from ..utils.timing import slope_rate
from . import _common

#: the panel ring's dense-panel budget, as the JAX script sizes it
PANEL_BUDGET = 8 * 1024**3


def _sparse_learn(mesh, kernel, dev, D: int, dept: int, f: int, density: float, rng):
    """``(learn(b, iters), mode)`` of the sparse learn the product would run."""
    backend = _common.backend_of(dev)
    dtype = np.float32
    csr = sp.random(dept, f, density=density, format="csr", dtype=dtype, random_state=rng)
    x_last = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev)
    mask = np.zeros(D, dtype)
    mask[:dept] = 1.0
    scal = (1.0 / f, 0.0, 1.0)
    L_est = max(1, -(-csr.nnz // max(1, dept)))
    if kernel == KernelType.linear:
        h = HybridSparse.from_csr(csr, dtype=dtype, pad_rows=D, device=dev)
        sys_ = sharded.shard_sparse_system(mesh, h, np.zeros(D, dtype), mask)
        fn = sharded.make_sharded_sparse_linear_learn(mesh)
        return (lambda b, it: fn(*sys_[:5], x_last, b, sys_[6], 1.0, 0.0, it)), "linear"
    if streaming_stream_strategy(L_est, f) == "panel":
        th = TiledHybrid.from_csr(csr, dtype=dtype, pad_rows=D, device=dev)
        rows = stream_panel_rows(D // len(mesh), th.tell.padded_features, 4, PANEL_BUDGET)
        fn = sharded.make_sharded_sparse_panel_learn(mesh, kernel, 3, ntiles=th.tell.ntiles,
                                                     Lt=th.tell.Lt, panel_rows=rows,
                                                     backend=backend)
        tv, tc, hv, hr, _b, m = sharded.shard_sparse_tiled_system(mesh, th, np.zeros(D, dtype),
                                                                  mask)
        return (lambda b, it: fn(tv, tc, hv, hr, x_last, b, m, *scal, 0.0, it)), "panel"
    h = HybridSparse.from_csr(csr, dtype=dtype, pad_rows=D, device=dev)
    sys_ = sharded.shard_sparse_system(mesh, h, np.zeros(D, dtype), mask)
    fn = sharded.make_sharded_sparse_streaming_learn(mesh, kernel, 3)
    return (lambda b, it: fn(*sys_[:5], x_last, b, sys_[6], *scal, 0.0, it)), "gather"


def measure(mesh, rows_per_dev: int, f: int, kernel: KernelType, mode: str, caps, grow: float,
            data: str = "dense", density: float = 0.05):
    """CG iterations/s of the sharded learn on ``mesh`` at ``rows_per_dev``
    rows per shard; returns ``(rate, D, what ran)``."""
    dev = mesh[0]
    p = len(mesh)
    D = rows_per_dev * p
    dept = D - 8
    rng = np.random.default_rng(0)
    if data == "sparse":
        learn, ran = _sparse_learn(mesh, kernel, dev, D, dept, f, density, rng)
    else:
        X_pad = np.zeros((D, f), np.float32)
        X_pad[:dept] = rng.normal(size=(dept, f))
        x_last = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev)
        mask = np.zeros(D, np.float32)
        mask[:dept] = 1.0
        fn = sharded.make_sharded_learn(mesh, kernel, 3, mode, backend=_common.backend_of(dev))
        Xs, _, ms = sharded.shard_system(mesh, X_pad, np.zeros(D, np.float32), mask)

        def learn(b, iters):
            return fn(Xs, x_last, b, ms, 1.0 / f, 0.0, 1.0, 0.0, iters)

        ran = mode

    def run(seed, iters):
        b = np.zeros(D, np.float32)
        # a continuous right-hand side: a +-2 pattern on a low-rank Gram can
        # reach delta == 0 exactly and stop the eps = 0 CG before its cap
        b[:dept] = np.random.default_rng(seed).normal(size=dept)
        bt = torch.from_numpy(b).to(dev)
        _common.sync(dev)
        t0 = time.perf_counter()
        out = learn(bt, iters)
        _common.sync(dev)
        return time.perf_counter() - t0, int(out[4])

    return slope_rate(run, *caps, trials=3, grow_to_seconds=grow), D, ran


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="logical shards of the CPU")
    parser.add_argument("--logical", action="store_true",
                        help="every shard on the first card (no scaling: the overhead)")
    parser.add_argument("--rows-per-dev", type=int, default=1024,
                        help="row block per shard at p = 1 (scaled per --scaling)")
    parser.add_argument("--features", type=int, default=128)
    parser.add_argument("--kernel", default="rbf")
    parser.add_argument("--mode", default="implicit")
    parser.add_argument("--data", choices=("dense", "sparse"), default="dense")
    parser.add_argument("--density", type=float, default=0.05)
    parser.add_argument("--scaling", choices=("work", "rows"), default="work")
    parser.add_argument("--caps", default="4,16", help="the slope's two iteration caps")
    parser.add_argument("--grow-to", type=float, default=0.25,
                        help="widen the caps until their time differs by this many seconds")
    args = parser.parse_args(argv)
    dev = _common.device(args.cpu)
    kernel = KernelType.from_string(args.kernel)
    if args.data == "sparse":
        args.mode = "linear" if kernel == KernelType.linear else "implicit"
    logical = args.cpu or args.logical
    cards = 1 if logical else torch.cuda.device_count()
    sizes = [p for p in (1, 2, 4) if logical or p <= cards]
    caps = tuple(int(c) for c in args.caps.split(","))
    block = 8  # rows per shard stay a multiple of 8
    rates, dims, eff, ran = {}, {}, {}, {}
    for p in sizes:
        if args.scaling == "work":
            rows_local = max(block, int(round(args.rows_per_dev * math.sqrt(p) / p / block))
                             * block)
        else:
            rows_local = args.rows_per_dev
        mesh = make_local_mesh(p, devices=[dev] if logical else None)
        rates[p], dims[p], ran[p] = measure(mesh, rows_local, args.features, kernel, args.mode,
                                            caps, args.grow_to, data=args.data,
                                            density=args.density)
        p0 = sizes[0]
        if args.scaling == "work":
            eff[p] = (rates[p] * dims[p] ** 2 / p) / (rates[p0] * dims[p0] ** 2 / p0)
        else:
            eff[p] = (rates[p] * dims[p] ** 2) / (p * rates[p0] * dims[p0] ** 2)
        print(f"devices={p:3d} rows={dims[p]:7d} iters/s={rates[p]:9.2f} "
              f"weak-eff={eff[p]:7.2%} ({ran[p]})", flush=True)
    data_tag = "" if args.data == "dense" else "_sparse"
    shared = f"this host's {os.cpu_count()} cores" if args.cpu else "the first card"
    return _common.emit({
        "metric": f"weak_scaling_{args.kernel}_{args.mode}{data_tag}_{args.scaling}",
        "platform": dev.type, "card": _common.card(dev),
        "virtual_devices_share_host_cores": bool(args.cpu),
        "logical_shards_share_one_device": bool(logical),
        "host_cores": os.cpu_count(),
        "note": (f"harness check: all {max(sizes)} shards share {shared}, so no efficiency "
                 "above ~1/p is possible; run on a host with a card per shard for weak "
                 "scaling") if logical else "one card per shard",
        "rows": dims, "features": args.features, "iters_per_s": rates,
        "weak_efficiency": eff, "learn": ran})


if __name__ == "__main__":
    main()
