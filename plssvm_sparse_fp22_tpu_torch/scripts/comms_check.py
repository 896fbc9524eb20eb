"""Check ``docs/DESIGN.md``'s communication model against the bytes the
port's multi-process learns move.

The twin of the JAX repository's ``scripts/comms_check.py``, which reads
the collectives' payloads from compiled HLO.  The port has no HLO; instead
every byte that crosses ranks passes through ``parallel/distributed.py``'s
``all_gather`` or ``post``, which count what they send and receive
(``distributed.traffic``).  This tool starts two processes of itself,
each holding two logical shards (a global mesh of 4), runs every learn
that crosses processes on the JAX script's problem (D = 1024 rows, f =
128, 5 % density for the sparse modes, seed 0, float32), and takes the bytes of one CG iteration as the counts of
an eps = 0 learn capped at two iterations less those of one capped at one:
one A·v and whatever else an iteration moves, set-up cancelled.

For each mode it prints the bytes per A·v each rank received, the model's
formula (``DESIGN.md:73-81``) evaluated with p = the ranks (the model's
chips: what crosses between them is what the counters see), their ratio,
and beside it the JAX package's ratio (``COMMS_r05.json``, 8 virtual CPU
devices).  ``agreement_within_2x`` says whether every ratio lies in
[0.5, 2]; a mode outside is a finding about the port or the model, not a
failure of the tool, which exits 0 whenever the ranks ran.  Both ranks
must count the same bytes (every mode is symmetric).

On the CPU (``--cpu``) the ranks talk over gloo; on one card both ranks
share it over gloo (CUDA tensors staged through host memory); where the
host has a card per rank, NCCL::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.comms_check [--cpu] [--rows 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.sparse import HybridSparse, TiledHybrid
from ..parallel import distributed, sharded
from ..parallel.mesh import make_mesh
from ..types import KernelType
from . import _common

#: measured / predicted of the JAX package's check (``COMMS_r05.json``: the
#: compiled HLO of each mode on 8 virtual CPU devices, D 1024, f 128)
JAX_RATIOS = {"sharded_linear": 0.875, "sharded_cached": 0.875,
              "sharded_implicit_ring": 1.084, "sharded_feature_linear": 0.875,
              "sharded_feature_rbf": 0.875, "sharded_sparse_linear": 0.875,
              "sharded_sparse_panel_ring": 1.383, "sharded_sparse_gather_ring": 1.206}
#: seconds the ranks may take, rendezvous included
TIMEOUT = 600
#: the processes, and the logical shards each holds: a global mesh of 4
RANKS, SHARDS = 2, 2


def model(name: str, p: int, D: int, f: int, S: int, L: int) -> tuple[str, float]:
    """``docs/DESIGN.md``'s bytes per CG iteration per chip for mode
    ``name`` on ``p`` chips: its formula and value."""
    ring = (p - 1) / p
    return {
        "sharded_linear": ("8f", 8 * f),
        "sharded_cached": ("4D", 4 * D),
        "sharded_implicit_ring": ("4*(p-1)/p*D*(f+8)", 4 * ring * D * (f + 8)),
        "sharded_feature_linear": ("8D", 8 * D),
        "sharded_feature_rbf": ("8D^2", 8 * D * D),
        "sharded_sparse_linear": ("8f", 8 * f),
        "sharded_sparse_panel_ring": ("8*(p-1)/p*D*(S+1)", 8 * ring * D * (S + 1)),
        "sharded_sparse_gather_ring": ("8*(p-1)/p*D*(L+1)", 8 * ring * D * (L + 1)),
    }[name]


def problem(D: int, f: int, density: float):
    """The JAX script's data: dense X (D, f) and a sparse matrix of D - 8
    rows, float32, seed 0; ``b`` a seeded right-hand side."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(D, f)).astype(np.float32)
    csr = sp.random(D - 8, f, density=density, format="csr", dtype=np.float32,
                    random_state=rng)
    b = rng.normal(size=D).astype(np.float32)
    return X, csr, b


def _learns(mesh, dev, D: int, f: int, density: float):
    """``name -> (run(imax), packing sizes)`` for every mode that crosses
    processes; ``run`` is an eps = 0 learn capped at ``imax``."""
    backend = _common.backend_of(dev)
    X, csr, b = problem(D, f, density)
    x_last = torch.from_numpy(X[-1]).to(dev)
    mask = np.ones(D, np.float32)
    scal = (1.0 / f, 0.0, 1.0)
    learns = {}

    Xs, bs, ms = sharded.shard_system(mesh, X, b, mask)
    for name, kernel, mode in (("sharded_linear", KernelType.linear, "linear"),
                               ("sharded_cached", KernelType.rbf, "cached"),
                               ("sharded_implicit_ring", KernelType.rbf, "implicit")):
        fn = sharded.make_sharded_learn(mesh, kernel, 3, mode, backend=backend)
        learns[name] = lambda imax, fn=fn: fn(Xs, x_last, bs, ms, *scal, 0.0, imax)

    Xf, xlf, bf, mf = sharded.shard_system_feature(mesh, X, X[-1], b, mask)
    for name, kernel in (("sharded_feature_linear", KernelType.linear),
                         ("sharded_feature_rbf", KernelType.rbf)):
        fn = sharded.make_feature_sharded_learn(mesh, kernel, 3)
        learns[name] = lambda imax, fn=fn: fn(Xf, xlf, bf, mf, *scal, 0.0, imax)

    h = HybridSparse.from_csr(csr, dtype=np.float32, pad_rows=D, device=dev)
    vals, cols, tr, tc, tv, bs2, ms2 = sharded.shard_sparse_system(mesh, h, b, mask)
    lin = sharded.make_sharded_sparse_linear_learn(mesh)
    learns["sharded_sparse_linear"] = \
        lambda imax: lin(vals, cols, tr, tc, tv, x_last, bs2, ms2, 1.0, 0.0, imax)

    th = TiledHybrid.from_csr(csr, dtype=np.float32, pad_rows=D, device=dev)
    tvals, tlcols, heavy, hrow, bs3, ms3 = sharded.shard_sparse_tiled_system(mesh, th, b, mask)
    panel = sharded.make_sharded_sparse_panel_learn(
        mesh, KernelType.rbf, 3, ntiles=th.tell.ntiles, Lt=th.tell.Lt,
        panel_rows=D // len(mesh), backend=backend)
    learns["sharded_sparse_panel_ring"] = \
        lambda imax: panel(tvals, tlcols, heavy, hrow, x_last, bs3, ms3, *scal, 0.0, imax)

    gather = sharded.make_sharded_sparse_streaming_learn(mesh, KernelType.rbf, 3)
    learns["sharded_sparse_gather_ring"] = \
        lambda imax: gather(vals, cols, tr, tc, tv, x_last, bs2, ms2, *scal, 0.0, imax)
    sizes = {"S": th.tell.ntiles * th.tell.Lt, "L": h.ell.row_capacity,
             "heavy_rows": int(len(th.heavy_idx)), "coo_tail": int(h.coo_vals.shape[0])}
    return learns, sizes


def per_iteration(run) -> dict:
    """The transport counters of one CG iteration: a learn capped at two
    iterations less one capped at one (each checked to run its cap)."""
    counts = []
    for imax in (1, 2):
        distributed.reset_traffic()
        out = run(imax)
        if int(out[4]) != imax:
            raise RuntimeError(f"the eps = 0 learn ran {int(out[4])} iterations, not {imax}")
        counts.append(dict(distributed.traffic))
    return {k: counts[1][k] - counts[0][k] for k in counts[0]}


def worker(spec: dict) -> int:
    """One rank: join the group, run every mode, write its counts."""
    distributed.initialize_distributed(spec["address"], spec["ranks"], spec["rank"],
                                       timeout=spec["timeout"])
    dev = torch.device("cpu") if spec["cpu"] else distributed.rank_device()
    mesh = make_mesh(spec["ranks"] * spec["shards"], devices=[dev])
    learns, sizes = _learns(mesh, dev, spec["rows"], spec["features"], spec["density"])
    out = {"transport": distributed.transport(), "device": str(dev), "sizes": sizes,
           "modes": {name: per_iteration(run) for name, run in learns.items()}}
    with open(os.path.join(spec["outdir"], f"rank_{spec['rank']}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args) -> list[dict]:
    """Run the ranks, each a process of this module, and return their
    counts in rank order; a rank that fails or outlives ``TIMEOUT`` raises
    (and every rank is stopped)."""
    with tempfile.TemporaryDirectory() as outdir:
        spec = {"address": f"127.0.0.1:{_free_port()}", "ranks": RANKS,
                "shards": SHARDS, "rows": args.rows, "features": args.features,
                "density": args.density, "cpu": args.cpu, "outdir": outdir,
                "timeout": TIMEOUT}
        env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE")}
        env["LOCAL_WORLD_SIZE"] = str(RANKS)
        # the ranks import this package from where this process found it
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--worker", json.dumps({**spec, "rank": r})],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env={**env, "LOCAL_RANK": str(r)})
            for r in range(RANKS)]
        deadline = time.monotonic() + TIMEOUT
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                            .decode(errors="replace"))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, proc in enumerate(procs):
            if proc.returncode != 0:
                raise RuntimeError(f"rank {r} exited {proc.returncode}:\n{logs[r][-4000:]}")
        outs = []
        for r in range(RANKS):
            with open(os.path.join(outdir, f"rank_{r}.json")) as fh:
                outs.append(json.load(fh))
        return outs


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="ranks on the CPU over gloo")
    parser.add_argument("--rows", type=int, default=1024)
    parser.add_argument("--features", type=int, default=128)
    parser.add_argument("--density", type=float, default=0.05)
    parser.add_argument("--worker", metavar="SPEC", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return {"rc": worker(json.loads(args.worker))}
    dev = _common.device(args.cpu)
    outs = spawn(args)
    for r, o in enumerate(outs[1:], 1):
        if o["modes"] != outs[0]["modes"]:
            raise RuntimeError(f"rank {r} counted other bytes than rank 0: {o['modes']} "
                               f"against {outs[0]['modes']}")
    p, D, f = RANKS, args.rows, args.features
    sizes = outs[0]["sizes"]
    cases = {}
    for name, counts in outs[0]["modes"].items():
        formula, predicted = model(name, p, D, f, sizes["S"], sizes["L"])
        received = counts["all_gather/received"] + counts["post/received"]
        ratio = received / predicted
        cases[name] = {"counted_per_iter": counts, "measured_per_iter": received,
                       "predicted": {"per_iter_bytes_formula": formula, "value": predicted},
                       "ratio_measured_over_predicted": ratio, "jax_ratio": JAX_RATIOS[name]}
        print(f"{name:28s} received {received:12d} B per A·v per rank, model {formula} = "
              f"{predicted:12.0f}, ratio {ratio:6.3f} (JAX {JAX_RATIOS[name]:.3f})", flush=True)
    return _common.emit({
        "metric": "comms_model_validation", "platform": dev.type, "card": _common.card(dev),
        "transport": outs[0]["transport"], "ranks": p, "shards_per_rank": SHARDS,
        "D": D, "f": f, "density": args.density, **sizes,
        "agreement_within_2x": all(0.5 <= c["ratio_measured_over_predicted"] <= 2.0
                                   for c in cases.values()),
        "cases": cases})


if __name__ == "__main__":
    main()
