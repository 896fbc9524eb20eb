"""The port's learns and predict across processes: the CPU twin of
``tests/test_distributed.py``.

Two gloo processes, each holding 4 logical CPU shards, run one global
8-shard problem through ``parallel/distributed.py`` and the same
``parallel/sharded.py`` functions a one-process mesh runs.  This file is its
own worker: run as a script it takes ``<coordinator> <nprocs> <rank>
<outdir> <scenario>``, joins the process group, feeds its own rows and
writes what it computed to ``<outdir>/out_<rank>.npz``.

The problems are ``tests/_multihost_worker.py``'s: dense n = 257, f = 12,
D = 320, seed 7; sparse density 0.25, seed 13; predict against Np = 264
support vectors; and two of this file's own: a wide one for the
feature-sharded learns (n = 57, f = 1024, D = 64, so f / 8 > D; seed 11) and
the sparse one with two rows made dense, so that the panel ring's packing
holds heavy rows on shards of both ranks (the dense rows on shard 1, rank
0, and shard 5, rank 1) and none on some shards; all float64.  Each scenario is held to

1. the port's one-process run over the same 8 shards, computed here: the
   same bits, and the same bits on both ranks (every partial is added in
   global shard order, and every rank runs the same CG on the same bits);
2. the JAX package's one-process sharded functions on its 8 virtual
   devices: an early stop (eps 1e-2) with iterations equal and x within
   1e-9 of its scale, as ``tests/test_torch_parallel.py`` holds them
   (sharding changes the order of the sums, CG from x0 = 1 amplifies it);
   the predict within 1e-10;
3. the oracle, as the JAX worker holds its runs: x to 1e-4, bias to 5e-3,
   the predict to 1e-8.

Every spawned run has a time limit of its own (``WORKER_TIMEOUT``), and so
has its rendezvous.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.ops.sparse import HybridSparse, TiledHybrid  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.parallel import distributed, sharded  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.parallel.mesh import (GlobalMesh, make_local_mesh,  # noqa: E402
                                                        make_mesh)
from plssvm_sparse_fp22_tpu_torch.solver.cg import CGState  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.solver.checkpoint import (load_cg_checkpoint,  # noqa: E402
                                                            save_cg_checkpoint)
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils import oracle  # noqa: E402

EPS, EARLY, IMAX, COST = 1e-10, 1e-2, 200, 2.0
GAMMA, COEF0, DEGREE = 0.1, 1.0, 3
HYPER = {"degree": DEGREE, "gamma": GAMMA, "coef0": COEF0}
RANKS, SHARDS = 2, 8
#: seconds a spawned pair of workers may take, rendezvous included
WORKER_TIMEOUT = 120
#: the dense scenario's learns: the ring and the two other modes
DENSE = [(KernelType.rbf, "implicit"), (KernelType.linear, "linear"),
         (KernelType.rbf, "cached")]
CKPT_AT = 6
#: the feature scenario's learns, and the rows the sparse rings' problem makes
#: dense: shard 1 (rank 0) and shard 5 (rank 1) of 40 rows each
FEATURE = [KernelType.rbf, KernelType.polynomial, KernelType.linear]
HEAVY = (45, 210)
#: three panels (16, 16, 8 rows) per 40-row shard of the panel ring
PANEL_ROWS = 16


def _blobs(seed: int, n: int, f: int, scale: float = 1.0):
    """Two gaussian blobs at +-1 per feature, times ``scale``, shuffled."""
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.concatenate([rng.normal(loc=+1.0, size=(half, f)),
                        rng.normal(loc=-1.0, size=(n - half, f))]) * scale
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _dense_problem():
    """``_multihost_worker._dense_problem``."""
    X, y = _blobs(7, 257, 12)
    return (X, y, *_padded(X, y, 320))  # 8 shards x 40 rows


def _feature_problem():
    """Wide blobs for the feature-sharded learns, f / 8 > D; scaled so that
    squared distances are the dense problem's (gamma 0.1 stays apt)."""
    f = 1024
    X, y = _blobs(11, 57, f, np.sqrt(12 / f))
    return (X, y, *_padded(X, y, 64))


def _padded(X, y, D):
    """``(X_pad, b_pad, mask, dept, D)``: the system of ``n - 1`` rows padded
    to ``D``."""
    dept = len(y) - 1
    X_pad = np.zeros((D, X.shape[1]))
    X_pad[:dept] = X[:dept]
    return (X_pad, *_targets(y, dept, D), dept, D)


def _sparse_problem():
    """``_multihost_worker._sparse_problem``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(13)
    n, f = 257, 24
    dept = n - 1
    D = 320
    csr = sp.random(n, f, density=0.25, format="csr", dtype=np.float64,
                    random_state=np.random.RandomState(13))
    csr = (csr + sp.eye(n, f, format="csr")).tocsr()  # no empty rows
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y, dept, D


def _heavy_sparse_problem():
    """``_sparse_problem`` with the rows ``HEAVY`` made dense (values below
    the light rows' scale, as the panel packing's heavy rows)."""
    csr, y, dept, D = _sparse_problem()
    csr = csr.tolil()
    rng = np.random.default_rng(17)
    for r in HEAVY:
        csr[r, :] = 0.35 * rng.uniform(size=csr.shape[1])
    return csr.tocsr(), y, dept, D


def _targets(y, dept, D):
    b_pad = np.zeros(D)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return b_pad, mask


def _predict_problem():
    """The support vectors (Np = 264, zero-padded), their alphas from the
    oracle, and 16 points."""
    X, y, *_ = _dense_problem()
    alpha, bias, _ = oracle.solve_lssvm(X, y, kernel=KernelType.rbf, cost=COST, epsilon=EPS,
                                        max_iter=IMAX, **HYPER)
    Np = 264  # 8 shards x 33 rows
    X_sv = np.zeros((Np, X.shape[1]))
    X_sv[:len(y)] = X
    a_sv = np.zeros(Np)
    a_sv[:len(y)] = alpha
    return X, X_sv, a_sv, bias, X[:16]


# ---------------------------------------------------------------------------
# the scenarios: one function each, run on the global mesh by every rank and
# on a one-process mesh of the same 8 shards; each returns numpy arrays
# ---------------------------------------------------------------------------

def _feed(mesh, a):
    """This process's rows of ``a`` as its shards (``make_global_row_sharded``):
    an equal share of the rows per rank."""
    world, rank = RANKS if isinstance(mesh, GlobalMesh) else 1, getattr(mesh, "rank", 0)
    rows = a.shape[0] // world
    return distributed.make_global_row_sharded(mesh, a[rank * rows:(rank + 1) * rows])


def _learn_out(tag, out) -> dict:
    x, s, t, QA, iters, delta, delta0 = out[:7]
    return {f"{tag}/x": x.numpy(), f"{tag}/s": s.numpy(), f"{tag}/t": t.numpy(),
            f"{tag}/QA": QA.numpy(), f"{tag}/iters": np.asarray(iters),
            f"{tag}/delta": delta.numpy(), f"{tag}/delta0": delta0.numpy()}


def scenario_dense(mesh, outdir):
    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    Xs = _feed(mesh, X_pad)
    b, m = torch.from_numpy(b_pad), torch.from_numpy(mask)
    x_last = torch.from_numpy(X[-1])
    v = torch.from_numpy(np.random.default_rng(8).normal(size=D)) * m
    res = {}
    for kernel, mode in DENSE:
        tag = f"{kernel.name}-{mode}"
        mv = sharded._prepare_local(kernel, mesh, Xs, x_last, m, GAMMA, COEF0, COST, DEGREE,
                                    mode, BackendType.torch, "none")[3]
        res[f"{tag}/Av"] = mv(v).numpy()
        learn = sharded.make_sharded_learn(mesh, kernel, DEGREE, mode)
        for name, eps in (("early", EARLY), ("full", EPS)):
            res.update(_learn_out(f"{tag}/{name}",
                                  learn(Xs, x_last, b, m, GAMMA, COEF0, COST, eps, IMAX)))
    # the ring with the Jacobi preconditioner and under the two-tier plan
    for name, kw in (("jacobi", {"precond": "jacobi"}), ("plan", {"mxu_plan": ("default",
                                                                              "high")})):
        learn = sharded.make_sharded_learn(mesh, KernelType.rbf, DEGREE, "implicit", **kw)
        res.update(_learn_out(f"rbf-implicit/{name}",
                              learn(Xs, x_last, b, m, GAMMA, COEF0, COST, EPS, IMAX)))
    return res


def scenario_sparse(mesh, outdir):
    csr, y, dept, D = _sparse_problem()
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    system = sharded.shard_sparse_system(mesh, h, *_targets(y, dept, D))
    x_last = torch.from_numpy(csr[-1].toarray().ravel())
    v = torch.from_numpy(np.random.default_rng(14).normal(size=D)) * system[6]
    mv = sharded._prepare_sparse_gather_local(KernelType.rbf, mesh, *system[:5], x_last,
                                              system[6], GAMMA, COEF0, COST, DEGREE, "none")[3]
    res = {"Av": mv(v).numpy()}
    learn = sharded.make_sharded_sparse_streaming_learn(mesh, KernelType.rbf, DEGREE)
    for name, eps in (("early", EARLY), ("full", EPS)):
        res.update(_learn_out(name, learn(*system[:5], x_last, *system[5:], GAMMA, COEF0, COST,
                                          eps, IMAX)))
    return res


def scenario_predict(mesh, outdir):
    X, X_sv, a_sv, bias, points = _predict_problem()
    Xs, As = _feed(mesh, X_sv), _feed(mesh, a_sv)
    out = sharded.make_sharded_predict(mesh, KernelType.rbf, DEGREE)(
        torch.from_numpy(points), Xs, As, torch.tensor(bias, dtype=torch.float64), GAMMA,
        COEF0)
    return {"decision": out.numpy(), "w": sharded.make_sharded_w(mesh)(Xs, As).numpy()}


def _chunked(mesh):
    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    Xs = _feed(mesh, X_pad)
    b, m, x_last = torch.from_numpy(b_pad), torch.from_numpy(mask), torch.from_numpy(X[-1])
    setup, chunk = sharded.make_sharded_learn_fns(mesh, KernelType.rbf, DEGREE, "implicit")
    return (lambda: setup(Xs, x_last, b, m, GAMMA, COEF0, COST),
            lambda end, state: chunk(Xs, b, m, x_last, GAMMA, COEF0, COST, EPS, end, state),
            dept)


def _state_out(state) -> dict:
    return {"k": np.asarray(state.k), "x": state.x.numpy(), "r": state.r.numpy(),
            "d": state.d.numpy(), "delta": state.delta.numpy(), "delta0": state.delta0.numpy()}


def scenario_ckpt_a(mesh, outdir):
    """A chunked learn stopped at ``CKPT_AT``; rank 0 writes the checkpoint
    (the state is whole on every rank) and the ranks meet before exiting."""
    setup, chunk, dept = _chunked(mesh)
    q, QA, state = setup()
    state = chunk(CKPT_AT, state)
    if getattr(mesh, "rank", 0) == 0:
        save_cg_checkpoint(os.path.join(outdir, "cg.npz"), state, q, QA,
                           {"dept": dept, "kernel": int(KernelType.rbf)})
    if isinstance(mesh, GlobalMesh):
        torch.distributed.barrier()
    return _state_out(state)


def scenario_ckpt_b(mesh, outdir):
    """A fresh launch resumes from the checkpoint to convergence."""
    setup, chunk, dept = _chunked(mesh)
    state, q, QA, meta = load_cg_checkpoint(os.path.join(outdir, "cg.npz"))
    assert int(meta["dept"]) == dept and state.k == CKPT_AT
    return _state_out(chunk(IMAX, state))


def _feature_system(mesh):
    X, y, X_pad, b_pad, mask, dept, D = _feature_problem()
    return sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)


def scenario_feature(mesh, outdir):
    """The feature-sharded learns: one A·v and the learns of each kernel,
    and a chunked rbf learn stopped at ``CKPT_AT`` whose checkpoint rank 0
    writes (``scenario_feature_resume`` resumes it in a fresh launch)."""
    Xs, xls, b, m = _feature_system(mesh)
    v = torch.from_numpy(np.random.default_rng(12).normal(size=len(m))) * m
    scalars = (GAMMA, COEF0, COST)
    res = {}
    for kernel in FEATURE:
        tag = kernel.name
        mv = sharded._prepare_feature_local(kernel, mesh, Xs, xls, m, *scalars, DEGREE, "none")[3]
        res[f"{tag}/Av"] = mv(v).numpy()
        learn = sharded.make_feature_sharded_learn(mesh, kernel, DEGREE)
        for name, eps in (("early", EARLY), ("full", EPS)):
            res.update(_learn_out(f"{tag}/{name}", learn(Xs, xls, b, m, *scalars, eps, IMAX)))
    setup, chunk = sharded.make_feature_sharded_learn_fns(mesh, KernelType.rbf, DEGREE)
    q, QA, state = setup(Xs, xls, b, m, *scalars)
    state = chunk(Xs, b, m, xls, *scalars, EPS, CKPT_AT, state)
    if getattr(mesh, "rank", 0) == 0:
        save_cg_checkpoint(os.path.join(outdir, "feature_cg.npz"), state, q, QA,
                           {"dept": int(m.sum()), "kernel": int(KernelType.rbf)})
    if isinstance(mesh, GlobalMesh):
        torch.distributed.barrier()
    res.update({f"ckpt/{k}": a for k, a in _state_out(state).items()})
    return res


def scenario_feature_resume(mesh, outdir):
    """A fresh launch resumes the feature-sharded chunked learn from the
    checkpoint to convergence."""
    Xs, xls, b, m = _feature_system(mesh)
    state = load_cg_checkpoint(os.path.join(outdir, "feature_cg.npz"))[0]
    assert state.k == CKPT_AT
    _, chunk = sharded.make_feature_sharded_learn_fns(mesh, KernelType.rbf, DEGREE)
    return _state_out(chunk(Xs, b, m, xls, GAMMA, COEF0, COST, EPS, IMAX, state))


def scenario_sparse_rings(mesh, outdir):
    """The sparse linear ring and the panel ring (rbf, three panels per
    shard): one A·v and the learns of each."""
    csr, y, dept, D = _heavy_sparse_problem()
    b_pad, mask = _targets(y, dept, D)
    x_last = torch.from_numpy(csr[-1].toarray().ravel())
    v = torch.from_numpy(np.random.default_rng(18).normal(size=D) * mask)
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    vals, cols, tr, tc, tv, b, m = sharded.shard_sparse_system(mesh, h, b_pad, mask)
    res = {"linear/Av": sharded._prepare_sparse_linear(mesh, vals, cols, tr, tc, tv, x_last, m,
                                                       COST, "none")[3](v).numpy()}
    learn = sharded.make_sharded_sparse_linear_learn(mesh)
    for name, eps in (("early", EARLY), ("full", EPS)):
        res.update(_learn_out(f"linear/{name}", learn(vals, cols, tr, tc, tv, x_last, b, m, COST,
                                                      eps, IMAX)))
    th = TiledHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    system = sharded.shard_sparse_tiled_system(mesh, th, b_pad, mask)
    kw = {"ntiles": th.tell.ntiles, "Lt": th.tell.Lt, "panel_rows": PANEL_ROWS}
    scalars = (GAMMA, COEF0, COST)
    res["panel/Av"] = sharded._prepare_sparse_panel_local(
        KernelType.rbf, mesh, *system[:4], x_last, system[5], *scalars, DEGREE,
        backend=BackendType.torch, precond="none", **kw)[3](v).numpy()
    learn = sharded.make_sharded_sparse_panel_learn(mesh, KernelType.rbf, DEGREE, **kw)
    for name, eps in (("early", EARLY), ("full", EPS)):
        res.update(_learn_out(f"panel/{name}", learn(*system[:4], x_last, *system[4:], *scalars,
                                                     eps, IMAX)))
    res["panel/heavy_idx"] = np.asarray(th.heavy_idx)
    return res


SCENARIOS = {"dense": scenario_dense, "sparse": scenario_sparse, "predict": scenario_predict,
             "ckpt_a": scenario_ckpt_a, "ckpt_b": scenario_ckpt_b, "feature": scenario_feature,
             "feature_resume": scenario_feature_resume, "sparse_rings": scenario_sparse_rings}


def worker(coordinator, nprocs, rank, outdir, scenario) -> None:
    assert distributed.initialize_distributed(coordinator, nprocs, rank, timeout=60)
    assert distributed.initialize_distributed(coordinator, nprocs, rank)  # idempotent
    mesh = make_mesh(SHARDS, devices=["cpu"])
    res = SCENARIOS[scenario](mesh, outdir)
    res["meta/ranks"] = np.asarray(mesh.ranks)
    res["meta/transport"] = np.asarray(distributed.transport())
    res["meta/threads"] = np.asarray(torch.get_num_threads())
    np.savez(os.path.join(outdir, f"out_{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, scenario) -> dict:
    """Both ranks' results of ``scenario``, checked to be the same bits."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "WORLD_SIZE")}
    # both ranks on this host, as torchrun announces them
    env["LOCAL_WORLD_SIZE"] = str(RANKS)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), coordinator,
                               str(RANKS), str(rank), str(tmp_path), scenario],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env={**env, "LOCAL_RANK": str(rank)})
             for rank in range(RANKS)]
    deadline = time.monotonic() + WORKER_TIMEOUT
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
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {rank} of {scenario} failed:\n{logs[rank]}"
    outs = []
    for rank in range(RANKS):
        with np.load(tmp_path / f"out_{rank}.npz") as z:
            outs.append({k: z[k] for k in z.files})
        os.remove(tmp_path / f"out_{rank}.npz")
    assert outs[0].keys() == outs[1].keys()
    for key in outs[0]:
        assert np.array_equal(outs[0][key], outs[1][key]), f"{scenario}: {key} differs by rank"
    assert outs[0]["meta/ranks"].tolist() == [0] * 4 + [1] * 4
    assert str(outs[0]["meta/transport"]) == "gloo"
    if "OMP_NUM_THREADS" not in env:  # two ranks on one host: one thread each
        assert int(outs[0]["meta/threads"]) == 1
    return outs[0]


def _one_process(scenario, outdir) -> dict:
    return SCENARIOS[scenario](make_local_mesh(SHARDS, devices=["cpu"]), outdir)


def _same_bits(got: dict, want: dict) -> None:
    for key, value in want.items():
        assert np.array_equal(got[key], np.asarray(value)), f"{key} differs from one process"


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _held_to_oracle(res, tag, X, y, dept, kernel=KernelType.rbf):
    alpha, bias, _ = oracle.solve_lssvm(X, y, kernel=kernel, cost=COST, epsilon=EPS,
                                        max_iter=IMAX, **HYPER)
    np.testing.assert_allclose(res[f"{tag}/x"][:dept], alpha[:dept], rtol=1e-4, atol=1e-4)
    got_bias = float(y[-1]) + float(res[f"{tag}/QA"]) * float(res[f"{tag}/s"]) \
        - float(res[f"{tag}/t"])
    assert abs(got_bias - bias) < 5e-3, (got_bias, bias)


def test_dense_learns_across_two_processes(tmp_path):
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plssvm_sparse_fp22_tpu.parallel.sharded import (make_sharded_learn as jax_learn,
                                                         shard_system as jax_shard_system)
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel

    res = _spawn(tmp_path, "dense")
    _same_bits(res, _one_process("dense", tmp_path))
    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    jmesh = jax_make_mesh(SHARDS)
    jXs, jb, jm = jax_shard_system(jmesh, X_pad, b_pad, mask)
    f64 = jnp.float64
    for kernel, mode in DENSE:
        tag = f"{kernel.name}-{mode}"
        jx, *_, jiters, _, _ = jax_learn(jmesh, JKernel(int(kernel)), DEGREE, mode)(
            jXs, jnp.asarray(X[-1]), jb, jm, f64(GAMMA), f64(COEF0), f64(COST), f64(EARLY),
            jnp.int32(IMAX))
        assert int(res[f"{tag}/early/iters"]) == int(jiters) >= 1
        _close(res[f"{tag}/early/x"], jx, 1e-9)
        _held_to_oracle(res, f"{tag}/full", X, y, dept, kernel)
    for name in ("jacobi", "plan"):
        _held_to_oracle(res, f"rbf-implicit/{name}", X, y, dept)


def test_sparse_gather_ring_across_two_processes(tmp_path):
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.ops.sparse import HybridSparse as JHybrid
    from plssvm_sparse_fp22_tpu.parallel import sharded as jsharded
    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel

    res = _spawn(tmp_path, "sparse")
    _same_bits(res, _one_process("sparse", tmp_path))
    csr, y, dept, D = _sparse_problem()
    b_pad, mask = _targets(y, dept, D)
    jmesh = jax_make_mesh(SHARDS)
    args = jsharded.shard_sparse_system(jmesh, JHybrid.from_csr(csr[:dept], dtype=np.float64,
                                                                pad_rows=D), b_pad, mask)
    f64 = jnp.float64
    jx, *_, jiters, _, _ = jsharded.make_sharded_sparse_streaming_learn(
        jmesh, JKernel.rbf, DEGREE)(*args[:5], jnp.asarray(csr[-1].toarray().ravel()),
                                    *args[5:], f64(GAMMA), f64(COEF0), f64(COST), f64(EARLY),
                                    jnp.int32(IMAX))
    assert int(res["early/iters"]) == int(jiters) >= 1
    _close(res["early/x"], jx, 1e-9)
    _held_to_oracle(res, "full", csr.toarray(), y, dept)


def test_predict_across_two_processes(tmp_path):
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plssvm_sparse_fp22_tpu.parallel.sharded import (make_sharded_predict as jax_predict,
                                                         make_sharded_w as jax_w,
                                                         shard_system as jax_shard_system)
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel

    res = _spawn(tmp_path, "predict")
    _same_bits(res, _one_process("predict", tmp_path))
    X, X_sv, a_sv, bias, points = _predict_problem()
    jmesh = jax_make_mesh(SHARDS)
    jXs, jAs, _ = jax_shard_system(jmesh, X_sv, a_sv, a_sv)
    want = jax_predict(jmesh, JKernel.rbf, DEGREE)(jnp.asarray(points), jXs, jAs,
                                                   jnp.float64(bias), jnp.float64(GAMMA),
                                                   jnp.float64(COEF0))
    _close(res["decision"], want, 1e-10)
    _close(res["w"], jax_w(jmesh)(jXs, jAs), 1e-10)
    decision = oracle.kernel_matrix(KernelType.rbf, points, X, **HYPER) @ a_sv[:len(X)] + bias
    np.testing.assert_allclose(res["decision"], decision, rtol=1e-8, atol=1e-8)


def test_checkpoint_resume_across_two_process_launches(tmp_path):
    """Stopped at k = 6 by one pair of processes, resumed to convergence by
    a fresh pair: the one-shot learn's bits."""
    from plssvm_sparse_fp22_tpu.solver.checkpoint import load_cg_checkpoint as jax_load

    saved = _spawn(tmp_path, "ckpt_a")
    assert int(saved["k"]) == CKPT_AT
    path = str(tmp_path / "cg.npz")
    state, q, QA, meta = load_cg_checkpoint(path)
    jstate, jq, jQA, jmeta = jax_load(path)
    for name in CGState._fields:
        assert np.array_equal(np.asarray(getattr(jstate, name)),
                              np.asarray(getattr(state, name))), name
        assert np.array_equal(saved[name], np.asarray(getattr(state, name))), name
    assert np.array_equal(np.asarray(jq), q.numpy()) and float(jQA) == float(QA)
    assert int(jmeta["dept"]) == int(meta["dept"])

    resumed = _spawn(tmp_path, "ckpt_b")
    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    mesh = make_local_mesh(SHARDS, devices=["cpu"])
    Xs, b, m = sharded.shard_system(mesh, X_pad, b_pad, mask)
    one_shot = sharded.make_sharded_learn(mesh, KernelType.rbf, DEGREE, "implicit")(
        Xs, torch.from_numpy(X[-1]), b, m, GAMMA, COEF0, COST, EPS, IMAX)
    assert int(resumed["k"]) == one_shot[4] > CKPT_AT
    assert np.array_equal(resumed["x"], one_shot[0].numpy())
    assert float(resumed["delta"]) <= EPS * EPS * float(resumed["delta0"])
    _held_to_oracle({"r/x": resumed["x"], "r/QA": one_shot[3].numpy(),
                     "r/s": one_shot[1].numpy(), "r/t": one_shot[2].numpy()}, "r", X, y, dept)


@pytest.fixture(scope="module")
def feature_runs(tmp_path_factory):
    """The feature scenario on two ranks and in one process (a directory of
    its own, so that its checkpoint does not replace the pair's)."""
    outdir = tmp_path_factory.mktemp("feature")
    return (outdir, _spawn(outdir, "feature"),
            _one_process("feature", tmp_path_factory.mktemp("feature_one")))


def test_feature_learns_across_two_processes(feature_runs):
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plssvm_sparse_fp22_tpu.parallel.sharded import (
        make_feature_sharded_learn as jax_learn, shard_system_feature as jax_shard)
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel

    outdir, res, one = feature_runs
    _same_bits(res, one)
    X, y, X_pad, b_pad, mask, dept, D = _feature_problem()
    assert X.shape[1] // SHARDS > D
    jmesh = jax_make_mesh(SHARDS)
    jargs = jax_shard(jmesh, X_pad, X[-1], b_pad, mask)
    f64 = jnp.float64
    for kernel in FEATURE:
        tag = kernel.name
        jx, *_, jiters, _, _ = jax_learn(jmesh, JKernel(int(kernel)), DEGREE)(
            *jargs, f64(GAMMA), f64(COEF0), f64(COST), f64(EARLY), jnp.int32(IMAX))
        assert int(res[f"{tag}/early/iters"]) == int(jiters) >= 1
        _close(res[f"{tag}/early/x"], jx, 1e-9)
        _held_to_oracle(res, f"{tag}/full", X, y, dept, kernel)


def test_feature_checkpoint_resume_across_two_process_launches(feature_runs):
    """The chunked feature-sharded learn stopped at k = 6 by one pair of
    processes, resumed to convergence by a fresh pair: the one-shot learn's
    bits; the checkpoint is the JAX package's format."""
    from plssvm_sparse_fp22_tpu.solver.checkpoint import load_cg_checkpoint as jax_load

    outdir, res, one = feature_runs
    assert int(res["ckpt/k"]) == CKPT_AT
    path = str(outdir / "feature_cg.npz")
    state = load_cg_checkpoint(path)[0]
    jstate = jax_load(path)[0]
    for name in CGState._fields:
        assert np.array_equal(res[f"ckpt/{name}"], np.asarray(getattr(state, name))), name
        assert np.array_equal(np.asarray(getattr(jstate, name)),
                              np.asarray(getattr(state, name))), name
    resumed = _spawn(outdir, "feature_resume")
    assert int(resumed["k"]) == int(one["rbf/full/iters"]) > CKPT_AT
    assert np.array_equal(resumed["x"], one["rbf/full/x"])


@pytest.fixture(scope="module")
def sparse_ring_runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("sparse_rings")
    return _spawn(outdir, "sparse_rings"), _one_process("sparse_rings", outdir)


def test_sparse_linear_ring_across_two_processes(sparse_ring_runs):
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.ops.sparse import HybridSparse as JHybrid
    from plssvm_sparse_fp22_tpu.parallel import sharded as jsharded
    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh

    res, one = sparse_ring_runs
    _same_bits(res, one)
    csr, y, dept, D = _heavy_sparse_problem()
    jmesh = jax_make_mesh(SHARDS)
    args = jsharded.shard_sparse_system(jmesh, JHybrid.from_csr(csr[:dept], dtype=np.float64,
                                                                pad_rows=D),
                                        *_targets(y, dept, D))
    f64 = jnp.float64
    jx, *_, jiters, _, _ = jsharded.make_sharded_sparse_linear_learn(jmesh)(
        *args[:5], jnp.asarray(csr[-1].toarray().ravel()), *args[5:], f64(COST), f64(EARLY),
        jnp.int32(IMAX))
    assert int(res["linear/early/iters"]) == int(jiters) >= 1
    _close(res["linear/early/x"], jx, 1e-9)
    _held_to_oracle(res, "linear/full", csr.toarray(), y, dept, KernelType.linear)


def test_panel_ring_across_two_processes(sparse_ring_runs):
    """The panel ring, with heavy rows on shards of both ranks (each read
    by the other rank's shards) and shards without any."""
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.ops.sparse import TiledHybrid as JTiled
    from plssvm_sparse_fp22_tpu.parallel import sharded as jsharded
    from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel

    res, one = sparse_ring_runs
    _same_bits(res, one)
    csr, y, dept, D = _heavy_sparse_problem()
    m_loc = D // SHARDS
    assert m_loc // PANEL_ROWS >= 2
    heavy_shards = {int(r) // m_loc for r in res["panel/heavy_idx"]}
    assert set(HEAVY) <= set(res["panel/heavy_idx"].tolist())
    assert {1, 5} <= heavy_shards and len(heavy_shards) < SHARDS
    jmesh = jax_make_mesh(SHARDS)
    jth = JTiled.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    args = jsharded.shard_sparse_tiled_system(jmesh, jth, *_targets(y, dept, D))
    learn = jsharded.make_sharded_sparse_panel_learn(
        jmesh, JKernel.rbf, DEGREE, ntiles=jth.tell.ntiles, Lt=jth.tell.Lt,
        panel_rows=PANEL_ROWS, use_pallas=False)
    f64 = jnp.float64
    jx, *_, jiters, _, _ = learn(*args[:4], jnp.asarray(csr[-1].toarray().ravel()), *args[4:],
                                 f64(GAMMA), f64(COEF0), f64(COST), f64(EARLY), jnp.int32(IMAX))
    assert int(res["panel/early/iters"]) == int(jiters) >= 1
    _close(res["panel/early/x"], jx, 1e-9)
    _held_to_oracle(res, "panel/full", csr.toarray(), y, dept)


# ---------------------------------------------------------------------------
# unit tests of the set-up, in this process
# ---------------------------------------------------------------------------

def test_initialize_distributed_alone_stays_one_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.transport() is None
    assert make_mesh(2, devices=["cpu"]) == [torch.device("cpu")] * 2
    assert not isinstance(make_mesh(2, devices=["cpu"]), GlobalMesh)


def test_an_unreachable_coordinator_raises_within_its_timeout():
    start = time.monotonic()
    with pytest.raises(PLSSVMError, match="cannot join the process group"):
        distributed.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 1, timeout=2)
    assert time.monotonic() - start < 30
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("local_world, cards, backend, threads_capped", [
    (None, 1, "nccl", False),   # one rank per host, a card each: no host-local count
    ("2", 2, "nccl", True),     # two ranks on a host of two cards
    ("2", 1, "gloo", True),     # two ranks sharing one card
    (None, 0, "gloo", False),   # no card
])
def test_default_backend_follows_the_host_local_rank_count(monkeypatch, local_world, cards,
                                                          backend, threads_capped):
    for name in ("LOCAL_WORLD_SIZE", "LOCAL_RANK", "OMP_NUM_THREADS"):
        monkeypatch.delenv(name, raising=False)
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    joined, capped = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    monkeypatch.setattr(torch, "set_num_threads", capped.append)
    assert distributed.initialize_distributed("10.0.0.1:29500", 2, 1) is True
    assert joined == [backend]
    assert capped == ([1] if threads_capped else [])


def test_global_mesh_orders_shards_by_rank():
    mesh = GlobalMesh(["cpu"] * 4, [0, 0, 1, 1], rank=1)
    assert mesh == [torch.device("cpu")] * 4 and mesh.local == [2, 3]
    for ranks in ([1, 1, 0, 0], [0, 1, 0, 1], [0, 0, 0, 1], [0, 0, 0, 0]):
        with pytest.raises(ValueError, match="rank order"):
            GlobalMesh(["cpu"] * 4, ranks, rank=0)


def test_make_global_row_sharded_places_this_ranks_rows():
    mesh = GlobalMesh(["cpu"] * 6, [0, 0, 0, 1, 1, 1], rank=1)
    rows = np.arange(12.0).reshape(6, 2)
    out = distributed.make_global_row_sharded(mesh, rows)
    assert out[:3] == [None] * 3
    for k, blk in enumerate(out[3:]):
        assert blk.dtype == torch.float64 and blk.is_contiguous()
        assert np.array_equal(blk.numpy(), rows[2 * k:2 * k + 2])
    full = sharded.shard_rows(mesh, np.arange(24.0).reshape(12, 2))
    assert full[:3] == [None] * 3 and np.array_equal(full[3].numpy(), [[12, 13], [14, 15]])
    with pytest.raises(ValueError, match="do not divide evenly"):
        distributed.make_global_row_sharded(mesh, rows[:5])
    # another rank's rows in this process's system are refused
    Xs = sharded.shard_rows(make_local_mesh(6, devices=["cpu"]), rows)
    with pytest.raises(ValueError, match="belongs to rank 0"):
        sharded._check_system(mesh, Xs, BackendType.torch)


def test_shard_system_feature_places_this_ranks_column_blocks():
    mesh = GlobalMesh(["cpu"] * 4, [0, 0, 1, 1], rank=1)
    X_pad, x_last = np.arange(32.0).reshape(4, 8), np.arange(8.0)
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, x_last, np.ones(4), np.ones(4))
    assert Xs[:2] == [None] * 2 and xls[:2] == [None] * 2
    for k, (X, xl) in enumerate(zip(Xs[2:], xls[2:])):
        cols = slice(4 + 2 * k, 6 + 2 * k)
        assert X.is_contiguous() and np.array_equal(X.numpy(), X_pad[:, cols])
        assert np.array_equal(xl.numpy(), x_last[cols])
    assert b.shape == m.shape == (4,)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
