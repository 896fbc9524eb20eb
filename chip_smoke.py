#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the repository around this script; it imports nothing of JAX.  Phases 3-10
check the exact tier and pin ``PLSSVM_MATMUL_PRECISION=highest``; phases
11-14 run the bf16x3 / bf16cast tiers and the default adaptive plan.
Phases, one line or more each, any failure exits non-zero:

1. device: ``nvidia-smi`` name and power limit, CUDA version;
2. build: every ``csrc/*.cu`` through ``ops/_build.py``;
3. K1 (symmetric Gram matvec) against its plain PyTorch version, three
   kernels x four shapes, with ms per A·v for both;
4. K2 (rectangular Gram matvec) against its plain version at predict
   shapes;
5. K3 (panel-pair Gram matvec) against its plain version at the sparse
   main path's panel pairs, three kernels: cross panels 4096 x 4096 at
   f = 4096, a ragged 3000 x 1700 pair at f = 1001, and the diagonal
   panel (``same=True``, K1 on the panel);
6. the dense main path through the CLIs: ``plssvm-train-torch`` on a
   seeded 32768 x 256 two-blob LIBSVM file (rbf, float32, ``-b cuda``),
   then ``plssvm-predict-torch`` on a 4096-point test file; the launch
   counters must show K1 in training and K2 in prediction, accuracy
   >= 95 %; and a small learn checked against a direct solve of the
   LS-SVM system;
7. timing at rbf 4096 x 256 float32: CG iterations/s at a pinned count
   (eps = 0, slope between two caps) with K1 and with the plain version,
   and learn() time to eps = 1e-6;
8. the sparse main path through the CLIs, at the JAX bench's sparse size
   (16384 x 4096 at 1 % density, rbf, float32, default
   ``--sparse_threshold``): the auto tier (``gram``), the ``dense`` tier
   (K1 must launch) and the ``implicit`` panel tier over four 4096-row
   panels (K3 must launch), each predicted by ``plssvm-predict-torch``;
   the tiers' decision values must agree and the accuracy reach its bar;
   the densify of one panel timed against the broadcast-compare form;
9. the sparse-linear CLI at the same size, CG it/s of every sparse tier
   at a pinned count, bitwise repeatability of two sparse learns, and one
   ``gather``-arm learn at 8192 x 262144 and 0.01 % density;
10. only with ``--profile``, run last: ``torch.profiler`` over 12 CG
    iterations of each sparse tier (4 of the gather arm), printing the
    device's idle share of the CG wall time and the six costliest kernels;
11. K4: K1, K2 and K3 at the bf16x3 and bf16cast tiers, three kernels, at
    the main path's shapes (and K3's ragged pair), each against its plain
    version at the same tier and against the exact kernel;
12. the adaptive dense main path: ``plssvm-train-torch`` on phase 6's
    32768 x 256 file with the default plan (bf16cast CG, verified and, if
    need be, continued on bf16x3), then ``plssvm-predict-torch`` with each
    bf16 tier pinned (K2 at that tier);
13. the adaptive sparse ``dense`` and ``implicit`` tiers through the CLIs
    on phase 8's 16384 x 4096, 1 % files;
14. a forced escalation (``PLSSVM_CG_STAG_PATIENCE=2``, eps 1e-9) at rbf
    4096 x 256, and CG it/s at a pinned count per tier (``highest``,
    ``high``, ``default``) at rbf 32768 x 256 and at the sparse
    ``implicit`` tier.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Scratch files go to ``.smoke_work/``
beside this script and are removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
SEED = 20261016
#: kernel vs plain version: the two differ only in summation order, over up
#: to 32768 terms per entry; at a bf16 tier both multiply the same bf16
#: operands exactly, and the tensor core's f32 accumulation (not rounded to
#: nearest at every add) is one more difference in the order of the sums
TOL = 1e-4
#: a bf16 tier against the exact kernel, relative to max|exact|: the budgets
#: of tests/test_solver.py:133-137
TIER_BUDGET = {"bf16x3": 1e-3, "bf16cast": 3e-2}
SOURCES = {
    "gram_matvec_sym": "plssvm_sparse_fp22_tpu_torch/csrc/gram_matvec.cu",
    "gram_matvec_rect": "plssvm_sparse_fp22_tpu_torch/csrc/gram_matvec.cu",
    "gram_pair_contrib": "plssvm_sparse_fp22_tpu_torch/csrc/pair_contrib.cu",
}
_PALLAS = "plssvm_sparse_fp22_tpu/ops/pallas_matvec.py"
#: the TPU kernel (body, or its tier arm) each kernel x tier replaces; K3
#: (pair_gram_contrib) runs the body of K1 over two panels, so its bf16 tiers
#: replace the same arms as K1's
REPLACES = {
    "gram_matvec_sym/exact": f"{_PALLAS}:388",
    "gram_matvec_sym/bf16x3": f"{_PALLAS}:441",
    "gram_matvec_sym/bf16cast": f"{_PALLAS}:453",
    "gram_matvec_rect/exact": f"{_PALLAS}:117",
    "gram_matvec_rect/bf16x3": f"{_PALLAS}:157",
    "gram_matvec_rect/bf16cast": f"{_PALLAS}:165",
    "gram_pair_contrib/exact": f"{_PALLAS}:716",
    "gram_pair_contrib/bf16x3": f"{_PALLAS}:441",
    "gram_pair_contrib/bf16cast": f"{_PALLAS}:453",
}
#: the sparse main path: the JAX bench's sparse size (bench.py:640-643) and
#: its gamma = 256 / f (bench.py:191-199: at 1 / f the rbf matrix is nearly
#: rank one)
SPARSE_N, SPARSE_TEST, SPARSE_F, SPARSE_DENSITY = 16384, 4096, 4096, 0.01
SPARSE_GAMMA = 256.0 / SPARSE_F
#: the panel tier's K-cache budget: 4 panels of 4096 rows (bench.py:150-154
#: keeps the decomposition honest the same way)
PANEL_BUDGET = 512 * 1024**2
#: the three sparse tiers solve one system to eps 1e-6 in float32, each
#: stopping with its own residual after 7 iterations: on an H100 the dense
#: and implicit tiers' decision values sat 4.0e-3 and 4.2e-3 of the largest
#: one from the gram tier's, so the bound is 2e-2 and 99 % equal labels
TIER_TOL = 2e-2
TIER_LABELS = 0.99
#: accuracy on the planted linear rule; a CPU rehearsal reached 72 % at 4096
#: and 79 % at 8192 training rows (rbf and linear alike)
SPARSE_ACCURACY = 75.0


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def two_blobs(n: int, f: int, rng: np.random.Generator):
    """Two gaussian blobs at +-0.5 per feature, labels +-1, shuffled."""
    half = n // 2
    X = np.concatenate([rng.normal(0.5, 1.0, (half, f)), rng.normal(-0.5, 1.0, (n - half, f))])
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def write_libsvm(path: str, X: np.ndarray, y: np.ndarray) -> None:
    """Dense LIBSVM file, 0-based indices like the reference's fixtures;
    9 significant digits round-trip float32."""
    fmt = "%d " + " ".join(f"{j}:%.9g" for j in range(X.shape[1]))
    with open(path, "w") as fh:
        np.savetxt(fh, np.column_stack([y, X]), fmt=fmt)


def write_libsvm_sparse(path: str, csr, y: np.ndarray) -> None:
    """Sparse LIBSVM file (0-based indices, 9 significant digits)."""
    with open(path, "w") as fh:
        for i in range(csr.shape[0]):
            lo, hi = csr.indptr[i], csr.indptr[i + 1]
            pairs = " ".join(f"{j}:{v:.9g}" for j, v in zip(csr.indices[lo:hi], csr.data[lo:hi]))
            fh.write(f"{int(y[i])} {pairs}\n")


def planted_sparse(n: int, f: int, density: float, rng: np.random.Generator):
    """Uniform [0, 1) values at the given density (``bench.py:182-211``)
    with labels from a planted linear rule: the sign of ``x . w - median``
    for a random dense ``w``."""
    import scipy.sparse as sp

    csr = sp.random(n, f, density=density, format="csr", dtype=np.float32, random_state=rng)
    score = csr @ rng.normal(size=f)
    return csr, np.where(score > np.median(score), 1.0, -1.0)


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block (the tier knobs)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recording_csvms(cli_module):
    """Keep the CSVMs a CLI module builds, to read their ``last_cg_info``."""
    made, build = [], cli_module.make_csvm

    def make(params):
        made.append(build(params))
        return made[-1]

    cli_module.make_csvm = make
    try:
        yield made
    finally:
        cli_module.make_csvm = build


def nonzero(counts: dict) -> dict:
    """The launch counters that are not 0."""
    return {k: v for k, v in counts.items() if v}


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_cli(main, argv) -> tuple[int, str]:
    """Run a CLI ``main`` in-process, echo and return its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return rc, out


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}",
          flush=True)


def phase_build():
    from plssvm_sparse_fp22_tpu_torch.ops import _build

    info = _build.build()
    lib = _build.load()
    check(lib.gram_matvec_tile() > 0, "kernel library did not load")
    usage = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    print(f"[2 build] nvcc {info['seconds']:.1f} s (cached: {info['cached']}) -> "
          f"{os.path.relpath(info['path'], ROOT)}; " + " | ".join(usage), flush=True)


def compare(name, got, want, ms, plain_ms, label):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = err <= TOL * scale
    print(f"  {name} {label}: max|d|={err:.3e} (rel {err / scale:.2e}, tol {TOL:g}) "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call", flush=True)
    check(ok, f"{name} {label} disagrees with its plain version: {err} > {TOL} * {scale}")
    return err


def phase_k1(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[3 K1] gram_matvec_sym vs gram_matvec_sym_plain, float32", flush=True)
    record = {}
    for D, f in [(40, 5), (96, 33), (4096, 256), (32768, 256)]:
        X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
        v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
        for kernel in KernelType:
            kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
            mv = gm.make_sym_matvec(kernel, X, **kw)
            sq = gm.row_sqnorms(X)

            def plain():
                return gm.gram_matvec_sym_plain(kernel, X, v, sq=sq, **kw)

            got, want = mv(v), plain()
            torch.cuda.synchronize()
            big = D >= 4096
            ms = timed_ms(lambda: mv(v), 20 if big else 50)
            plain_ms = timed_ms(plain, 5 if big else 50)
            err = compare("K1", got, want, ms, plain_ms, f"{kernel.name} ({D}, {f})")
            if (D, f, kernel) == (32768, 256, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_k2(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[4 K2] gram_matvec vs gram_matvec_plain, float32, X_sv (32768, 256)", flush=True)
    f = 256
    Y = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    sqy = gm.row_sqnorms(Y)
    record = {}
    for D in (1, 4096):
        P = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
        for kernel in KernelType:
            kw = {"Y": Y, "degree": 3, "gamma": 1.0 / f, "coef0": 1.0, "sqy": sqy}

            def kern():
                return gm.gram_matvec(kernel, P, a, **kw)

            def plain():
                return gm.gram_matvec_plain(kernel, P, a, **kw)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            ms = timed_ms(kern, 20)
            plain_ms = timed_ms(plain, 5)
            err = compare("K2", got, want, ms, plain_ms, f"{kernel.name} P ({D}, {f})")
            if (D, kernel) == (4096, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_k3(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[5 K3] pair_gram_contrib vs pair_gram_contrib_plain, float32", flush=True)
    record = {}
    for Di, Dj, f, same in [(4096, 4096, 4096, False), (3000, 1700, 1001, False),
                            (4096, 4096, 4096, True)]:
        Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
        Xj = Xi if same else torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32,
                                          device=dev)
        vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
        vj = vi if same else torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
        sqi, sqj = gm.row_sqnorms(Xi), gm.row_sqnorms(Xj)
        for kernel in KernelType:
            kw = {"same": same, "sq_i": sqi, "sq_j": sqj, "degree": 3, "gamma": 1.0 / f,
                  "coef0": 1.0}

            def kern():
                return gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, **kw)

            def plain():
                return gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, **kw)

            (oi, oj), (wi, wj) = kern(), plain()
            torch.cuda.synchronize()
            # both sides of a cross pair; with same=True their sum is the contract
            got = oi + oj if same else torch.cat([oi, oj])
            want = wi + wj if same else torch.cat([wi, wj])
            ms, plain_ms = timed_ms(kern, 10), timed_ms(plain, 10)
            label = f"{kernel.name} ({Di}, {Dj}, f {f}){' same' if same else ''}"
            err = compare("K3", got, want, ms, plain_ms, label)
            if (Di, same, kernel) == (4096, False, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_main_path(rng):
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.cli.train import main as train_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    n_train, n_test, f = 32768, 4096, 256
    X, y = two_blobs(n_train + n_test, f, rng)
    train, test = os.path.join(WORK, "train.libsvm"), os.path.join(WORK, "test.libsvm")
    model, out = os.path.join(WORK, "train.model"), os.path.join(WORK, "test.predict")
    t0 = time.perf_counter()
    write_libsvm(train, X[:n_train], y[:n_train])
    write_libsvm(test, X[n_train:], y[n_train:])
    print(f"[6 main path] wrote {n_train} x {f} train and {n_test} x {f} test files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gm.reset_launches()
    t0 = time.perf_counter()
    rc, log = run_cli(train_main, ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda",
                                   "-p", "gpu_nvidia", train, model])
    train_s = time.perf_counter() - t0
    after_train = dict(gm.launches)
    check(rc == 0, f"train CLI returned {rc}")
    m = re.search(r"Finished after (\d+) iterations", log)
    check(m is not None, "train CLI printed no iteration count")
    iters = int(m.group(1))
    # only the implicit mode on the cuda backend launches K1
    k1 = after_train["gram_matvec_sym/exact"]
    check(k1 > 0, "training did not launch K1 (implicit mode)")
    check(k1 == iters + 1 + iters // 50,
          f"K1 launches {k1} != one per CG iteration plus the initial residual and the "
          f"refreshes ({iters} iterations)")
    print(f"[6 main path] train CLI: rc 0, {iters} CG iterations in implicit mode, "
          f"{train_s:.1f} s end to end, launches {nonzero(after_train)}", flush=True)

    t0 = time.perf_counter()
    rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                     test, model, out])
    predict_s = time.perf_counter() - t0
    launches = dict(gm.launches)
    check(rc == 0, f"predict CLI returned {rc}")
    check(launches["gram_matvec_rect/exact"] > after_train["gram_matvec_rect/exact"],
          "prediction did not launch K2")
    labels = np.loadtxt(out)
    check(labels.shape == (n_test,) and set(np.unique(labels)) <= {-1.0, 1.0},
          f"prediction file holds {labels.shape} values, not {n_test} labels of +-1")
    m = re.search(r"Accuracy = ([0-9.]+)%", log)
    check(m is not None, "predict CLI printed no accuracy")
    acc = float(m.group(1))
    check(acc >= 95.0, f"accuracy {acc}% < 95%")
    check(abs(np.mean(labels == y[n_train:]) * 100 - acc) < 1e-9,
          "accuracy line disagrees with the labels")
    print(f"[6 main path] predict CLI: rc 0, accuracy {acc}%, {predict_s:.1f} s end to end, "
          f"launches {nonzero(launches)}", flush=True)
    return {"launches": launches, "train": train, "test": test}


def phase_reference(rng):
    """A small rbf learn on the cuda backend against a direct solve of the
    full LS-SVM system [[K + I/C, 1], [1^T, 0]] [alpha; b] = [y; 0]."""
    import scipy.sparse as sp

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    n, f, gamma = 300, 16, 1.0 / 16
    X, y = two_blobs(n + 100, f, rng)
    P, X, y = X[n:], X[:n], y[:n]
    p = Parameter(kernel=KernelType.rbf, gamma=gamma, epsilon=1e-6, max_iter=500,
                  dtype=np.float32, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    svm.learn()
    check(svm.last_cg_info["mode"] == "implicit", "small learn did not run implicit mode")
    got = svm.predict(P)

    def rbf(A, B):
        d = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * A @ B.T
        return np.exp(-gamma * np.maximum(d, 0.0))

    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = rbf(X, X) + np.eye(n)
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    want = rbf(P, X) @ sol[:n] + sol[n]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    check(np.all(np.isfinite(got)) and got.shape == (100,), "small predict not finite")
    # float32 CG to eps 1e-6 against an exact float64 solve: 2e-4 to 5e-4 of
    # the scale in a CPU rehearsal of this phase (torch backend, 5 seeds)
    check(err <= 5e-3, f"small learn off the direct solve by {err:.2e} of scale")
    print(f"[6 reference] rbf 300 x 16 float32 cuda learn ({svm.last_cg_info['iterations']} "
          f"CG iterations): decision values within {err:.2e} of a direct float64 solve",
          flush=True)


def dense_system(dev, X, y, gamma):
    """The reduced rbf CG system of a dense data set on the card, as
    ``CSVM._learn_dense`` builds it (C = 1): ``(X_pad, q, mask, QA_cost,
    cost_inv, b)``, padded to a multiple of 256 rows."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    n, f = X.shape
    dept = n - 1
    D = -(-dept // 256) * 256
    Xp = np.zeros((D, f), np.float32)
    Xp[:dept] = X[:dept]
    Xd = torch.tensor(Xp, device=dev)
    xl = torch.tensor(X[-1], dtype=torch.float32, device=dev)
    mask = torch.zeros(D, device=dev)
    mask[:dept] = 1.0
    b = torch.zeros(D, device=dev)
    b[:dept] = torch.tensor(y[:dept] - y[-1], dtype=torch.float32, device=dev)
    cost_inv = torch.tensor(1.0, device=dev)
    q = gram_block(KernelType.rbf, Xd, xl[None, :], gamma=gamma)[:, 0] * mask
    QA = kernel_scalar(KernelType.rbf, xl, xl, gamma=gamma) + cost_inv
    return Xd, q, mask, QA, cost_inv, b


def pinned_cg_rate(op, b, mask, caps) -> float:
    """CG iterations per second of an operator at a pinned count: eps = 0,
    the slope of the synchronised solve time between two caps."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve

    secs = {}
    for imax in caps:
        cg_solve(op.matvec, b, mask, 0.0, 5)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve(op.matvec, b, mask, 0.0, imax)
        torch.cuda.synchronize()
        secs[imax] = time.perf_counter() - t0
        check(res.iterations == imax, f"pinned CG ran {res.iterations} != {imax}")
    return (caps[1] - caps[0]) / (secs[caps[1]] - secs[caps[0]])


def phase_timing(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    import scipy.sparse as sp

    n, f = 4096, 256
    gamma = 1.0 / f
    X, y = two_blobs(n, f, rng)
    Xd, q, mask, QA, cost_inv, b = dense_system(dev, X, y, gamma)

    print(f"[7 timing] rbf {n} x {f} float32, implicit mode, CG at eps = 0", flush=True)
    rates = {}
    for backend in (BackendType.cuda, BackendType.torch, BackendType.torch, BackendType.cuda):
        op = build_operator(KernelType.rbf, Xd, q, mask, QA, cost_inv, gamma=gamma,
                            mode="implicit", backend=backend)
        rate = pinned_cg_rate(op, b, mask, (20, 120))
        rates.setdefault(backend.value, []).append(rate)
        print(f"  {backend.value:5s} ({'K1' if backend == BackendType.cuda else 'plain'}): "
              f"{rate:.1f} CG it/s (slope 20 -> 120 iterations)", flush=True)

    p = Parameter(kernel=KernelType.rbf, gamma=gamma, epsilon=1e-6, max_iter=1000,
                  dtype=np.float32, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    svm.learn()  # warm-up (library load, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm.learn()
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    info = svm.last_cg_info
    print(f"  learn() to eps 1e-6: {learn_s:.4f} s, {info['iterations']} CG iterations, "
          f"mode {info['mode']}, converged: {info['delta'] <= 1e-12 * info['delta0']}",
          flush=True)
    return rates


def densify_compare(vals, lcols, ntiles: int, Lt: int):
    """The JAX package's broadcast-compare densify (``sparse.py:324-337``),
    in torch, timed against the port's index-put form."""
    import torch

    m = vals.shape[0]
    V, C = vals.reshape(m, ntiles, Lt), lcols.reshape(m, ntiles, Lt)
    lane = torch.arange(128, dtype=C.dtype, device=C.device).reshape(1, 1, 128)
    out = torch.zeros((m, ntiles, 128), dtype=vals.dtype, device=vals.device)
    for slot in range(Lt):
        out = out + V[:, :, slot:slot + 1] * (C[:, :, slot:slot + 1] == lane)
    return out.reshape(m, ntiles * 128)


def sparse_learn(csr, y, kernel, *, eps, max_iter, gamma=SPARSE_GAMMA):
    """A float32 learn on the cuda backend through the library API; returns
    the CSVM and its seconds (synchronised)."""
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType

    p = Parameter(kernel=kernel, gamma=gamma, epsilon=eps, max_iter=max_iter,
                  dtype=np.float32, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=csr, values=y)
    p.values = y
    svm = make_csvm(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm.learn()
    torch.cuda.synchronize()
    return svm, time.perf_counter() - t0


@contextlib.contextmanager
def cg_spans():
    """Seconds of every CG solve the learns run (synchronised before and
    after), so a rate leaves out packing and Gram assembly."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.models import base, sparse_learn as learns

    spans, solve = [], learns.cg_solve

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(*args, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return res

    base.cg_solve = learns.cg_solve = timed
    try:
        yield spans
    finally:
        base.cg_solve = learns.cg_solve = solve


def pinned_rate(csr, y, kernel, caps, **kw) -> float:
    """CG iterations per second at a pinned count: eps = 0, the slope of the
    CG solve's seconds between two iteration caps, the faster of two learns
    at each cap."""
    secs = {}
    with cg_spans() as spans:
        for imax in caps:
            for _ in range(2):
                svm, _ = sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)
                check(svm.last_cg_info["iterations"] == imax,
                      f"pinned CG ran {svm.last_cg_info['iterations']} != {imax}")
                secs[imax] = min(spans[-1], secs.get(imax, spans[-1]))
    return (caps[1] - caps[0]) / (secs[caps[1]] - secs[caps[0]])


def phase_sparse_main(dev):
    """The sparse main path through the CLIs, one run per tier, each with
    the launch counters set to 0 just before and read just after."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import parse_libsvm_file
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops import sparse as ops_sparse

    rng = np.random.default_rng(SEED + 1)
    n, f = SPARSE_N, SPARSE_F
    csr, y = planted_sparse(n + SPARSE_TEST, f, SPARSE_DENSITY, rng)
    train, test = os.path.join(WORK, "sparse.libsvm"), os.path.join(WORK, "sparse.test.libsvm")
    t0 = time.perf_counter()
    write_libsvm_sparse(train, csr[:n], y[:n])
    write_libsvm_sparse(test, csr[n:], y[n:])
    test_data = parse_libsvm_file(test)
    print(f"[8 sparse] wrote {n} x {f} train and {SPARSE_TEST} x {f} test files at "
          f"{SPARSE_DENSITY:.0%} density ({csr.nnz} nonzeros) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    tiers = [("auto", {}, "sparse_gram"),
             ("dense", {"PLSSVM_SPARSE_MODE": "dense"}, "sparse_dense_implicit"),
             ("implicit", {"PLSSVM_SPARSE_MODE": "implicit",
                           "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, "sparse_implicit")]
    decisions, launches = {}, {}
    for name, env, mode in tiers:
        model, out = os.path.join(WORK, f"sparse.{name}.model"), os.path.join(WORK, "s.predict")
        with environ(**env), recording_csvms(train_cli) as made:
            gm.reset_launches()
            t0 = time.perf_counter()
            rc, _ = run_cli(train_cli.main, ["-t", "2", "-g", repr(SPARSE_GAMMA), "-e", "1e-6",
                                             "--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                             train, model])
            train_s = time.perf_counter() - t0
            counts = dict(gm.launches)
        check(rc == 0, f"sparse train CLI ({name} tier) returned {rc}")
        svm = made[-1]
        info = svm.last_cg_info
        iters = info["iterations"]
        check(info["mode"] == mode, f"{name} tier ran mode {info['mode']}, not {mode}")
        # A·v products: the initial residual, one per iteration, the refreshes
        mvs = iters + 1 + iters // 50
        want = {"auto": {"gram_matvec_sym/exact": 0, "gram_pair_contrib/exact": 0},
                "dense": {"gram_matvec_sym/exact": mvs, "gram_pair_contrib/exact": 0},
                # 4 panels: 4 diagonal pairs on K1, 6 cross pairs on K3
                "implicit": {"gram_matvec_sym/exact": 4 * mvs,
                             "gram_pair_contrib/exact": 6 * mvs}}[name]
        check(all(counts[k] == v for k, v in want.items()),
              f"{name} tier launches {counts}, expected {want}")
        decisions[name] = svm.predict_parsed(test_data)
        check(np.all(np.isfinite(decisions[name])) and decisions[name].shape == (SPARSE_TEST,),
              f"{name} tier decision values are not {SPARSE_TEST} finite numbers")
        rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                         test, model, out])
        check(rc == 0, f"sparse predict CLI ({name} tier) returned {rc}")
        m = re.search(r"Accuracy = ([0-9.]+)%", log)
        check(m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
              f"{name} tier accuracy {m and m.group(1)}% < {SPARSE_ACCURACY}%")
        labels = np.loadtxt(out)
        agree = np.mean(labels == np.where(decisions[name] > 0, 1.0, -1.0))
        check(agree >= 0.999, f"predict CLI labels agree with the decision values on {agree:.4f}")
        launches[name] = counts
        print(f"[8 sparse] {name} tier: mode {mode}, {iters} CG iterations, train CLI "
              f"{train_s:.1f} s, accuracy {m.group(1)}%, launches {nonzero(counts)}", flush=True)
        del made, svm
    scale = float(np.abs(decisions["auto"]).max())
    for name in ("dense", "implicit"):
        err = float(np.abs(decisions[name] - decisions["auto"]).max()) / scale
        same = float(np.mean((decisions[name] > 0) == (decisions["auto"] > 0)))
        print(f"[8 sparse] {name} vs auto (gram) decision values: max|d| {err:.2e} of the "
              f"scale (tol {TIER_TOL:g}), equal labels {same:.4f}", flush=True)
        check(err <= TIER_TOL and same >= TIER_LABELS,
              f"{name} tier disagrees with the gram tier: {err:.2e}, labels {same:.4f}")

    # one panel of the implicit tier's packing, densified both ways
    dept = n - 1
    D = -(-dept // 256) * 256
    th = ops_sparse.TiledHybrid.from_csr(csr[:dept], dtype=np.float32, pad_rows=D, device=dev)
    vals, lcols = th.tell.vals[:4096], th.tell.lcols[:4096]
    args = (vals, lcols, th.tell.ntiles, th.tell.Lt)
    got, want = ops_sparse.densify_tiled(*args), densify_compare(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "index-put densify differs from the broadcast compare")
    put_ms, cmp_ms = timed_ms(lambda: ops_sparse.densify_tiled(*args), 20), \
        timed_ms(lambda: densify_compare(*args), 20)
    print(f"[8 sparse] densify one 4096-row panel (ntiles {th.tell.ntiles}, Lt {th.tell.Lt}, "
          f"{len(th.heavy_idx)} heavy rows): index-put {put_ms:.3f} ms, broadcast compare "
          f"{cmp_ms:.3f} ms", flush=True)
    return {"csr": csr[:n], "y": y[:n], "launches": launches, "train": train, "test": test}


def phase_sparse_more(sparse):
    """The sparse-linear CLI, CG it/s of every sparse tier, repeatability,
    and the gather arm."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    csr, y = sparse["csr"], sparse["y"]
    model, out = os.path.join(WORK, "sparse.linear.model"), os.path.join(WORK, "s.predict")
    with recording_csvms(train_cli) as made:
        t0 = time.perf_counter()
        rc, _ = run_cli(train_cli.main, ["-t", "0", "-e", "1e-6", "--use_float", "-b", "cuda",
                                         "-p", "gpu_nvidia", sparse["train"], model])
        train_s = time.perf_counter() - t0
    check(rc == 0, f"sparse-linear train CLI returned {rc}")
    info = made[-1].last_cg_info
    check(info["mode"] == "sparse_linear", f"linear run took mode {info['mode']}")
    rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                     sparse["test"], model, out])
    m = re.search(r"Accuracy = ([0-9.]+)%", log)
    check(rc == 0 and m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
          f"sparse-linear predict CLI rc {rc}, accuracy {m and m.group(1)}%")
    print(f"[9 sparse] linear CLI: mode sparse_linear, {info['iterations']} CG iterations, "
          f"train CLI {train_s:.1f} s, accuracy {m.group(1)}%", flush=True)

    # the cheap tiers' iterations (a GEMV, two sparse products) get a longer
    # span, so the slope rises above the host's timing noise
    for name, kernel, env, caps in [
            ("gram", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "gram"}, (10, 210)),
            ("dense", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "dense"}, (4, 16)),
            ("implicit", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "implicit",
                                          "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, (4, 16)),
            ("linear", KernelType.linear, {}, (10, 210))]:
        with environ(**env):
            rate = pinned_rate(csr, y, kernel, caps)
        print(f"[9 sparse] {name} tier, {SPARSE_N} x {SPARSE_F}: {rate:.1f} CG it/s "
              f"(eps = 0, slope {caps[0]} -> {caps[1]} iterations)", flush=True)

    for name, kernel, env in [("linear", KernelType.linear, {}),
                              ("implicit", KernelType.rbf,
                               {"PLSSVM_SPARSE_MODE": "implicit",
                                "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)})]:
        with environ(**env):
            a, _ = sparse_learn(csr, y, kernel, eps=1e-6, max_iter=500)
            b, _ = sparse_learn(csr, y, kernel, eps=1e-6, max_iter=500)
        same = (a.last_cg_info["iterations"] == b.last_cg_info["iterations"]
                and np.array_equal(a.alphas, b.alphas) and a.bias_ == b.bias_)
        check(same, f"two {name} sparse learns differ")
        print(f"[9 sparse] {name} tier repeats bitwise: {a.last_cg_info['iterations']} CG "
              f"iterations twice, equal alphas and bias", flush=True)

    rng = np.random.default_rng(SEED + 2)
    gcsr, gy = planted_sparse(8192, 262144, 1e-4, rng)
    with environ(PLSSVM_SPARSE_MODE="implicit"):
        gm.reset_launches()
        svm, learn_s = sparse_learn(gcsr, gy, KernelType.rbf, eps=1e-6, max_iter=20,
                                    gamma=1.0 / 32)
        counts = dict(gm.launches)
        rate = pinned_rate(gcsr, gy, KernelType.rbf, (2, 6), gamma=1.0 / 32)
    info = svm.last_cg_info
    check(info["mode"] == "sparse_implicit" and not any(counts.values()),
          f"gather arm: mode {info['mode']}, launches {counts} (the gather arm is plain torch)")
    check(np.all(np.isfinite(svm.alphas)), "gather-arm alphas are not finite")
    print(f"[9 sparse] gather arm, rbf 8192 x 262144 at 0.01 % ({gcsr.nnz} nonzeros): "
          f"{info['iterations']} CG iterations in {learn_s:.2f} s, {rate:.1f} CG it/s "
          f"(eps = 0, slope 2 -> 6)", flush=True)


def profiled_cg(csr, y, kernel, imax: int, **kw):
    """One learn at eps = 0 and ``imax`` iterations (after a warm-up learn)
    with its CG solve under ``torch.profiler``: the solve's wall seconds and
    the device time of each kernel it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plssvm_sparse_fp22_tpu_torch.models import base, sparse_learn as learns

    sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)  # warm-up
    solve, traced = learns.cg_solve, {}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = solve(*args, **kwargs)
            torch.cuda.synchronize()
            traced["wall"] = time.perf_counter() - t0
        traced["prof"] = prof
        return res

    base.cg_solve = learns.cg_solve = timed
    try:
        svm, _ = sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)
    finally:
        base.cg_solve = learns.cg_solve = solve
    check(svm.last_cg_info["iterations"] == imax, "profiled CG did not run its pinned count")
    # device microseconds per kernel name; older torch names the field cuda
    per_kernel = {}
    for ev in traced["prof"].key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            per_kernel[ev.key] = (us / 1e3, ev.count)
    return traced["wall"], per_kernel


def phase_profile(sparse):
    """Opt-in (``--profile``): where each sparse tier's CG time goes, as
    device time per kernel and the device's idle share of the CG wall time
    (1 - summed kernel time / wall); the profiler's own overhead is inside
    the wall time."""
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    panel = {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}
    rng = np.random.default_rng(SEED + 2)
    gcsr, gy = planted_sparse(8192, 262144, 1e-4, rng)
    cases = [("gram", sparse["csr"], sparse["y"], KernelType.rbf, {"PLSSVM_SPARSE_MODE": "gram"},
              12, {}),
             ("dense", sparse["csr"], sparse["y"], KernelType.rbf, {"PLSSVM_SPARSE_MODE": "dense"},
              12, {}),
             ("implicit", sparse["csr"], sparse["y"], KernelType.rbf, panel, 12, {}),
             ("linear", sparse["csr"], sparse["y"], KernelType.linear, {}, 12, {}),
             ("gather", gcsr, gy, KernelType.rbf, {"PLSSVM_SPARSE_MODE": "implicit"}, 4,
              {"gamma": 1.0 / 32})]
    for name, csr, y, kernel, env, imax, kw in cases:
        with environ(**env):
            wall, per_kernel = profiled_cg(csr, y, kernel, imax, **kw)
        busy = sum(ms for ms, _ in per_kernel.values())
        check(busy > 0, f"profile of the {name} tier saw no device time")
        print(f"[10 profile] {name}: {imax} CG iterations (+1 initial A·v), CG wall "
              f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle share "
              f"{1 - busy / (wall * 1e3):.3f}", flush=True)
        for key, (ms, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:10.3f} ms x {count:4d}  {key[:60]}", flush=True)


def compare_tier(name, tier, got, want, exact, ms, plain_ms, label):
    """A bf16-tier kernel against its plain version at the tier (``TOL``)
    and against the exact kernel (``TIER_BUDGET``); returns max|got - want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    off = float((got - exact).abs().max()) / float(exact.abs().max())
    print(f"  {name} {tier} {label}: max|d| vs plain {err:.3e} (rel {err / scale:.2e}, tol "
          f"{TOL:g}), vs exact rel {off:.2e} (budget {TIER_BUDGET[tier]:g}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms per call", flush=True)
    check(err <= TOL * scale, f"{name} {tier} {label} disagrees with its plain version: "
          f"{err} > {TOL} * {scale}")
    check(off <= TIER_BUDGET[tier], f"{name} {tier} {label} is {off:.2e} off the exact kernel")
    return err


def phase_k4(dev, rng):
    """The bf16x3 and bf16cast tiers of K1, K2 and K3 at the main path's
    shapes, three kernels, against their plain versions at the tier and the
    exact kernel.  The wrappers split or cast per call where the main path
    does (K2's support vectors, K3's transient panels), so their times
    include it; K1 splits once, as ``make_sym_matvec`` does for a CG loop."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print(f"[11 K4] bf16x3 / bf16cast tiers vs their plain versions (tol {TOL:g}) and the exact "
          f"kernel (budgets {TIER_BUDGET}), float32 inputs", flush=True)
    f = 256
    X = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    P = torch.tensor(rng.normal(size=(4096, f)), dtype=torch.float32, device=dev)
    sqx, sqy = gm.row_sqnorms(X), gm.row_sqnorms(Y)
    records = {}
    for kernel in KernelType:
        kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
        exact1 = gm.make_sym_matvec(kernel, X, tier="exact", **kw)(v)
        exact2 = gm.gram_matvec(kernel, P, a, Y=Y, sqy=sqy, tier="exact", **kw)
        for tier in TIER_BUDGET:
            mv = gm.make_sym_matvec(kernel, X, tier=tier, **kw)
            ops = gm.tier_operands(tier, X)

            def plain1():
                return gm.gram_matvec_sym_plain(kernel, X, v, sq=sqx, tier=tier, operands=ops,
                                                **kw)

            got, want = mv(v), plain1()
            torch.cuda.synchronize()
            ms, plain_ms = timed_ms(lambda: mv(v), 20), timed_ms(plain1, 3)
            err = compare_tier("K1", tier, got, want, exact1, ms, plain_ms,
                               f"{kernel.name} (32768, {f})")
            if kernel == KernelType.rbf:
                records[f"gram_matvec_sym/{tier}"] = {"max_abs_err": err, "ms": ms,
                                                      "plain_ms": plain_ms}

            def kern2():
                return gm.gram_matvec(kernel, P, a, Y=Y, sqy=sqy, tier=tier, **kw)

            def plain2():
                return gm.gram_matvec_plain(kernel, P, a, Y=Y, sqy=sqy, tier=tier, **kw)

            got, want = kern2(), plain2()
            torch.cuda.synchronize()
            ms, plain_ms = timed_ms(kern2, 20), timed_ms(plain2, 5)
            err = compare_tier("K2", tier, got, want, exact2, ms, plain_ms,
                               f"{kernel.name} P (4096, {f}) vs 32768 SVs")
            if kernel == KernelType.rbf:
                records[f"gram_matvec_rect/{tier}"] = {"max_abs_err": err, "ms": ms,
                                                       "plain_ms": plain_ms}
    del X, Y, P, exact1, exact2
    for Di, Dj, f in [(4096, 4096, 4096), (3000, 1700, 1001)]:
        Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
        Xj = torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32, device=dev)
        vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
        vj = torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
        sqi, sqj = gm.row_sqnorms(Xi), gm.row_sqnorms(Xj)
        for kernel in KernelType:
            kw = {"same": False, "sq_i": sqi, "sq_j": sqj, "degree": 3, "gamma": 1.0 / f,
                  "coef0": 1.0}
            exact3 = torch.cat(gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, tier="exact", **kw))
            for tier in TIER_BUDGET:
                def kern3():
                    return gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, tier=tier, **kw)

                def plain3():
                    return gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, tier=tier, **kw)

                got, want = torch.cat(kern3()), torch.cat(plain3())
                torch.cuda.synchronize()
                ms, plain_ms = timed_ms(kern3, 10), timed_ms(plain3, 5)
                err = compare_tier("K3", tier, got, want, exact3, ms, plain_ms,
                                   f"{kernel.name} ({Di}, {Dj}, f {f})")
                if (Di, kernel) == (4096, KernelType.rbf):
                    records[f"gram_pair_contrib/{tier}"] = {"max_abs_err": err, "ms": ms,
                                                            "plain_ms": plain_ms}
    return records


def check_adaptive(tag: str, info: dict, counts: dict, per_mv: dict, eps: float) -> None:
    """An adaptive learn's contract: the final residual is the accurate
    tier's and meets eps^2 delta0, and each tier launched its kernels once
    per A·v of its leg (``per_mv`` launches of each kernel per A·v): the
    fast leg's initial residual, iterations and refreshes on bf16cast; the
    verify step, the escalated iterations and their refreshes on bf16x3."""
    iters, kf = info["iterations"], info["fast_iterations"]
    check(info["delta"] <= eps ** 2 * info["delta0"],
          f"{tag}: residual {info['delta']} above eps^2 delta0 = {eps ** 2 * info['delta0']}")
    fast_mvs = kf + 1 + kf // 50
    acc_mvs = 1 + (iters - kf) + (iters // 50 - kf // 50)
    for kernel, n in per_mv.items():
        got = (counts[f"{kernel}/bf16cast"], counts[f"{kernel}/bf16x3"])
        check(got == (n * fast_mvs, n * acc_mvs),
              f"{tag}: {kernel} launched {got} times on (bf16cast, bf16x3), expected "
              f"{(n * fast_mvs, n * acc_mvs)} ({kf} fast of {iters} iterations)")
    check(not any(v for k, v in counts.items() if k.endswith("/exact")),
          f"{tag}: an exact kernel launched in an adaptive learn: {nonzero(counts)}")


def cg_ms(log: str) -> int:
    """The train CLI's own learn time ("... using CG in <ms>ms")."""
    m = re.search(r"using CG in (\d+)ms", log)
    check(m is not None, "train CLI printed no learn time")
    return int(m.group(1))


def phase_adaptive_dense(main):
    """The dense main path with the default plan: train on phase 6's file,
    then predict with each bf16 tier pinned (K2 at that tier)."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    model, out = os.path.join(WORK, "adaptive.model"), os.path.join(WORK, "adaptive.predict")
    with environ(PLSSVM_MATMUL_PRECISION=""), recording_csvms(train_cli) as made:
        gm.reset_launches()
        t0 = time.perf_counter()
        rc, log = run_cli(train_cli.main, ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda",
                                           "-p", "gpu_nvidia", main["train"], model])
        train_s = time.perf_counter() - t0
        counts = dict(gm.launches)
    check(rc == 0, f"adaptive train CLI returned {rc}")
    info = made[-1].last_cg_info
    check(info["mode"] == "implicit", f"adaptive learn ran mode {info['mode']}")
    check_adaptive("adaptive dense learn", info, counts, {"gram_matvec_sym": 1}, 1e-6)
    print(f"[12 adaptive] dense rbf 32768 x 256 train CLI (default plan): {info['iterations']} "
          f"CG iterations, fast_iterations {info['fast_iterations']}, escalated "
          f"{info['escalated']}, learn {cg_ms(log)} ms, CLI {train_s:.1f} s, residual "
          f"{info['delta']:.3e} <= eps^2 delta0 {1e-12 * info['delta0']:.3e}, launches "
          f"{nonzero(counts)}", flush=True)
    launches = {k: counts[k] for k in ("gram_matvec_sym/bf16cast", "gram_matvec_sym/bf16x3")}
    for pinned, tier in (("high", "bf16x3"), ("default", "bf16cast")):
        with environ(PLSSVM_MATMUL_PRECISION=pinned):
            gm.reset_launches()
            rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                             main["test"], model, out])
            counts = dict(gm.launches)
        m = re.search(r"Accuracy = ([0-9.]+)%", log)
        check(rc == 0 and m is not None and float(m.group(1)) >= 95.0,
              f"predict CLI at {pinned}: rc {rc}, accuracy {m and m.group(1)}%")
        check(nonzero(counts) == {f"gram_matvec_rect/{tier}": 1},
              f"predict CLI at {pinned} launched {nonzero(counts)}")
        launches[f"gram_matvec_rect/{tier}"] = counts[f"gram_matvec_rect/{tier}"]
        print(f"[12 adaptive] predict CLI, PLSSVM_MATMUL_PRECISION={pinned}: accuracy "
              f"{m.group(1)}%, launches {nonzero(counts)}", flush=True)
    return launches


def phase_adaptive_sparse(sparse):
    """The sparse ``dense`` and ``implicit`` tiers with the default plan,
    through the CLIs on phase 8's files."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    launches = {}
    model, out = os.path.join(WORK, "sparse.adaptive.model"), os.path.join(WORK, "s.predict")
    for name, env, mode, per_mv in [
            ("dense", {"PLSSVM_SPARSE_MODE": "dense"}, "sparse_dense_implicit",
             {"gram_matvec_sym": 1}),
            ("implicit", {"PLSSVM_SPARSE_MODE": "implicit",
                          "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, "sparse_implicit",
             {"gram_matvec_sym": 4, "gram_pair_contrib": 6})]:
        with environ(PLSSVM_MATMUL_PRECISION="", **env), recording_csvms(train_cli) as made:
            gm.reset_launches()
            t0 = time.perf_counter()
            rc, log = run_cli(train_cli.main, ["-t", "2", "-g", repr(SPARSE_GAMMA), "-e", "1e-6",
                                               "--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                               sparse["train"], model])
            train_s = time.perf_counter() - t0
            counts = dict(gm.launches)
            check(rc == 0, f"adaptive sparse train CLI ({name} tier) returned {rc}")
            rc, plog = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                              sparse["test"], model, out])
        info = made[-1].last_cg_info
        check(info["mode"] == mode, f"adaptive {name} tier ran mode {info['mode']}")
        check_adaptive(f"adaptive sparse {name} tier", info, counts, per_mv, 1e-6)
        m = re.search(r"Accuracy = ([0-9.]+)%", plog)
        check(rc == 0 and m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
              f"adaptive {name} tier predict: rc {rc}, accuracy {m and m.group(1)}%")
        if name == "implicit":
            launches = {k: counts[k] for k in ("gram_pair_contrib/bf16cast",
                                               "gram_pair_contrib/bf16x3")}
        print(f"[13 adaptive] sparse {name} tier, {SPARSE_N} x {SPARSE_F} at 1 % (default "
              f"plan): {info['iterations']} CG iterations, fast_iterations "
              f"{info['fast_iterations']}, escalated {info['escalated']}, learn {cg_ms(log)} ms, "
              f"CLI {train_s:.1f} s, accuracy {m.group(1)}%, launches {nonzero(counts)}",
              flush=True)
    return launches


def phase_tiers(dev, rng, sparse):
    """A forced escalation, and CG it/s per tier at a pinned count."""
    import scipy.sparse as sp
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator, tier_precision
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    n, f, imax, eps = 4096, 256, 300, 1e-9
    X, y = two_blobs(n, f, rng)
    with environ(PLSSVM_MATMUL_PRECISION="", PLSSVM_CG_STAG_PATIENCE="2"):
        p = Parameter(kernel=KernelType.rbf, gamma=1.0 / f, epsilon=eps, max_iter=imax,
                      dtype=np.float32, backend=BackendType.cuda, print_info=False)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        gm.reset_launches()
        t0 = time.perf_counter()
        svm.learn()
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t0
        counts = dict(gm.launches)
    info = svm.last_cg_info
    reached = info["delta"] <= eps ** 2 * info["delta0"]
    check(info["escalated"] and info["iterations"] > info["fast_iterations"],
          f"forced escalation did not escalate: {info}")
    check(reached or info["iterations"] == imax,
          f"forced escalation stopped at {info['iterations']} < imax without its target")
    check(counts["gram_matvec_sym/bf16x3"] > 1, f"escalation ran no bf16x3 K1: {counts}")
    print(f"[14 tiers] forced escalation, rbf {n} x {f}, patience 2, eps {eps:g}: "
          f"{info['fast_iterations']} iterations on default, "
          f"{info['iterations'] - info['fast_iterations']} on high, "
          f"{'target reached' if reached else 'stopped at imax'} (residual {info['delta']:.3e}, "
          f"target {eps ** 2 * info['delta0']:.3e}), {learn_s:.2f} s, launches {nonzero(counts)}",
          flush=True)

    n, f = 32768, 256
    X, y = two_blobs(n, f, rng)
    Xd, q, mask, QA, cost_inv, b = dense_system(dev, X, y, 1.0 / f)
    rates = {}
    for name in ("highest", "high", "default", "default", "high", "highest"):
        op = build_operator(KernelType.rbf, Xd, q, mask, QA, cost_inv, gamma=1.0 / f,
                            mode="implicit", backend=BackendType.cuda,
                            precision=tier_precision(name))
        rates.setdefault(name, []).append(pinned_cg_rate(op, b, mask, (5, 25)))
    print(f"[14 tiers] dense rbf {n} x {f}, implicit, CG it/s at eps = 0 (slope 5 -> 25, in "
          f"turns): " + ", ".join(f"{k} {' / '.join(f'{r:.1f}' for r in v)}"
                                  for k, v in rates.items()), flush=True)
    panel = {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}
    srates = {}
    for name in ("highest", "high", "default"):
        with environ(PLSSVM_MATMUL_PRECISION=name, **panel):
            srates[name] = pinned_rate(sparse["csr"], sparse["y"], KernelType.rbf, (4, 16))
    print(f"[14 tiers] sparse implicit tier, {SPARSE_N} x {SPARSE_F} at 1 %, CG it/s at eps = 0 "
          f"(slope 4 -> 16): " + ", ".join(f"{k} {r:.1f}" for k, r in srates.items()),
          flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 10: torch.profiler over each sparse tier's CG")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU",
              flush=True)
        return 1
    sys.path.insert(0, ROOT)
    import plssvm_sparse_fp22_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    os.makedirs(WORK, exist_ok=True)
    try:
        phase_device()
        phase_build()
        # phases 3-10 hold the exact tier; the plan is off while a tier is pinned
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            records = {"gram_matvec_sym/exact": phase_k1(dev, rng),
                       "gram_matvec_rect/exact": phase_k2(dev, rng),
                       "gram_pair_contrib/exact": phase_k3(dev, rng)}
            dense = phase_main_path(rng)
            phase_reference(rng)
            phase_timing(dev, rng)
            sparse = phase_sparse_main(dev)
            phase_sparse_more(sparse)
        records.update(phase_k4(dev, rng))
        # each kernel x tier counted over a main path's run: the exact tier's
        # K1 and K2 over the dense train and predict CLIs, K3 over the sparse
        # implicit tier; the bf16 tiers over the adaptive learns and the
        # predicts with a tier pinned
        launches = {k: dense["launches"][k]
                    for k in ("gram_matvec_sym/exact", "gram_matvec_rect/exact")}
        launches["gram_pair_contrib/exact"] = \
            sparse["launches"]["implicit"]["gram_pair_contrib/exact"]
        launches.update(phase_adaptive_dense(dense))
        launches.update(phase_adaptive_sparse(sparse))
        phase_tiers(dev, rng, sparse)
        if args.profile:
            with environ(PLSSVM_MATMUL_PRECISION="highest"):
                phase_profile(sparse)
        kernels = [{"name": name, "route": "cuda", "source": SOURCES[name.split("/")[0]],
                    "replaces": REPLACES[name], "launches": launches[name], **rec}
                   for name, rec in records.items()]
        check(len(kernels) == 9 and all(k["launches"] > 0 for k in kernels),
              f"a kernel of the path never launched: {launches}")
    except SmokeError as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
