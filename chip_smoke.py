#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the repository around this script; it imports nothing of JAX.  Phases, one
line or more each, any failure exits non-zero:

1. device: ``nvidia-smi`` name and power limit, CUDA version;
2. build: ``csrc/gram_matvec.cu`` through ``ops/_build.py``;
3. K1 (symmetric Gram matvec) against its plain PyTorch version, three
   kernels x four shapes, with ms per A·v for both;
4. K2 (rectangular Gram matvec) against its plain version at predict
   shapes;
5. the main path through the CLIs: ``plssvm-train-torch`` on a seeded
   32768 x 256 two-blob LIBSVM file (rbf, float32, ``-b cuda``), then
   ``plssvm-predict-torch`` on a 4096-point test file; the launch counters
   must show K1 in training and K2 in prediction, accuracy >= 95 %; and a
   small learn checked against a direct solve of the LS-SVM system;
6. timing at rbf 4096 x 256 float32: CG iterations/s at a pinned count
   (eps = 0, slope between two caps) with K1 and with the plain version,
   and learn() time to eps = 1e-6.

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
#: to 32768 terms per entry
TOL = 1e-4
SOURCE = "plssvm_sparse_fp22_tpu_torch/csrc/gram_matvec.cu"
REPLACES = {
    "gram_matvec_sym": "plssvm_sparse_fp22_tpu/ops/pallas_matvec.py:388",
    "gram_matvec_rect": "plssvm_sparse_fp22_tpu/ops/pallas_matvec.py:117",
}


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
    print(f"[5 main path] wrote {n_train} x {f} train and {n_test} x {f} test files in "
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
    check(after_train["gram_matvec_sym"] > 0, "training did not launch K1 (implicit mode)")
    check(after_train["gram_matvec_sym"] == iters + 1 + iters // 50,
          f"K1 launches {after_train['gram_matvec_sym']} != one per CG iteration plus "
          f"the initial residual and the refreshes ({iters} iterations)")
    print(f"[5 main path] train CLI: rc 0, {iters} CG iterations in implicit mode, "
          f"{train_s:.1f} s end to end, launches {after_train}", flush=True)

    t0 = time.perf_counter()
    rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                     test, model, out])
    predict_s = time.perf_counter() - t0
    launches = dict(gm.launches)
    check(rc == 0, f"predict CLI returned {rc}")
    check(launches["gram_matvec_rect"] > after_train["gram_matvec_rect"],
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
    print(f"[5 main path] predict CLI: rc 0, accuracy {acc}%, {predict_s:.1f} s end to end, "
          f"launches {launches}", flush=True)
    return launches


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
    print(f"[5 reference] rbf 300 x 16 float32 cuda learn ({svm.last_cg_info['iterations']} "
          f"CG iterations): decision values within {err:.2e} of a direct float64 solve",
          flush=True)


def phase_timing(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    import scipy.sparse as sp

    n, f = 4096, 256
    gamma = 1.0 / f
    X, y = two_blobs(n, f, rng)
    dept = n - 1
    D = 4096
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

    print(f"[6 timing] rbf {n} x {f} float32, implicit mode, CG at eps = 0", flush=True)
    rates = {}
    for backend in (BackendType.cuda, BackendType.torch, BackendType.torch, BackendType.cuda):
        op = build_operator(KernelType.rbf, Xd, q, mask, QA, cost_inv, gamma=gamma,
                            mode="implicit", backend=backend)
        secs = {}
        for imax in (20, 120):
            cg_solve(op.matvec, b, mask, 0.0, 5)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cg_solve(op.matvec, b, mask, 0.0, imax)
            torch.cuda.synchronize()
            secs[imax] = time.perf_counter() - t0
            check(res.iterations == imax, f"pinned CG ran {res.iterations} != {imax}")
        rate = 100 / (secs[120] - secs[20])
        rates.setdefault(backend.value, []).append(rate)
        print(f"  {backend.value:5s} ({'K1' if backend == BackendType.cuda else 'plain'}): "
              f"{rate:.1f} CG it/s (20 it {secs[20]:.4f} s, 120 it {secs[120]:.4f} s)",
              flush=True)

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


def main() -> int:
    import torch

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
        k1 = phase_k1(dev, rng)
        k2 = phase_k2(dev, rng)
        launches = phase_main_path(rng)
        phase_reference(rng)
        phase_timing(dev, rng)
        kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name], "launches": launches[name], **rec}
                   for name, rec in (("gram_matvec_sym", k1), ("gram_matvec_rect", k2))]
        check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
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
