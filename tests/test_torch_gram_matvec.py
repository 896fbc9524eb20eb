"""K1 and K2 on the CPU: the plain PyTorch versions, and the wrappers that
dispatch to them for CPU tensors (K3's too), against the JAX package's
Pallas kernels and the numpy oracle; and the kernel build's source list.

The Pallas kernels run as ``tests/test_solver.py:98-145`` runs them:
``interpret=True`` with ``precision=lax.Precision.HIGHEST``, the exact tier
(the Pallas default is the bf16x3 tier; the port's bf16 tiers are held
against the JAX package in ``test_torch_precision.py``).
Tolerance: ``max|got - want| <= 1e-5 * max|want|``, the exact-tier budget of
``test_solver.py:133-134``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax import lax

from plssvm_sparse_fp22_tpu.ops.pallas_matvec import gram_matvec_pallas, gram_matvec_pallas_sym
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu.utils import oracle
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
TOL = 1e-5


def _assert_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def _data(D, f, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(D, f)).astype(np.float32), rng.normal(size=D).astype(np.float32)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(64, 7), (96, 33), (40, 5)])
def test_k1_plain_matches_pallas_sym_and_oracle(kernel, shape):
    X, v = _data(*shape, seed=3)
    want = np.asarray(gram_matvec_pallas_sym(
        JKernel(int(kernel)), jnp.asarray(X), jnp.asarray(v), bm=32, bk=128,
        interpret=True, precision=lax.Precision.HIGHEST, **HYPER))
    got = gm.gram_matvec_sym_plain(kernel, torch.from_numpy(X), torch.from_numpy(v), **HYPER)
    assert got.dtype == torch.float32
    _assert_close(got, want)
    oracle_want = oracle.kernel_matrix(JKernel(int(kernel)), X, X, **HYPER) @ v.astype(np.float64)
    _assert_close(got, oracle_want)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 24, 70), (40, 5, 96), (96, 33, 64)])
def test_k2_plain_matches_pallas_and_oracle(kernel, shape):
    """Shapes are (points, features, support vectors); (1, ...) is a
    one-row predict."""
    D, f, N = shape
    rng = np.random.default_rng(4)
    P = rng.normal(size=(D, f)).astype(np.float32)
    Y = rng.normal(size=(N, f)).astype(np.float32)
    a = rng.normal(size=N).astype(np.float32)
    want = np.asarray(gram_matvec_pallas(
        JKernel(int(kernel)), jnp.asarray(P), jnp.asarray(a), Y=jnp.asarray(Y),
        interpret=True, precision=lax.Precision.HIGHEST, **HYPER))
    got = gm.gram_matvec_plain(kernel, torch.from_numpy(P), torch.from_numpy(a),
                               Y=torch.from_numpy(Y), **HYPER)
    _assert_close(got, want)
    _assert_close(got, oracle.kernel_matrix(JKernel(int(kernel)), P, Y, **HYPER)
                  @ a.astype(np.float64))


@pytest.mark.parametrize("row_block", [1, 7, 256])
def test_plain_blocking_does_not_change_the_result(row_block):
    X, v = _data(50, 9, seed=5)
    Xt, vt = torch.from_numpy(X).double(), torch.from_numpy(v).double()
    full = gm.gram_matvec_plain(KernelType.rbf, Xt, vt, row_block=50, **HYPER)
    got = gm.gram_matvec_plain(KernelType.rbf, Xt, vt, row_block=row_block, **HYPER)
    torch.testing.assert_close(got, full, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_run_the_plain_version_on_cpu_tensors(kernel):
    """On CPU tensors the wrappers take the plain versions and launch
    nothing: every launch counter stays at 0."""
    X, v = _data(70, 6, seed=6)
    Xt, vt = torch.from_numpy(X), torch.from_numpy(v)
    gm.reset_launches()
    sym = gm.make_sym_matvec(kernel, Xt, **HYPER)(vt)
    rect = gm.gram_matvec(kernel, Xt[:9], vt, Y=Xt, **HYPER)
    pair = gm.pair_gram_contrib(kernel, Xt[:9], Xt, vt[:9], vt, same=False, **HYPER)
    assert not any(gm.launches.values())
    torch.testing.assert_close(pair[0], rect, rtol=0, atol=0)
    torch.testing.assert_close(sym, gm.gram_matvec_sym_plain(kernel, Xt, vt, **HYPER),
                               rtol=0, atol=0)
    torch.testing.assert_close(rect, gm.gram_matvec_plain(kernel, Xt[:9], vt, Y=Xt, **HYPER),
                               rtol=0, atol=0)


def test_cuda_backend_on_cpu_tensors_raises():
    X, _ = _data(8, 3, seed=7)
    Xt = torch.from_numpy(X)
    mask = torch.ones(8)
    with pytest.raises(PLSSVMError, match="backend 'cuda' needs the system on a CUDA device"):
        build_operator(KernelType.rbf, Xt, torch.zeros(8), mask, 1.0, 1.0,
                       mode="implicit", backend=BackendType.cuda)
    assert not any(gm.launches.values())


def test_build_covers_every_source_and_header(tmp_path, monkeypatch):
    """``ops/_build.py`` compiles every ``csrc/*.cu`` and rebuilds when any
    source or header changes: both enter the hash."""
    import shutil

    from plssvm_sparse_fp22_tpu_torch.ops import _build

    assert [os.path.basename(p) for p in _build.sources()] == ["cg_chunk.cu", "gram_matvec.cu",
                                                               "pair_contrib.cu", "sparse_gram.cu",
                                                               "split_bf16.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build._source_hash()
    with open(csrc / "gram_tile.cuh", "a") as fh:
        fh.write("// touched\n")
    assert _build._source_hash() != before
    (csrc / "extra.cu").write_text("// another kernel source\n")
    assert [os.path.basename(p) for p in _build.sources()] == ["cg_chunk.cu", "extra.cu",
                                                               "gram_matvec.cu", "pair_contrib.cu",
                                                               "sparse_gram.cu", "split_bf16.cu"]


#: a process that builds into the directory ``argv[1]`` and prints what came of it
_BUILD_PROBE = """
import json, os, sys
from plssvm_sparse_fp22_tpu_torch.exceptions import BackendError
from plssvm_sparse_fp22_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
_build.LIBRARY = os.path.join(sys.argv[1], "libgram_matvec.so")
_build._STAMP = _build.LIBRARY + ".sha256"
try:
    print(json.dumps({"cached": _build.build()["cached"]}))
except BackendError as exc:
    print(json.dumps({"error": str(exc)}))
"""

#: an ``nvcc`` that writes its output file after a second and logs the call
_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/calls.log"
sleep 1
while [ "$#" -gt 0 ]; do
    if [ "$1" = "-o" ]; then out="$2"; fi
    shift
done
echo built > "$out"
"""


def _build_twice_at_once(build_dir, cuda_home):
    """Two processes that call ``build()`` at the same time; their results."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_HOME": str(cuda_home),
           "PATH": os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                                   if not os.path.exists(os.path.join(p, "nvcc")))}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE, str(build_dir)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [proc.communicate(timeout=120) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_two_processes_without_nvcc_both_fail_cleanly(tmp_path):
    """With no ``nvcc`` both builds raise, one after the other under the
    file lock, and leave no library, stamp or object behind."""
    build_dir = tmp_path / "_build"
    results = _build_twice_at_once(build_dir, tmp_path / "no_cuda")
    assert all("nvcc not found" in r.get("error", "") for r in results), results
    assert sorted(os.listdir(build_dir)) == ["lock"]


def test_two_processes_build_once(tmp_path):
    """Two processes that reach the build at once on a fresh tree: the file
    lock lets one run ``nvcc`` (once per source, then the link) and the
    other finds that build."""
    from plssvm_sparse_fp22_tpu_torch.ops import _build

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text(_FAKE_NVCC)
    (bin_dir / "nvcc").chmod(0o755)
    build_dir = tmp_path / "_build"
    results = _build_twice_at_once(build_dir, tmp_path / "cuda")
    assert sorted(r["cached"] for r in results) == [False, True], results
    calls = (bin_dir / "calls.log").read_text().splitlines()
    assert len(calls) == len(_build.sources()) + 1  # every source, then the link
    assert sorted(os.listdir(build_dir)) == ["libgram_matvec.so", "libgram_matvec.so.sha256",
                                             "lock"]
