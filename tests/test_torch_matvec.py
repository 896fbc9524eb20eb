"""The port's A·v operator against the JAX package's ``build_operator`` and
the numpy oracle, on the CPU (mirrors ``test_solver.py:57-95``).

Modes ``linear``, ``cached`` and ``implicit`` (the plain blocked version
here: the hand kernels run only on a CUDA device).  float64 throughout,
tolerance 1e-10; padding entries must stay exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu.ops import matvec as jmv
from plssvm_sparse_fp22_tpu.types import BackendType as JBackend
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu.utils import oracle
from plssvm_sparse_fp22_tpu_torch.ops import matvec as tmv
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

from utils import make_blobs

HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
CASES = [(KernelType.linear, "linear"), (KernelType.linear, "cached"),
         (KernelType.linear, "implicit"), (KernelType.polynomial, "cached"),
         (KernelType.polynomial, "implicit"), (KernelType.rbf, "cached"),
         (KernelType.rbf, "implicit")]


def _system(n=33, f=7, D=64, cost=2.0):
    X, _ = make_blobs(n, f, seed=0)
    dept = n - 1
    X_pad = np.zeros((D, f))
    X_pad[:dept] = X[:dept]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return X, X_pad, mask, dept, D, 1.0 / cost


@pytest.mark.parametrize("kernel,mode", CASES)
def test_operator_matches_jax_and_oracle(kernel, mode):
    X, X_pad, mask, dept, D, cost_inv = _system()
    jk = JKernel(int(kernel))
    q_short = oracle.generate_q(jk, X, **HYPER)
    q = np.zeros(D)
    q[:dept] = q_short
    QA = oracle.kernel_function(jk, X[-1], X[-1], **HYPER) + cost_inv
    v = np.zeros(D)
    v[:dept] = np.random.default_rng(1).normal(size=dept)

    jop = jmv.build_operator(jk, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask), QA,
                             cost_inv, mode=mode, row_block=32, backend=JBackend.xla, **HYPER)
    top = tmv.build_operator(kernel, torch.from_numpy(X_pad), torch.from_numpy(q),
                             torch.from_numpy(mask), QA, cost_inv, mode=mode, row_block=32,
                             backend=BackendType.torch, **HYPER)
    assert top.mode == jop.mode == mode
    got = top.matvec(torch.from_numpy(v)).numpy()
    want_jax = np.asarray(jop.matvec(jnp.asarray(v)))
    want = oracle.implicit_matvec(jk, X, q_short, QA, cost_inv, v[:dept], **HYPER)
    np.testing.assert_allclose(got, want_jax, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[:dept], want, rtol=1e-10, atol=1e-10)
    # padding stays exactly zero (the invariant CG relies on)
    np.testing.assert_array_equal(got[dept:], np.zeros(D - dept))


@pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
def test_linear_mode_rejects_nonlinear_kernels(kernel):
    X, X_pad, mask, _, D, cost_inv = _system()
    with pytest.raises(ValueError, match="requires the linear kernel"):
        tmv.build_operator(kernel, torch.from_numpy(X_pad), torch.zeros(D, dtype=torch.float64),
                           torch.from_numpy(mask), 1.0, cost_inv, mode="linear")


@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial, KernelType.rbf])
def test_jacobi_minv_matches_jax(kernel):
    X, X_pad, mask, dept, D, cost_inv = _system()
    jk = JKernel(int(kernel))
    q = np.zeros(D)
    q[:dept] = oracle.generate_q(jk, X, **HYPER)
    QA = oracle.kernel_function(jk, X[-1], X[-1], **HYPER) + cost_inv
    want = np.asarray(jmv.jacobi_minv(jk, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask),
                                      QA, cost_inv, HYPER["degree"], HYPER["gamma"],
                                      HYPER["coef0"]))
    got = tmv.jacobi_minv(kernel, torch.from_numpy(X_pad), torch.from_numpy(q),
                          torch.from_numpy(mask), QA, cost_inv, HYPER["degree"],
                          HYPER["gamma"], HYPER["coef0"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[dept:], np.zeros(D - dept))


# (kernel, dept, dtype, features, port backend, JAX backend, K-cache budget)
MODE_CASES = [
    (KernelType.linear, 100, np.float32, 8, BackendType.cuda, JBackend.pallas, None),
    (KernelType.rbf, 100, np.float32, 256, BackendType.cuda, JBackend.pallas, None),
    (KernelType.rbf, 100, np.float32, 400, BackendType.cuda, JBackend.pallas, None),
    (KernelType.rbf, 100, np.float64, 256, BackendType.cuda, JBackend.pallas, None),
    (KernelType.rbf, 100, np.float64, 256, BackendType.cuda, JBackend.pallas, "1000"),
    (KernelType.polynomial, 100, np.float32, 256, BackendType.torch, JBackend.xla, None),
    (KernelType.polynomial, 100, np.float32, 256, BackendType.torch, JBackend.xla, "1000"),
]


@pytest.mark.parametrize("case", MODE_CASES)
def test_choose_mode_matches_jax(case, monkeypatch):
    """The policy keeps the JAX package's shape: cuda plays pallas, torch
    plays xla; the 320-feature cutoff and the K-cache budget decide."""
    kernel, dept, np_dtype, f, tb, jb, budget = case
    if budget is not None:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", budget)
    t_dtype = torch.float32 if np_dtype == np.float32 else torch.float64
    want = jmv.choose_mode(JKernel(int(kernel)), dept, np_dtype, num_features=f, backend=jb)
    assert tmv.choose_mode(kernel, dept, t_dtype, num_features=f, backend=tb) == want


def test_symmetric_off_halves_the_implicit_cutoff(monkeypatch):
    monkeypatch.setenv("PLSSVM_PALLAS_SYMMETRIC", "0")
    assert tmv._implicit_feature_cutoff() == jmv._implicit_feature_cutoff() == 160
