"""The port's numpy oracle equals the JAX package's on the same inputs."""

import numpy as np
import pytest

from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu.utils import oracle as joracle

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.types import KernelType
from plssvm_sparse_fp22_tpu_torch.utils import oracle

from utils import make_blobs

KERNELS = list(KernelType)
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
TOL = 1e-12


def _data(seed=3, n=41, f=7):
    return make_blobs(n, f, seed=seed)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_function(kernel):
    X, _ = _data()
    for i, j in [(0, 1), (5, 5), (40, 2)]:
        got = oracle.kernel_function(kernel, X[i], X[j], **HYPER)
        want = joracle.kernel_function(JKernel(int(kernel)), X[i], X[j], **HYPER)
        assert got == pytest.approx(want, rel=TOL, abs=TOL)
    with pytest.raises(ValueError, match="unknown kernel"):
        oracle.kernel_function(7, X[0], X[1])


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matrix_and_generate_q(kernel):
    X, _ = _data()
    Y, _ = _data(seed=4, n=13)
    np.testing.assert_allclose(oracle.kernel_matrix(kernel, X, Y, **HYPER),
                               joracle.kernel_matrix(JKernel(int(kernel)), X, Y, **HYPER),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(oracle.generate_q(kernel, X, **HYPER),
                               joracle.generate_q(JKernel(int(kernel)), X, **HYPER),
                               rtol=TOL, atol=TOL)
    # the matrix holds the scalar kernel
    K = oracle.kernel_matrix(kernel, X, Y, **HYPER)
    assert K[3, 5] == pytest.approx(oracle.kernel_function(kernel, X[3], Y[5], **HYPER),
                                    rel=1e-10)


@pytest.mark.parametrize("kernel", KERNELS)
def test_implicit_matvec(kernel):
    X, _ = _data()
    rng = np.random.default_rng(0)
    v = rng.normal(size=len(X) - 1)
    q = oracle.generate_q(kernel, X, **HYPER)
    QA = oracle.kernel_function(kernel, X[-1], X[-1], **HYPER) + 0.5
    got = oracle.implicit_matvec(kernel, X, q, QA, 0.5, v, **HYPER)
    want = joracle.implicit_matvec(JKernel(int(kernel)), X, q, QA, 0.5, v, **HYPER)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # against the explicit matrix A_ij = K_ij + QA - q_i - q_j + delta_ij / C
    K = oracle.kernel_matrix(kernel, X[:-1], X[:-1], **HYPER)
    A = K + QA - q[:, None] - q[None, :] + 0.5 * np.eye(len(v))
    np.testing.assert_allclose(got, A @ v, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("max_iter", [None, 3])
def test_solve_lssvm(kernel, max_iter):
    X, y = _data()
    kw = dict(cost=2.0, epsilon=1e-8, max_iter=max_iter, **HYPER)
    alpha, bias, info = oracle.solve_lssvm(X, y, kernel=kernel, **kw)
    jalpha, jbias, jinfo = joracle.solve_lssvm(X, y, kernel=JKernel(int(kernel)), **kw)
    assert info["iterations"] == jinfo["iterations"]
    np.testing.assert_allclose(alpha, jalpha, rtol=TOL, atol=TOL)
    assert bias == pytest.approx(jbias, rel=TOL, abs=TOL)
    np.testing.assert_allclose(info["residuals"], jinfo["residuals"], rtol=TOL, atol=TOL)
    assert alpha.sum() == pytest.approx(0.0, abs=1e-9)  # alpha_last = -sum(x)


@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_values(kernel):
    X, y = _data()
    P, _ = _data(seed=9, n=11)
    alpha, bias, _ = oracle.solve_lssvm(X, y, kernel=kernel, epsilon=1e-8, **HYPER)
    got = oracle.predict_values(X, alpha, bias, P, kernel=kernel, **HYPER)
    want = joracle.predict_values(X, alpha, bias, P, kernel=JKernel(int(kernel)), **HYPER)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got.shape == (11,)
