"""The port's kernel functions against the JAX package's, on the CPU.

Same seeded numpy inputs through ``plssvm_sparse_fp22_tpu.ops.kernel_functions``
and ``plssvm_sparse_fp22_tpu_torch.ops.kernel_functions``.  Tolerances are
those of ``test_solver.py:45``: 1e-12 in float64, 1e-5 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax import lax

from plssvm_sparse_fp22_tpu.ops import kernel_functions as jkf
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.ops import kernel_functions as tkf
from plssvm_sparse_fp22_tpu_torch.types import KernelType

from utils import make_blobs

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]


def _both(a, np_dtype, t_dtype):
    a = np.asarray(a, np_dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("np_dtype,t_dtype,tol", DTYPES)
def test_gram_block_matches_jax(kernel, np_dtype, t_dtype, tol):
    X, _ = make_blobs(20, 5)
    Xi_j, Xi_t = _both(X[:12], np_dtype, t_dtype)
    Xj_j, Xj_t = _both(X, np_dtype, t_dtype)
    want = np.asarray(jkf.gram_block(JKernel(int(kernel)), Xi_j, Xj_j, **HYPER))
    got = tkf.gram_block(kernel, Xi_t, Xj_t, **HYPER).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("np_dtype,t_dtype,tol", DTYPES)
def test_kernel_scalar_matches_jax(kernel, np_dtype, t_dtype, tol):
    X, _ = make_blobs(4, 6)
    a_j, a_t = _both(X[0], np_dtype, t_dtype)
    b_j, b_t = _both(X[1], np_dtype, t_dtype)
    want = float(jkf.kernel_scalar(JKernel(int(kernel)), a_j, b_j, **HYPER))
    got = float(tkf.kernel_scalar(kernel, a_t, b_t, **HYPER))
    assert got == pytest.approx(want, rel=tol, abs=tol)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("np_dtype,t_dtype,tol", DTYPES)
def test_kernel_diag_matches_jax(kernel, np_dtype, t_dtype, tol):
    X, _ = make_blobs(16, 7)
    sq = np.sum(X * X, axis=1)
    sq_j, sq_t = _both(sq, np_dtype, t_dtype)
    want = np.asarray(jkf.kernel_diag(JKernel(int(kernel)), sq_j, **HYPER))
    got = tkf.kernel_diag(kernel, sq_t, **HYPER).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", KERNELS)
def test_gram_matrix_is_gram_block_of_all_rows(kernel):
    X, _ = make_blobs(9, 4)
    Xt = torch.from_numpy(X)
    torch.testing.assert_close(tkf.gram_matrix(kernel, Xt, **HYPER),
                               tkf.gram_block(kernel, Xt, Xt, **HYPER), rtol=0, atol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5, 7])
def test_integer_pow_is_bitwise_lax_integer_pow(degree):
    """Binary exponentiation in lax.integer_pow's order: equal bits in
    float32, not merely close."""
    base = np.random.default_rng(degree).normal(size=257).astype(np.float32) * 1.7
    want = np.asarray(lax.integer_pow(jnp.asarray(base), degree))
    got = tkf.integer_pow(torch.from_numpy(base), degree).numpy()
    np.testing.assert_array_equal(got, want)


def test_float32_products_are_exact_not_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
