"""The port on the JAX package's self-contained golden fixtures
(``tests/data/120x16.*``; mirrors ``test_golden.py``): training reproduces
the golden models, prediction the golden labels, and the written model
header matches byte for byte apart from rho's last digits."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.io.libsvm import parse_libsvm_file
from plssvm_sparse_fp22_tpu_torch.io.model import parse_model_file
from plssvm_sparse_fp22_tpu_torch.models import make_csvm
from plssvm_sparse_fp22_tpu_torch.params import Parameter
from plssvm_sparse_fp22_tpu_torch.types import KernelType
from test_torch_model import cg_bias_tolerance, cg_residual

DATA = os.path.join(os.path.dirname(__file__), "data")
HYPER = {"degree": 3, "gamma": 0.125, "coef0": 1.0}
KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]


def _train_fixture(kernel):
    parsed = parse_libsvm_file(os.path.join(DATA, "120x16.libsvm"))
    params = Parameter(kernel=kernel, cost=2.0, epsilon=1e-8, max_iter=200,
                       print_info=False, dtype=np.float64, **HYPER)
    params.data, params.values = parsed, parsed.values
    svm = make_csvm(params)
    svm.learn()
    return svm


@pytest.mark.parametrize("kernel", KERNELS)
def test_learn_matches_golden_model(kernel, tmp_path):
    """The alphas to the tolerances of test_golden.py:40-47.  The bias to
    the tolerance CG's stopping rule allows (``cg_bias_tolerance``): at eps
    1e-8 from x0 = 1 the residual left along the bias's sensitive direction
    allows the polynomial system's bias to move by 2e-3 of its value, and a
    change of summation order in any one reduction (the K·v product, the CG
    dots, the corrections' sums) moves it by 1e-4 to 2e-4 (measured), past
    an rtol of 1e-4."""
    svm = _train_fixture(kernel)
    golden = parse_model_file(os.path.join(DATA, f"120x16.{kernel.name}.model"))
    y = np.asarray(svm.values)
    X = parse_libsvm_file(os.path.join(DATA, "120x16.libsvm")).dense
    pos = int(np.sum(y > 0))
    golden_alphas = np.empty_like(svm.alphas)  # the model lists y > 0 first
    golden_alphas[y > 0] = golden.support_vectors.values[:pos]
    golden_alphas[y < 0] = golden.support_vectors.values[pos:]
    assert cg_residual(X, y, kernel, 2.0, svm.alphas, **HYPER) <= \
        1.01 * 1e-8 * np.sqrt(svm.last_cg_info["delta0"])
    btol = cg_bias_tolerance(X, y, kernel, 2.0, [svm.alphas, golden_alphas], np.float64,
                             **HYPER)
    assert abs(-svm.bias_ - golden.rho) <= btol
    if kernel != KernelType.polynomial:
        # the derived bound is tighter than the inherited rtol of 1e-4 here:
        # 1e-8 of |rho| (linear) and 3e-5 (rbf); only the polynomial system's
        # conditioning makes it looser (4e-3)
        assert btol <= 1e-4 * abs(golden.rho)
    reordered = np.concatenate([svm.alphas[y > 0], svm.alphas[y < 0]])
    np.testing.assert_allclose(reordered, golden.support_vectors.values, rtol=1e-4, atol=1e-6)

    out = tmp_path / "model"
    svm.write_model(str(out))
    strip = lambda h: [ln for ln in h.split("SV\n")[0].splitlines()  # noqa: E731
                       if not ln.startswith("rho ")]
    want = open(os.path.join(DATA, f"120x16.{kernel.name}.model")).read()
    assert strip(out.read_text()) == strip(want)


@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_matches_golden_labels(kernel):
    svm = _train_fixture(kernel)
    test = parse_libsvm_file(os.path.join(DATA, "40x16.test.libsvm"))
    golden = np.loadtxt(os.path.join(DATA, f"40x16.{kernel.name}.predict"))
    np.testing.assert_array_equal(svm.predict_label(test.dense), golden)
    np.testing.assert_array_equal(svm.predict_label_parsed(test), golden)


@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_from_golden_model_file(kernel):
    golden = parse_model_file(os.path.join(DATA, f"120x16.{kernel.name}.model"))
    params = Parameter(kernel=kernel, print_info=False, dtype=np.float64, **HYPER)
    params.data = golden.support_vectors
    params.values = golden.labels
    params.alphas = golden.support_vectors.values
    params.rho = golden.rho
    svm = make_csvm(params)
    test = parse_libsvm_file(os.path.join(DATA, "40x16.test.libsvm"))
    want = np.loadtxt(os.path.join(DATA, f"40x16.{kernel.name}.predict"))
    np.testing.assert_array_equal(svm.predict_label(test.dense), want)
