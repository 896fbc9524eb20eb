"""float64 learns route around the hand kernels as the JAX package routes
them around Pallas.

The kernels are float32 only.  The JAX package sends float64 to exact
products outside Pallas: the blocked ``lax.map`` implicit
(``ops/matvec.py:248-258, 286-305``) and plain panel pairs
(``models/base.py:751-753``).  The port does the same through one predicate,
``ops/matvec.uses_kernels``: on the ``cuda`` backend float64 runs the plain
blocked product on the card instead of raising.  Here, on the CPU:

- the predicate for every backend x dtype pair;
- the panel plan on a faked ``cuda`` backend: plain pairs at float64, the
  kernels at float32, on one device and on the panel ring;
- a float64 rbf and polynomial learn forced to ``implicit`` by a small
  ``PLSSVM_K_CACHE_BYTES``, over several row blocks, against the JAX
  package's float64 blocked implicit (``backend=xla``, x64 on as
  ``tests/conftest.py`` sets it): equal iterations, alphas and bias to 1e-9
  at eps 1e-3, as ``tests/test_torch_model.py`` holds float64 early stops.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops.matvec import uses_kernels
from plssvm_sparse_fp22_tpu_torch.types import BackendType

from utils import make_blobs


@pytest.mark.parametrize("backend", list(BackendType))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_predicate(backend, dtype):
    """The kernels for ``cuda`` at float32 only (``use_pallas_impl``:
    ``pallas`` and not float64 on the TPU); everything else the plain
    product."""
    assert uses_kernels(backend, dtype) is (backend == BackendType.cuda
                                            and dtype == torch.float32)


def _sparse_params(dtype):
    rng = np.random.default_rng(61)
    csr = sp.random(128, 64, density=0.1, format="csr", random_state=rng)
    y = np.where(rng.random(128) < 0.5, 1.0, -1.0)
    p = tp.Parameter(kernel=tp.KernelType.rbf, dtype=dtype, devices=1, print_info=False,
                     backend=BackendType.torch, gamma=1.0 / 64)
    p.data = TParsed(csr=csr, values=y)
    p.values = y
    return csr, p


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("dtype,use_cuda", [(np.float64, False), (np.float32, True)])
def test_panel_plan_on_cuda_follows_the_predicate(monkeypatch, ndev, dtype, use_cuda):
    """On a ``cuda`` backend (faked: the CSVM is built on the CPU, then its
    backend is switched) the panel plan returns ``use_cuda`` False for
    float64, so its pairs run the plain product, and raises nothing."""
    monkeypatch.setattr(tp.CSVM, "_device_memory_bytes", lambda self: 80 << 30)
    csr, p = _sparse_params(dtype)
    svm = tp.CSVM(p)
    svm.backend = BackendType.cuda
    plan = svm._plan_sparse_panel(csr, 127, 128, ndev=ndev)
    assert plan is not None and plan[1] is use_cuda


def _learn(pkg, X, y, kernel, backend):
    mod, Parsed = (jp, JParsed) if pkg == "jax" else (tp, TParsed)
    p = mod.Parameter(kernel=mod.KernelType(int(kernel)), coef0=1.0, epsilon=1e-3,
                      max_iter=200, dtype=np.float64, devices=1, print_info=False,
                      backend=backend, gamma=1.0 / X.shape[1])
    p.data = Parsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = mod.make_csvm(p)
    svm.learn()
    return svm


@pytest.mark.parametrize("kernel", [tp.KernelType.polynomial, tp.KernelType.rbf])
def test_float64_implicit_learn_matches_jax_blocked_implicit(kernel, monkeypatch):
    """600 points pad to 768 rows: three row blocks of the blocked product
    in both packages.  No kernel launches on the CPU; the counters stay 0."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(600, 16, seed=7)
    gm.reset_launches()
    j = _learn("jax", X, y, kernel, jp.BackendType.xla)
    t = _learn("torch", X, y, kernel, BackendType.torch)
    ji, ti = j.last_cg_info, t.last_cg_info
    assert ti["mode"] == ji["mode"] == "implicit"
    assert (ti["dept"], ti["padded"]) == (ji["dept"], ji["padded"]) == (599, 768)
    assert ti["iterations"] == ji["iterations"] > 0
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9,
                               atol=1e-9 * np.abs(j.alphas).max())
    assert t.bias_ == pytest.approx(j.bias_, abs=1e-9 * t.QA_cost_ * np.abs(j.alphas).sum())
    assert not any(gm.launches.values())
