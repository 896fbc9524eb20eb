"""The whole slice: the port's CSVM against the JAX package's, on the CPU.

The same seeded dense data goes through ``make_csvm(...).learn()`` of both
packages; predictions on a seeded test set give the same labels, and error
messages match the JAX package's for the cases of ``test_model_api.py``.

Tolerances and why.  CG starts from x0 = 1, so delta0 is ~1e8 times the
final residual's scale, and the reduced LS-SVM system has one outlier
eigenvalue (the rank-1 ``QA_cost - q_i - q_j`` part).  CG then amplifies the
two packages' different summation orders (numpy/torch BLAS vs XLA) by up
to 1e7 within a few iterations, and more in float32 — measured on these
systems, and the JAX package differs from the numpy oracle the same way.
So the tests hold:

- float64, early stop (eps 1e-3, 2-3 iterations): equal iterations,
  alphas and bias to rtol 1e-9 (measured <= 2e-11);
- float64, converged (eps 1e-10): iterations within one, alphas to 1e-7 of
  their scale (measured <= 1e-8) and to 1e-5 of the exact KKT solution
  (measured <= 1e-6);
- float32 (eps 1e-6): rbf to iterations within one and alphas to 1e-3 of
  their scale (measured <= 7e-5); the linear and polynomial systems are
  worse conditioned, and there float32 CG moves the alphas by up to 5e-3 of
  their scale and the count by two (measured), so they are held to 1e-2
  and three iterations, and to equal labels.  The bias is held to
  :func:`cg_bias_tolerance`, derived from the stopping rule: CG stops with a
  residual, not at the solution, and the bias is sensitive to that residual
  along one direction (measured on the polynomial system: the two
  packages' biases differ by 8.5e-4, 1.7e-2 of the alphas' scale, within a
  derived bound of 1.2e-2).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.exceptions import PLSSVMError as JError
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError as TError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

from utils import make_blobs

PKGS = {"jax": (jp, JParsed, JError), "torch": (tp, TParsed, TError)}


def _params(pkg, X, y=None, alphas=None, **kw):
    """A Parameter of package ``pkg`` over dense arrays (one device)."""
    mod, Parsed, _ = PKGS[pkg]
    X = np.asarray(X, np.float64)
    kw.setdefault("dtype", np.float64)
    if "kernel" in kw:
        kw["kernel"] = mod.KernelType(int(kw["kernel"]))
    p = mod.Parameter(devices=1, print_info=False, **kw)
    p.data = Parsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = None if y is None else np.asarray(y, np.float64)
    if alphas is not None:
        p.alphas = np.asarray(alphas, np.float64)
    if p.gamma == 0.0:
        p.gamma = 1.0 / X.shape[1]
    return p


def _learn(pkg, X, y, **kw):
    svm = PKGS[pkg][0].make_csvm(_params(pkg, X, y, **kw))
    svm.learn()
    return svm


KERNELS = [tp.KernelType.linear, tp.KernelType.polynomial, tp.KernelType.rbf]
# (kernel, force implicit mode through a tiny K-cache budget)
LEARN_CASES = [(k, False) for k in KERNELS] + [(tp.KernelType.polynomial, True),
                                               (tp.KernelType.rbf, True)]


N, F = 80, 40


def _expected_mode(kernel, implicit):
    if kernel == tp.KernelType.linear:
        return "linear"
    return "implicit" if implicit else "cached"


def _reduced_system(X, y, kernel, cost, **hyper):
    """The reduced CG system of ``csvm.cpp:207-267`` in float64, from the
    numpy oracle: ``A``, ``b``, ``q`` and ``QA_cost``."""
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
    from plssvm_sparse_fp22_tpu.utils import oracle

    K = oracle.kernel_matrix(JKernel(int(kernel)), X, X, **hyper)
    y = np.asarray(y, np.float64)
    d = len(y) - 1
    q = K[:d, -1]
    QA = K[-1, -1] + 1.0 / cost
    A = K[:d, :d] + QA - q[:, None] - q[None, :] + np.eye(d) / cost
    return A, y[:d] - y[-1], q, QA


def cg_residual(X, y, kernel, cost, alphas, **hyper):
    """|b - A x| of a trained model's alphas (x = alphas[:-1]) on the exact
    reduced system: the residual the CG stopping rule bounds by
    eps * sqrt(delta0)."""
    A, b, _, _ = _reduced_system(X, y, kernel, cost, **hyper)
    return float(np.linalg.norm(b - A @ np.asarray(alphas)[:-1]))


def cg_bias_tolerance(X, y, kernel, cost, alphas_list, dtype, **hyper):
    """How far apart the biases of CG results may lie, derived from their
    stopping residuals.  The bias is ``y_last + QA_cost * sum(x) - q.x``, linear
    in x with gradient ``g = QA_cost * 1 - q``, and a result with residual
    ``r = b - A x`` sits at ``x* + A^-1 r``; so its bias is off the exact one
    by ``g.A^-1 r``, at most ``|A^-1 g| |r|``.  Each result adds that and the
    rounding of the bias's own sums, ``d * eps_dtype * (|y_last| +
    QA_cost * sum|x| + sum|q x|)``."""
    A, b, q, QA = _reduced_system(X, y, kernel, cost, **hyper)
    w = np.linalg.norm(np.linalg.solve(A, QA - q))
    d, u = len(b), np.finfo(dtype).eps
    tol = 0.0
    for alphas in alphas_list:
        x = np.asarray(alphas)[:-1]
        tol += w * np.linalg.norm(b - A @ x)
        tol += d * u * (abs(y[-1]) + QA * np.abs(x).sum() + np.abs(q * x).sum())
    return tol


def _exact_solution(X, y, kernel, cost, **hyper):
    """alphas and bias of the full LS-SVM KKT system, solved directly:
    [[K + I/C, 1], [1^T, 0]] [alpha; bias] = [y; 0]."""
    from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
    from plssvm_sparse_fp22_tpu.utils import oracle

    n = len(y)
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = oracle.kernel_matrix(JKernel(int(kernel)), X, X, **hyper) + np.eye(n) / cost
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    return sol[:n], sol[n]


@pytest.mark.parametrize("kernel,implicit", LEARN_CASES)
def test_learn_float64_matches_jax(kernel, implicit, monkeypatch):
    if implicit:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(N, F, seed=3)
    kw = dict(kernel=kernel, coef0=1.0, epsilon=1e-3, max_iter=200)
    j, t = _learn("jax", X, y, **kw), _learn("torch", X, y, **kw)
    ji, ti = j.last_cg_info, t.last_cg_info
    assert ti["mode"] == ji["mode"] == _expected_mode(kernel, implicit)
    assert ti["iterations"] == ji["iterations"]
    assert (ti["dept"], ti["padded"]) == (ji["dept"], ji["padded"]) == (N - 1, 256)
    assert set(ti) == set(ji)
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9, atol=1e-9 * np.abs(j.alphas).max())
    # bias = y_last + QA_cost * sum(x) - q.x carries the sums' rounding times
    # QA_cost, so its scale is QA_cost * sum|alpha|
    btol = 1e-9 * t.QA_cost_ * np.abs(j.alphas).sum()
    assert t.bias_ == pytest.approx(j.bias_, abs=btol)
    P, _ = make_blobs(30, F, seed=4)
    np.testing.assert_allclose(t.predict(P), j.predict(P), rtol=1e-9, atol=btol)
    np.testing.assert_array_equal(t.predict_label(P), j.predict_label(P))


@pytest.mark.parametrize("kernel,implicit", LEARN_CASES)
def test_learn_float64_converged_matches_jax_and_exact_solution(kernel, implicit, monkeypatch):
    if implicit:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(N, F, seed=3)
    kw = dict(kernel=kernel, coef0=1.0, epsilon=1e-10, max_iter=500)
    j, t = _learn("jax", X, y, **kw), _learn("torch", X, y, **kw)
    assert t.last_cg_info["mode"] == _expected_mode(kernel, implicit)
    assert abs(t.last_cg_info["iterations"] - j.last_cg_info["iterations"]) <= 1
    alphas, bias = _exact_solution(X, y, kernel, 1.0, degree=3, gamma=1.0 / F, coef0=1.0)
    scale = np.abs(alphas).max()
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=0, atol=1e-7 * scale)
    np.testing.assert_allclose(t.alphas, alphas, rtol=0, atol=1e-5 * scale)
    assert t.bias_ == pytest.approx(bias, abs=1e-6)


@pytest.mark.parametrize("kernel,implicit", LEARN_CASES)
def test_learn_float32_matches_jax(kernel, implicit, monkeypatch):
    if implicit:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(N, F, seed=3)
    kw = dict(kernel=kernel, coef0=1.0, epsilon=1e-6, max_iter=500, dtype=np.float32)
    j, t = _learn("jax", X, y, **kw), _learn("torch", X, y, **kw)
    rbf = kernel == tp.KernelType.rbf
    assert t.last_cg_info["mode"] == j.last_cg_info["mode"] == _expected_mode(kernel, implicit)
    assert abs(t.last_cg_info["iterations"] - j.last_cg_info["iterations"]) <= (1 if rbf else 3)
    scale = np.abs(j.alphas).max()
    tol = 1e-3 if rbf else 1e-2
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=0, atol=tol * scale)
    hyper = dict(degree=3, gamma=1.0 / F, coef0=1.0)
    # the port's residual obeys the stopping rule (2x for float32's drift
    # between the recursive and the true residual; measured <= 0.8x)
    info = t.last_cg_info
    assert cg_residual(X, y, kernel, 1.0, t.alphas, **hyper) <= \
        2 * 1e-6 * np.sqrt(info["delta0"])
    btol = cg_bias_tolerance(X, y, kernel, 1.0, [t.alphas, j.alphas], np.float32, **hyper)
    assert abs(t.bias_ - j.bias_) <= btol
    P, _ = make_blobs(30, F, seed=6)
    np.testing.assert_array_equal(t.predict_label(P), j.predict_label(P))


@pytest.mark.parametrize("kernel", KERNELS)
def test_jacobi_precond_matches_jax(kernel):
    X, y = make_blobs(N, F, seed=7)
    kw = dict(kernel=kernel, coef0=0.5, epsilon=1e-3, max_iter=200, precond="jacobi")
    j, t = _learn("jax", X, y, **kw), _learn("torch", X, y, **kw)
    assert t.last_cg_info["iterations"] == j.last_cg_info["iterations"]
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9, atol=1e-9 * np.abs(j.alphas).max())


@pytest.mark.parametrize("kernel", KERNELS)
def test_csvm_from_state_predicts_what_jax_predicts(kernel):
    X, y = make_blobs(50, 4, seed=8)
    j = _learn("jax", X, y, kernel=kernel, coef0=1.0, epsilon=1e-6, max_iter=100)
    state = {"kernel": int(j.kernel), "degree": j.degree, "gamma": j.gamma,
             "coef0": j.coef0, "alphas": j.alphas, "bias_": j.bias_,
             "support_vectors": j.data.dense, "values": j.values}
    t = tp.csvm_from_state(state, dtype=np.float64, print_info=False)
    P, _ = make_blobs(25, 4, seed=9)
    np.testing.assert_allclose(t.predict(P), j.predict(P), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(t.predict_label(P), j.predict_label(P))
    assert t.accuracy() == j.accuracy()


def test_single_point_system_matches_jax():
    X = np.array([[1.0, 2.0]])
    j, t = _learn("jax", X, [-1.0]), _learn("torch", X, [-1.0])
    np.testing.assert_array_equal(t.alphas, j.alphas)
    assert t.bias_ == j.bias_ == -1.0


# --- error messages: the cases of test_model_api.py, run through both packages


def _ctor_no_data(pkg):
    mod = PKGS[pkg][0]
    mod.CSVM(mod.Parameter())


def _ctor_empty(pkg):
    mod, Parsed, _ = PKGS[pkg]
    p = mod.Parameter()
    p.data = Parsed(csr=sp.csr_matrix((0, 4)), values=None)
    mod.CSVM(p)


def _ctor_no_features(pkg):
    mod, Parsed, _ = PKGS[pkg]
    p = mod.Parameter()
    p.data = Parsed(csr=sp.csr_matrix((3, 0)), values=None)
    mod.CSVM(p)


def _ctor_alpha_mismatch(pkg):
    PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)), alphas=np.ones(2)))


def _learn_no_labels(pkg):
    PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)))).learn()


def _learn_label_mismatch(pkg):
    svm = PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0])))
    svm.values = svm.values[:2]
    svm.learn()


def _write_before_learn(pkg, tmp_path):
    svm = PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0])))
    svm.write_model(str(tmp_path / f"{pkg}.model"))


def _predict_before_learn(pkg):
    svm = PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0])))
    svm.predict(np.ones((1, 2)))


def _predict_feature_mismatch(pkg):
    svm = PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0]),
                                    alphas=np.zeros(3)))
    svm.predict(np.ones((1, 5)))


def _accuracy_count_mismatch(pkg):
    X, y = make_blobs(10, 3)
    svm = PKGS[pkg][0].CSVM(_params(pkg, X, y=y, alphas=np.zeros(10)))
    svm.accuracy(np.zeros((2, 3)), np.zeros(3))


def _accuracy_no_labels(pkg):
    PKGS[pkg][0].CSVM(_params(pkg, np.ones((3, 2)))).accuracy()


ERROR_CASES = [_ctor_no_data, _ctor_empty, _ctor_no_features, _ctor_alpha_mismatch,
               _learn_no_labels, _learn_label_mismatch, _write_before_learn,
               _predict_before_learn, _predict_feature_mismatch, _accuracy_count_mismatch,
               _accuracy_no_labels]


@pytest.mark.parametrize("case", ERROR_CASES, ids=lambda c: c.__name__.strip("_"))
def test_error_messages_match_jax(case, tmp_path):
    msgs = {}
    for pkg in PKGS:
        args = (pkg, tmp_path) if case is _write_before_learn else (pkg,)
        with pytest.raises(PKGS[pkg][2]) as info:
            case(*args)
        msgs[pkg] = str(info.value)
    assert msgs["torch"] == msgs["jax"]


def test_accuracy_of_empty_points_is_zero():
    X, y = make_blobs(10, 3)
    svm = tp.CSVM(_params("torch", X, y=y, alphas=np.zeros(10)))
    assert svm.accuracy(np.zeros((0, 3)), np.zeros(0)) == 0.0


# --- what the slice does not carry raises, naming the missing piece


def test_sparse_data_raises_instead_of_densifying():
    """Sparse data no longer raises: it keeps its CSR form and trains on the
    sparse path, without densifying; sparse_threshold 0 forces the dense
    path."""
    X = np.zeros((10, 8))
    X[np.arange(10), np.arange(10) % 8] = 1.0  # density 1/8 <= 0.25
    y = np.where(np.arange(10) % 2, 1.0, -1.0)
    Parsed = PKGS["torch"][1]
    p = _params("torch", X, y=y)
    p.data = Parsed(csr=sp.csr_matrix(X), values=y)
    svm = tp.make_csvm(p)
    svm.learn()
    assert svm.last_cg_info["mode"] == "sparse_linear"
    assert svm.data._dense is None
    sparse_alphas = svm.alphas
    svm.params.sparse_threshold = 0.0
    svm.learn()
    assert svm.last_cg_info["mode"] == "linear"
    np.testing.assert_allclose(sparse_alphas, svm.alphas, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("flag", [{"checkpoint_path": "cg.npz"}, {"verbose_cg": True}])
def test_chunked_cg_flags_raise(flag, tmp_path):
    """The chunked CG loop serves dense learns only: sparse data refuses
    both flags by name, dense data trains with them."""
    if "checkpoint_path" in flag:
        flag = {"checkpoint_path": str(tmp_path / flag["checkpoint_path"])}
    X, y = make_blobs(12, 3)
    svm = tp.make_csvm(_params("torch", X, y=y, sparse_threshold=1.0, **flag))
    with pytest.raises(TError, match="not supported on the sparse learn path"):
        svm.learn()
    dense = tp.make_csvm(_params("torch", X, y=y, **flag))
    dense.learn()
    plain = _learn("torch", X, y)
    assert dense.last_cg_info["iterations"] == plain.last_cg_info["iterations"]
    np.testing.assert_allclose(dense.alphas, plain.alphas, rtol=1e-9, atol=1e-12)


def test_more_than_one_device_raises(monkeypatch):
    """More than one device: sparse data and the feature axis take their
    sharded learns under the JAX package's mode names and give the
    one-device result; an invalid device count still raises.  (The routes
    are held in ``test_torch_sparse_sharded.py`` and
    ``test_torch_feature_sharded.py``.)"""
    X, y = make_blobs(300, 3)
    p = _params("torch", X, y=y, sparse_threshold=1.0)
    one = tp.CSVM(p)
    one.learn()
    p.devices = 2
    svm = tp.CSVM(p)
    svm.learn()
    assert svm.last_cg_info["mode"] == "sharded_sparse_linear[2]"
    np.testing.assert_allclose(svm.alphas, one.alphas, rtol=1e-6, atol=1e-6)
    p.devices = None
    monkeypatch.setenv("PLSSVM_DEVICES", "2")
    svm = tp.CSVM(p)
    svm.learn()
    assert svm.last_cg_info["mode"] == "sharded_sparse_linear[2]"
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", "features")
    dense = _params("torch", X, y=y)
    dense.devices = None
    svm = tp.CSVM(dense)
    svm.learn()
    assert svm.last_cg_info["mode"] == "sharded_feature[2]"  # 3 features padded to 4
    np.testing.assert_allclose(svm.alphas, one.alphas, rtol=1e-6, atol=1e-6)
    monkeypatch.setenv("PLSSVM_DEVICES", "two")
    with pytest.raises(TError, match="Invalid device count"):
        tp.CSVM(dense)


def test_gpu_requests_without_a_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    X, y = make_blobs(12, 3)
    with pytest.raises(TError, match="no CUDA device is visible"):
        tp.CSVM(_params("torch", X, y=y, target=tp.TargetPlatform.gpu_nvidia))
    with pytest.raises(TError, match="Backend 'cuda' requested"):
        tp.CSVM(_params("torch", X, y=y, backend=tp.BackendType.cuda))
    svm = tp.CSVM(_params("torch", X, y=y))
    assert (svm.device.type, svm.backend) == ("cpu", tp.BackendType.torch)
    gm.reset_launches()
    svm.learn()
    svm.predict(X)
    assert not any(gm.launches.values())


def test_float32_state_and_dtype_resolution():
    X, y = make_blobs(20, 3)
    svm = tp.CSVM(_params("torch", X, y=y, dtype="float32"))
    assert svm.dtype == torch.float32
    with pytest.raises(TError, match="Unsupported real type"):
        tp.CSVM(_params("torch", X, y=y, dtype=np.int32))
