"""The port's feature-sharded learn on logical CPU shards.

Ports ``tests/test_parallel.py::test_feature_sharded_learn_matches_oracle``
and ``tests/test_sharded_api.py::TestFeatureShardedProduct`` (with
``devices=`` given: the port's CPU default is one device), then holds the
functions of ``parallel/sharded.py`` against the JAX package's on its 8
virtual devices: one A·v against the JAX package's one-device operator, the
learn on 2, 4 and 8 shards against the JAX package's feature-sharded learn,
two runs bitwise equal, set-up plus chunks equal to the one-shot learn, a
resumed learn equal to the uninterrupted one, and a checkpoint of the JAX
package's feature-sharded learn resumed in the port.

Tolerances: as the ported tests (1e-4 per alpha, 5e-3 on the sums; 5e-3 on
the ill-conditioned polynomial system against the oracle); one A·v, the same
sums in another order, 1e-10 of its scale; bit for bit where the arithmetic
is the same.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu.ops.kernel_functions import (gram_block as jax_gram_block,
                                                       kernel_scalar as jax_kernel_scalar)
from plssvm_sparse_fp22_tpu.ops.matvec import build_operator as jax_build_operator
from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plssvm_sparse_fp22_tpu.parallel.sharded import (
    make_feature_sharded_learn as jax_feature_learn,
    shard_system_feature as jax_shard_system_feature)
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
from plssvm_sparse_fp22_tpu_torch.parallel import sharded
from plssvm_sparse_fp22_tpu_torch.parallel.mesh import make_mesh
from plssvm_sparse_fp22_tpu_torch.solver.checkpoint import load_cg_checkpoint
from plssvm_sparse_fp22_tpu_torch.types import KernelType
from plssvm_sparse_fp22_tpu_torch.utils import oracle

from utils import make_blobs

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
COST = 2.0


def _padded(n=97, f=16, D=128, seed=5):
    X, y = make_blobs(n, f, seed=seed)
    dept = n - 1
    X_pad = np.zeros((D, f))
    X_pad[:dept] = X[:dept]
    b_pad = np.zeros(D)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return X, y, X_pad, b_pad, mask, dept


def _port_learn(kernel, ndev, system, eps, imax, precond="none"):
    X, y, X_pad, b_pad, mask, dept = system
    mesh = make_mesh(ndev, devices=["cpu"])
    learn = sharded.make_feature_sharded_learn(mesh, kernel, HYPER["degree"], precond=precond)
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)
    return learn(Xs, xls, b, m, HYPER["gamma"], HYPER["coef0"], COST, eps, imax)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("ndev", [2, 4])
def test_feature_sharded_learn_matches_oracle(kernel, ndev):
    """The feature axis split across devices with the partial Gram products
    reduced (``feature_ranges_``, ``gpu_csvm.cpp:130-157``), all three
    kernels, against the numpy oracle."""
    system = _padded()
    X, y, X_pad, b_pad, mask, dept = system
    eps, imax = 1e-6, 60
    x, s, t, QA, iters, delta, delta0 = _port_learn(kernel, ndev, system, eps, imax)
    alpha_ref, bias_ref, info = oracle.solve_lssvm(X, y, kernel=kernel, cost=COST, epsilon=eps,
                                                   max_iter=imax, **HYPER)
    assert float(delta) <= eps * eps * float(delta0) or iters == imax
    tol = 5e-3 if kernel == KernelType.polynomial else 1e-4
    np.testing.assert_allclose(x.numpy()[:dept], alpha_ref[:dept], rtol=tol, atol=tol)
    bias = float(y[-1]) + float(QA) * float(s) - float(t)
    assert bias == pytest.approx(bias_ref, rel=5e-3, abs=5e-3)
    assert not x[dept:].any()


# ---------------------------------------------------------------------------
# the product surface (tests/test_sharded_api.py::TestFeatureShardedProduct)
# ---------------------------------------------------------------------------

def _train(X, y, kernel, pkg=tp, parsed=ParsedData, **overrides):
    params = pkg.Parameter(kernel=pkg.KernelType(int(kernel)), cost=COST, epsilon=1e-10,
                           max_iter=300, print_info=False, dtype=np.float64, **HYPER)
    for k, v in overrides.items():
        setattr(params, k, v)
    params.data = parsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    params.values = y
    svm = pkg.make_csvm(params)
    svm.learn()
    return svm


def _assert_matches(alphas, bias, alpha_ref, bias_ref, tol=1e-4, sum_tol=5e-3):
    np.testing.assert_allclose(alphas[:-1], alpha_ref[:-1], rtol=tol, atol=tol)
    assert alphas[-1] == pytest.approx(alpha_ref[-1], rel=sum_tol, abs=sum_tol)
    assert bias == pytest.approx(bias_ref, rel=sum_tol, abs=sum_tol)


@pytest.fixture(scope="module")
def wide_blobs():
    return make_blobs(96, 2048, seed=31)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(1100, 16, seed=11)


#: gamma = 1/f at f = 2048 (the parser's default); 0.1 would cube dot
#: products of ~200 for the polynomial kernel
WIDE = {"gamma": 1.0 / 2048}


class TestFeatureShardedProduct:
    """Wide dense data (f / p > D) shards its features through ``learn()``."""

    @pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
    def test_wide_dense_feature_shards(self, wide_blobs, kernel):
        X, y = wide_blobs
        svm = _train(X, y, kernel, devices=8, **WIDE)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]", svm.last_cg_info
        one = _train(X, y, kernel, devices=1, **WIDE)
        _assert_matches(svm.alphas, svm.bias_, one.alphas, one.bias_)

    def test_feature_sharded_jacobi(self, wide_blobs):
        X, y = wide_blobs
        svm = _train(X, y, KernelType.rbf, devices=8, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_feature[8]"
        one = _train(X, y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, one.alphas, one.bias_)

    def test_axis_override_rows(self, wide_blobs, monkeypatch):
        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "rows")
        X, y = wide_blobs
        svm = _train(X, y, KernelType.linear, devices=8)
        assert not svm.last_cg_info["mode"].startswith("sharded_feature")

    def test_axis_override_features_on_tall(self, blobs, monkeypatch):
        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "features")
        X, y = blobs  # tall data would row-shard
        svm = _train(X, y, KernelType.rbf, devices=8)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]"
        one = _train(X, y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, one.alphas, one.bias_)

    def test_invalid_axis_is_loud(self, wide_blobs, monkeypatch):
        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "bogus")
        X, y = wide_blobs
        with pytest.raises(PLSSVMError, match="PLSSVM_SHARD_AXIS"):
            _train(X, y, KernelType.linear, devices=8)

    def test_tall_data_stays_on_rows(self, blobs):
        X, y = blobs
        svm = _train(X, y, KernelType.rbf, devices=8)
        assert svm.last_cg_info["mode"].startswith("sharded_")
        assert not svm.last_cg_info["mode"].startswith("sharded_feature")

    @pytest.mark.parametrize("flags", ["checkpoint", "verbose"])
    def test_feature_sharded_chunked_cg(self, flags, wide_blobs, tmp_path, capsys):
        """checkpoint / verbose_cg on the feature-sharded learn: the plain
        feature learn's result."""
        X, y = wide_blobs
        overrides = dict(WIDE)
        if flags == "checkpoint":
            overrides["checkpoint_path"] = str(tmp_path / "fcg.npz")
            overrides["checkpoint_interval"] = 20
        else:
            overrides["verbose_cg"] = True
            overrides["print_info"] = True
        svm = _train(X, y, KernelType.rbf, devices=8, **overrides)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]", svm.last_cg_info
        ref = _train(X, y, KernelType.rbf, devices=8, **WIDE)
        _assert_matches(svm.alphas, svm.bias_, ref.alphas, ref.bias_)
        if flags == "checkpoint":
            state = load_cg_checkpoint(overrides["checkpoint_path"])[0]
            assert state.k == svm.last_cg_info["iterations"] and state.x.shape == (256,)
        else:
            assert "Start Iteration 1" in capsys.readouterr().out

    def test_feature_sharded_checkpoint_resume(self, wide_blobs, tmp_path):
        """Interrupted at max_iter, resumed from its checkpoint: the
        uninterrupted learn's bits."""
        X, y = wide_blobs
        ck = str(tmp_path / "fresume.npz")
        first = _train(X, y, KernelType.rbf, devices=8, checkpoint_path=ck, max_iter=5,
                       checkpoint_interval=2, **WIDE)
        assert first.last_cg_info["iterations"] == 5
        resumed = _train(X, y, KernelType.rbf, devices=8, checkpoint_path=ck,
                         checkpoint_interval=2, **WIDE)
        assert resumed.last_cg_info["mode"] == "sharded_feature[8]"
        whole = _train(X, y, KernelType.rbf, devices=8, checkpoint_path=str(tmp_path / "w.npz"),
                       checkpoint_interval=2, **WIDE)
        assert resumed.last_cg_info["iterations"] == whole.last_cg_info["iterations"] > 5
        np.testing.assert_array_equal(resumed.alphas, whole.alphas)
        assert resumed.bias_ == whole.bias_
        one_shot = _train(X, y, KernelType.rbf, devices=8, **WIDE)
        np.testing.assert_array_equal(resumed.alphas[:-1], one_shot.alphas[:-1])
        _assert_matches(resumed.alphas, resumed.bias_, one_shot.alphas, one_shot.bias_,
                        tol=1e-12, sum_tol=1e-9)


def test_jax_checkpoint_resumes_in_the_port(wide_blobs, tmp_path):
    """The JAX package's feature-sharded learn writes the single-device
    format too: its checkpoint on 8 virtual devices resumes in the port."""
    X, y = wide_blobs
    ck = str(tmp_path / "cross.npz")
    first = _train(X, y, KernelType.rbf, pkg=jp, parsed=JParsed, checkpoint_path=ck,
                   max_iter=3, checkpoint_interval=3, **WIDE)
    assert first.last_cg_info["mode"] == "sharded_feature[8]"
    assert first.last_cg_info["iterations"] == 3
    resumed = _train(X, y, KernelType.rbf, devices=8, checkpoint_path=ck, **WIDE)
    whole = _train(X, y, KernelType.rbf, pkg=jp, parsed=JParsed, **WIDE)
    assert resumed.last_cg_info["iterations"] == whole.last_cg_info["iterations"] > 3
    scale = np.abs(whole.alphas).max()
    np.testing.assert_allclose(resumed.alphas, whole.alphas, rtol=0, atol=1e-9 * scale)


# ---------------------------------------------------------------------------
# the functions against the JAX package
# ---------------------------------------------------------------------------

def _jax_operator(kernel, system):
    X, y, X_pad, b_pad, mask, dept = system
    Xd, m, xl = jnp.asarray(X_pad), jnp.asarray(mask), jnp.asarray(X[-1])
    kernel = JKernel(int(kernel))
    q = jax_gram_block(kernel, Xd, xl[None, :], **HYPER)[:, 0] * m
    QA = jax_kernel_scalar(kernel, xl, xl, **HYPER) + 1.0 / COST
    mode = "linear" if kernel == JKernel.linear else "implicit"
    return jax_build_operator(kernel, Xd, q, m, QA, 1.0 / COST, mode=mode, row_block=128,
                              **HYPER).matvec


@functools.lru_cache(maxsize=None)
def _jax_solution(kernel):
    """The JAX package's feature-sharded learn on its 8 devices, once per
    kernel: ``(x, iterations)``."""
    X, y, X_pad, b_pad, mask, dept = _padded()
    mesh = jax_make_mesh(8)
    learn = jax_feature_learn(mesh, JKernel(int(kernel)), HYPER["degree"])
    f64 = jnp.float64
    out = learn(*jax_shard_system_feature(mesh, X_pad, X[-1], b_pad, mask), f64(HYPER["gamma"]),
                f64(HYPER["coef0"]), f64(COST), f64(1e-10), jnp.int32(300))
    return np.asarray(out[0]), int(out[4])


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("p", [2, 4, 8])
def test_feature_sharded_matches_the_jax_package(kernel, p):
    system = _padded()
    X, y, X_pad, b_pad, mask, dept = system
    mesh = make_mesh(p, devices=["cpu"])
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)
    assert [tuple(t.shape) for t in Xs] == [(128, 16 // p)] * p
    np.testing.assert_array_equal(torch.cat(Xs, 1).numpy(), X_pad)
    q, QA, ci, mv, _ = sharded._prepare_feature_local(
        kernel, mesh, Xs, xls, m, HYPER["gamma"], HYPER["coef0"], COST, HYPER["degree"], "none")
    v = np.random.default_rng(p).normal(size=128) * mask
    want = np.asarray(_jax_operator(kernel, system)(jnp.asarray(v)))
    got = mv(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())

    out = _port_learn(kernel, p, system, 1e-10, 300)
    jx, jiters = _jax_solution(kernel)
    assert abs(out[4] - jiters) <= 2
    np.testing.assert_allclose(out[0].numpy(), jx, rtol=1e-4, atol=1e-4)
    again = _port_learn(kernel, p, system, 1e-10, 300)
    assert again[4] == out[4] and torch.equal(again[0], out[0]) and torch.equal(again[5], out[5])


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_setup_and_chunks_equal_one_shot(kernel, precond, monkeypatch):
    """``make_feature_sharded_learn_fns``: set-up plus chunks of 3 iterations
    is the one-shot learn bit for bit, and a pair builds its operator once,
    in whichever of the two runs first."""
    system = _padded()
    X, y, X_pad, b_pad, mask, dept = system
    eps, imax, p = 1e-6, 60, 4
    one = _port_learn(kernel, p, system, eps, imax, precond=precond)
    mesh = make_mesh(p, devices=["cpu"])
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)
    scalars = (HYPER["gamma"], HYPER["coef0"], COST)
    built, prepare = [], sharded._prepare_feature_local

    def counted(*a, **kw):
        built.append(1)
        return prepare(*a, **kw)

    monkeypatch.setattr(sharded, "_prepare_feature_local", counted)
    setup, chunk = sharded.make_feature_sharded_learn_fns(mesh, kernel, HYPER["degree"],
                                                          precond=precond)
    q, QA, state = setup(Xs, xls, b, m, *scalars)
    state0, first = state, chunk(Xs, b, m, xls, *scalars, eps, 3, state)
    while state.k < imax and float(state.delta) > eps * eps * float(state.delta0):
        state = chunk(Xs, b, m, xls, *scalars, eps, min(state.k + 3, imax), state)
    assert built == [1]
    assert state.k == one[4] and torch.equal(state.x, one[0])
    assert float(state.delta) == float(one[5]) and float(QA) == float(one[3])
    _, chunk2 = sharded.make_feature_sharded_learn_fns(mesh, kernel, HYPER["degree"],
                                                       precond=precond)
    again = chunk2(Xs, b, m, xls, *scalars, eps, 3, state0)
    assert again.k == first.k == 3 and torch.equal(again.x, first.x) and built == [1, 1]


def test_shard_system_feature_and_its_checks():
    X, y, X_pad, b_pad, mask, dept = _padded()
    mesh = make_mesh(3, devices=["cpu"])
    with pytest.raises(ValueError, match="must divide evenly"):
        sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)
    mesh = make_mesh(4, devices=["cpu"])
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask,
                                                 dtype=torch.float32)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in Xs + xls)
    assert b.shape == m.shape == (128,) and b.dtype == torch.float32
    np.testing.assert_array_equal(torch.cat(xls).numpy(), X[-1].astype(np.float32))
    learn = sharded.make_feature_sharded_learn(mesh, KernelType.rbf, 3)
    with pytest.raises(ValueError, match="blocks for a mesh"):
        learn(Xs[:2], xls[:2], b, m, 0.1, 1.0, COST, 1e-6, 10)


def test_feature_block_rows(monkeypatch):
    """A partial Gram block is as tall as FEATURE_BLOCK_BYTES allows, a
    multiple of ROW_BLOCK_SIZE, within [ROW_BLOCK_SIZE, D]; its height does
    not change the result."""
    assert sharded._feature_block_rows(4096, 4) == 4096
    assert sharded._feature_block_rows(100, 8) == 100
    assert sharded._feature_block_rows(1 << 20, 4) == 256
    assert sharded._feature_block_rows(1 << 16, 8) == 512
    system = _padded(n=600, f=16, D=768)
    X, y, X_pad, b_pad, mask, dept = system
    mesh = make_mesh(2, devices=["cpu"])
    Xs, xls, b, m = sharded.shard_system_feature(mesh, X_pad, X[-1], b_pad, mask)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=768) * mask)
    args = (KernelType.rbf, mesh, Xs, xls, m, HYPER["gamma"], HYPER["coef0"], COST,
            HYPER["degree"], "none")
    whole = sharded._prepare_feature_local(*args)[3](v)
    monkeypatch.setattr(sharded, "FEATURE_BLOCK_BYTES", 256 * 768 * 8)  # three blocks of 256
    blocked = sharded._prepare_feature_local(*args)[3](v)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-13, atol=1e-13)
