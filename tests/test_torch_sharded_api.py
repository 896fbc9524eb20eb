"""Product-surface multi-device tests of the port: ``CSVM.learn()`` /
``predict()`` and the CLIs over logical CPU shards.

The dense cases of ``tests/test_sharded_api.py``: ``Parameter.devices`` and
``PLSSVM_DEVICES`` route a dense learn to the row-sharded path (mode
``sharded_<mode>[p]``), results agree with the numpy oracle, with the port's
single-device learn and with the JAX package's sharded learn, and the
checkpoint / Jacobi / verbose flags work there as on one device.  Sparse
data and the feature axis take their sharded routes (the functions are held
in ``tests/test_torch_sparse_sharded.py`` and
``tests/test_torch_feature_sharded.py``).
Tolerances as in ``tests/test_sharded_api.py``: converged float64 runs at
eps 1e-10 differ by their CG trajectories, 1e-4 per alpha and 5e-3 on the
sums (the last alpha, the bias).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
from plssvm_sparse_fp22_tpu_torch.cli.train import main as train_main
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
from plssvm_sparse_fp22_tpu_torch.io.model import parse_model_file
from plssvm_sparse_fp22_tpu_torch.solver.checkpoint import load_cg_checkpoint
from plssvm_sparse_fp22_tpu_torch.types import KernelType
from plssvm_sparse_fp22_tpu_torch.utils import oracle

from utils import make_blobs

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
# dept >= 1024 so the rows-per-shard cap admits 8 shards
N, F = 1100, 16


def _write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for xi, yi in zip(X, y):
            feats = " ".join(f"{j + 1}:{v:.10g}" for j, v in enumerate(xi))
            fh.write(f"{int(yi)} {feats}\n")


def _train(X, y, kernel, pkg=tp, parsed=ParsedData, **overrides):
    params = pkg.Parameter(kernel=pkg.KernelType(int(kernel)), cost=2.0, epsilon=1e-10,
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
def blobs():
    return make_blobs(N, F, seed=11)


@pytest.fixture(scope="module")
def oracle_solutions(blobs):
    X, y = blobs
    return {kernel: oracle.solve_lssvm(X, y, kernel=kernel, cost=2.0, epsilon=1e-10,
                                       max_iter=300, **HYPER)
            for kernel in KERNELS}


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_csvm_learn_sharded_matches_oracle(kernel, ndev, blobs, oracle_solutions):
    """``Parameter(devices=p)`` row-shards a dense learn and matches the
    numpy oracle."""
    X, y = blobs
    svm = _train(X, y, kernel, devices=ndev)
    mode = "linear" if kernel == KernelType.linear else "cached"
    assert svm.last_cg_info["mode"] == f"sharded_{mode}[{ndev}]"
    assert svm.last_cg_info["padded"] % (128 * ndev) == 0
    alpha_ref, bias_ref, _ = oracle_solutions[kernel]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_csvm_devices_pin_single_chip(kernel, blobs):
    """``devices=1`` (the default on the CPU) pins the single-device path;
    results agree with the sharded run and with the JAX package's sharded
    run on its 8 virtual devices."""
    X, y = blobs
    svm1 = _train(X, y, kernel, devices=1)
    assert not svm1.last_cg_info["mode"].startswith("sharded_")
    default = _train(X, y, kernel)
    assert default.last_cg_info["mode"] == svm1.last_cg_info["mode"]
    svm8 = _train(X, y, kernel, devices=8)
    _assert_matches(svm1.alphas, svm1.bias_, svm8.alphas, svm8.bias_)
    jsvm = _train(X, y, kernel, pkg=jp, parsed=JParsed)
    assert jsvm.last_cg_info["mode"] == svm8.last_cg_info["mode"]
    assert abs(jsvm.last_cg_info["iterations"] - svm8.last_cg_info["iterations"]) <= 2
    _assert_matches(svm8.alphas, svm8.bias_, jsvm.alphas, jsvm.bias_)


def test_env_devices_override(blobs, monkeypatch):
    X, y = blobs
    monkeypatch.setenv("PLSSVM_DEVICES", "2")
    svm = _train(X, y, KernelType.rbf)
    assert svm.last_cg_info["mode"].endswith("[2]")
    # Parameter.devices wins over the environment
    assert _train(X, y, KernelType.rbf, devices=4).last_cg_info["mode"].endswith("[4]")
    # a tiny system is not spread: rows per shard >= PAD_SIZE
    Xs, ys = make_blobs(200, F, seed=3)
    assert _train(Xs, ys, KernelType.rbf, devices=8).last_cg_info["mode"] == "cached"
    assert _train(Xs[:300], ys[:300], KernelType.rbf).last_cg_info["mode"] == "cached"


def test_implicit_mode_name_and_ring_through_the_api(blobs, monkeypatch, oracle_solutions):
    """Beyond the K-cache budget the sharded learn takes the ring."""
    X, y = blobs
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1024")
    svm = _train(X, y, KernelType.rbf, devices=4)
    assert svm.last_cg_info["mode"] == "sharded_implicit[4]"
    alpha_ref, bias_ref, _ = oracle_solutions[KernelType.rbf]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_predict_matches_oracle_decision(kernel, ndev, blobs):
    """Multi-device predict (support vectors sharded, partials summed; ``w``
    for the linear kernel) agrees with the oracle's decision function and
    with the single-device predict."""
    X, y = blobs
    svm = _train(X, y, kernel, devices=ndev)
    P, _ = make_blobs(64, F, seed=99)
    got = svm.predict(P)
    want = oracle.predict_values(X, svm.alphas, svm.bias_, P, kernel=kernel, **HYPER)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    single = tp.csvm_from_state(
        {"kernel": int(kernel), "alphas": svm.alphas, "bias_": svm.bias_, "support_vectors": X,
         "values": y, **HYPER}, dtype=np.float64, devices=1, print_info=False)
    np.testing.assert_allclose(got, single.predict(P), rtol=1e-9, atol=1e-9)
    assert svm.predict(P[0]) == pytest.approx(got[0], rel=1e-12)
    if kernel == KernelType.linear:
        np.testing.assert_allclose(svm.w_, X.T @ svm.alphas, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("flags", ["jacobi", "checkpoint", "verbose"])
def test_sharded_feature_flags(flags, blobs, oracle_solutions, tmp_path, capsys):
    """checkpoint / jacobi / verbose_cg work on the sharded learn with the
    same semantics as on one device: one CG everywhere."""
    X, y = blobs
    overrides = {"devices": 4}
    if flags == "jacobi":
        overrides["precond"] = "jacobi"
    elif flags == "checkpoint":
        overrides["checkpoint_path"] = str(tmp_path / "cg.npz")
        overrides["checkpoint_interval"] = 20
    else:
        overrides["verbose_cg"] = True
        overrides["print_info"] = True
    svm = _train(X, y, KernelType.rbf, **overrides)
    assert svm.last_cg_info["mode"] == "sharded_cached[4]"
    alpha_ref, bias_ref, _ = oracle_solutions[KernelType.rbf]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)
    if flags == "checkpoint":
        state = load_cg_checkpoint(overrides["checkpoint_path"])[0]
        assert state.k == svm.last_cg_info["iterations"]
        assert state.x.shape == (svm.last_cg_info["padded"],)  # whole vectors
    if flags == "verbose":
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("Start Iteration")]
        assert len(lines) == svm.last_cg_info["iterations"]


@pytest.mark.parametrize("budget", [None, "1024"], ids=["cached", "implicit"])
def test_sharded_checkpoint_resume(blobs, tmp_path, monkeypatch, budget):
    """A sharded learn interrupted by max_iter resumes from the checkpoint
    and ends bit for bit where the uninterrupted sharded run ends."""
    X, y = blobs
    if budget is not None:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", budget)
    ck = str(tmp_path / "resume.npz")
    svm_a = _train(X, y, KernelType.rbf, devices=4, checkpoint_path=ck, max_iter=10,
                   checkpoint_interval=5)
    assert svm_a.last_cg_info["iterations"] == 10 and os.path.exists(ck)
    svm_b = _train(X, y, KernelType.rbf, devices=4, checkpoint_path=ck, max_iter=300,
                   checkpoint_interval=5)
    svm_plain = _train(X, y, KernelType.rbf, devices=4)
    assert svm_b.last_cg_info["iterations"] == svm_plain.last_cg_info["iterations"] > 10
    np.testing.assert_array_equal(svm_b.alphas[:-1], svm_plain.alphas[:-1])
    _assert_matches(svm_b.alphas, svm_b.bias_, svm_plain.alphas, svm_plain.bias_,
                    tol=1e-12, sum_tol=1e-9)
    # a checkpoint of another problem is refused on this path too
    with pytest.raises(PLSSVMError, match="does not match"):
        _train(X[:1050], y[:1050], KernelType.rbf, devices=4, checkpoint_path=ck)


def test_cross_package_sharded_checkpoint(blobs, tmp_path):
    """The JAX package's sharded learn writes whole vectors too: its
    checkpoint on 4 virtual devices resumes in the port on 4 shards."""
    X, y = blobs
    ck = str(tmp_path / "cross.npz")
    first = _train(X, y, KernelType.rbf, pkg=jp, parsed=JParsed, devices=4, checkpoint_path=ck,
                   max_iter=3, checkpoint_interval=3, epsilon=1e-5)
    assert first.last_cg_info["iterations"] == 3
    resumed = _train(X, y, KernelType.rbf, devices=4, checkpoint_path=ck, epsilon=1e-5)
    whole = _train(X, y, KernelType.rbf, pkg=jp, parsed=JParsed, devices=4, epsilon=1e-5)
    assert resumed.last_cg_info["iterations"] == whole.last_cg_info["iterations"] > 3
    scale = np.abs(whole.alphas).max()
    np.testing.assert_allclose(resumed.alphas[:-1], whole.alphas[:-1], rtol=0,
                               atol=1e-9 * scale)
    # the last alpha is -sum(x) over 1099 entries: their differences add up
    assert resumed.alphas[-1] == pytest.approx(whole.alphas[-1], abs=1e-6 * scale)


def test_what_is_not_ported_raises_by_name(blobs, monkeypatch):
    """What raised by name before the sparse and feature-sharded learns were
    ported now takes the JAX package's routes and mode names: sparse data on
    several devices (densified onto the dense sharded learn within the
    budget, ringed beyond it; linear on the ELL+COO slabs), the feature axis
    where it is forced or the data is wide.  One device, or a system too
    small to spread, keeps the sparse tiers; ``PLSSVM_SHARD_AXIS=rows`` and
    the invalid-axis error still hold."""
    X, y = blobs
    assert _train(X, y, KernelType.rbf, devices=4,
                  sparse_threshold=1.0).last_cg_info["mode"] == "sharded_cached[4]"
    assert _train(X, y, KernelType.linear, devices=2,
                  sparse_threshold=1.0).last_cg_info["mode"] == "sharded_sparse_linear[2]"
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1024")
    assert _train(X, y, KernelType.rbf, devices=4, sparse_threshold=1.0,
                  max_iter=5).last_cg_info["mode"] == "sharded_sparse_implicit[4]"
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    # one device, or a system too small to spread, keeps the sparse tiers
    assert _train(X, y, KernelType.rbf, devices=1,
                  sparse_threshold=1.0).last_cg_info["mode"].startswith("sparse_")
    assert _train(X[:200], y[:200], KernelType.rbf, devices=4,
                  sparse_threshold=1.0).last_cg_info["mode"].startswith("sparse_")
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", "features")
    assert _train(X, y, KernelType.linear, devices=2).last_cg_info["mode"] == "sharded_feature[2]"
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", "auto")
    wide, yw = make_blobs(40, 400, seed=2)  # f / p > dept: auto picks the feature axis
    assert _train(wide, yw, KernelType.linear,
                  devices=2).last_cg_info["mode"] == "sharded_feature[2]"
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", "rows")
    assert _train(X, y, KernelType.linear, devices=2).last_cg_info["mode"] == "sharded_linear[2]"
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", "columns")
    with pytest.raises(PLSSVMError, match="Invalid PLSSVM_SHARD_AXIS"):
        _train(X, y, KernelType.linear, devices=2)


def test_cli_train_sharded_parity(tmp_path, blobs, monkeypatch):
    """``plssvm-train-torch`` under ``PLSSVM_DEVICES=8`` produces a model
    whose weights match a single-device train of the same data, and the
    predict CLI reads it."""
    X, y = blobs
    train_file = str(tmp_path / "data.libsvm")
    _write_libsvm(train_file, X, y)
    argv = ["-t", "2", "-g", "0.1", "-c", "2.0", "-e", "1e-10", "--max_iter", "300", "-q",
            "-p", "cpu", train_file]
    model8, model1 = str(tmp_path / "m8.model"), str(tmp_path / "m1.model")
    monkeypatch.setenv("PLSSVM_DEVICES", "8")
    assert train_main([*argv, model8]) == 0
    monkeypatch.setenv("PLSSVM_DEVICES", "1")
    assert train_main([*argv, model1]) == 0
    m8, m1 = parse_model_file(model8), parse_model_file(model1)
    assert m8.rho == pytest.approx(m1.rho, rel=1e-3, abs=1e-3)
    np.testing.assert_allclose(m8.support_vectors.values, m1.support_vectors.values,
                               rtol=1e-3, atol=1e-3)
    monkeypatch.setenv("PLSSVM_DEVICES", "8")
    pred8 = str(tmp_path / "p8.predict")
    assert predict_main(["-q", "-p", "cpu", train_file, model8, pred8]) == 0
    labels = np.loadtxt(pred8)
    assert np.mean(labels == y) > 0.9
    monkeypatch.setenv("PLSSVM_DEVICES", "1")
    pred1 = str(tmp_path / "p1.predict")
    assert predict_main(["-q", "-p", "cpu", train_file, model8, pred1]) == 0
    np.testing.assert_array_equal(labels, np.loadtxt(pred1))
