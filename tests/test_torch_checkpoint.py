"""CG-state checkpoint / resume and per-iteration output of the port.

Mirrors ``tests/test_checkpoint.py`` on the port (CPU, float64, the plain
versions of the kernels) and adds what two packages make possible: a
checkpoint written by one package after k iterations is resumed by the
other.

Tolerances.  A resumed run continues the writer's trajectory: against the
*writer's* uninterrupted run it is held to 1e-9 of the alphas' scale
(measured <= 2e-14 on these systems: the reader's first A·v differs from
the writer's in summation order only).  Against the *reader's* own
uninterrupted run the two packages' trajectories have already drifted apart
by what CG amplifies on this ill-conditioned system (measured 1.5e-4 after
10 iterations), so that comparison is held to 1e-3 and to an equal
iteration count.  Within the port, resumed and uninterrupted runs are
bitwise equal: the iteration counter is restored exactly, so the 50-step
residual refresh falls on the same iterations.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.cli.train import main as jax_train
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu.solver import checkpoint as jckpt
from plssvm_sparse_fp22_tpu_torch.cli.train import main as torch_train
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.solver import checkpoint as tckpt
from plssvm_sparse_fp22_tpu_torch.solver.cg import CGState

from utils import make_blobs

PKGS = {"jax": (jp, JParsed), "torch": (tp, TParsed)}


def _learn(pkg, X, y, path=None, interval=50, **kw):
    mod, Parsed = PKGS[pkg]
    kw["kernel"] = mod.KernelType(int(kw.get("kernel", 0)))
    p = mod.Parameter(dtype=np.float64, checkpoint_path=path, checkpoint_interval=interval,
                      print_info=False, devices=1, **kw)
    p.data = Parsed(csr=sp.csr_matrix(X), values=y, _dense=np.asarray(X))
    p.values = y
    if p.gamma == 0.0:
        p.gamma = 1.0 / X.shape[1]
    svm = mod.make_csvm(p)
    svm.learn()
    return svm


def _slow_problem():
    """A system needing many CG iterations (spread Gram spectrum)."""
    rng = np.random.default_rng(7)
    n, f = 120, 200
    X = rng.normal(size=(n, f)) * np.geomspace(1, 100, f)
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return X, y


def test_checkpointed_matches_plain(tmp_path):
    X, y = _slow_problem()
    kw = dict(kernel=0, epsilon=1e-8, max_iter=300)
    plain = _learn("torch", X, y, **kw)
    path = str(tmp_path / "cg.ckpt.npz")
    ck = _learn("torch", X, y, path=path, interval=40, **kw)
    assert plain.last_cg_info["iterations"] > 40  # several chunks ran
    # the chunks run the same eager steps: nothing moves, not even a bit
    assert ck.last_cg_info["iterations"] == plain.last_cg_info["iterations"]
    np.testing.assert_array_equal(ck.alphas, plain.alphas)
    assert ck.bias_ == plain.bias_
    assert os.path.exists(path)


def test_resume_from_partial(tmp_path):
    X, y = _slow_problem()
    path = str(tmp_path / "cg.ckpt.npz")
    kw = dict(kernel=0, epsilon=1e-8)

    # run only 60 iterations (past the refresh at 50), leaving a checkpoint
    partial = _learn("torch", X, y, path=path, interval=10, max_iter=60, **kw)
    assert partial.last_cg_info["iterations"] == 60
    state, q, QA_cost, meta = tckpt.load_cg_checkpoint(path)
    assert state.k == 60 and isinstance(state.k, int)
    assert int(meta["dept"]) == 119 and int(meta["kernel"]) == 0

    resumed = _learn("torch", X, y, path=path, interval=50, max_iter=300, **kw)
    plain = _learn("torch", X, y, max_iter=300, **kw)
    assert resumed.last_cg_info["iterations"] == plain.last_cg_info["iterations"] > 60
    np.testing.assert_array_equal(resumed.alphas, plain.alphas)
    assert resumed.bias_ == plain.bias_


def test_mismatched_checkpoint_rejected(tmp_path):
    X, y = _slow_problem()
    path = str(tmp_path / "cg.ckpt.npz")
    _learn("torch", X, y, path=path, interval=10, max_iter=20, kernel=0, epsilon=1e-8)
    X2, y2 = make_blobs(50, 8, seed=1)
    with pytest.raises(PLSSVMError, match="does not match"):
        _learn("torch", X2, y2, path=path, kernel=0)
    # the same data under another kernel is another problem too
    with pytest.raises(PLSSVMError, match="does not match"):
        _learn("torch", X, y, path=path, kernel=2, gamma=1e-4)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("kernel,gamma,eps", [(0, 0.0, 1e-4), (2, 1e-4, 1e-8)])
def test_cross_package_resume(tmp_path, writer, reader, kernel, gamma, eps):
    """A checkpoint crosses the packages in both directions."""
    X, y = _slow_problem()
    kw = dict(kernel=kernel, gamma=gamma, epsilon=eps)
    plain_w = _learn(writer, X, y, max_iter=300, **kw)
    plain_r = _learn(reader, X, y, max_iter=300, **kw)
    total = plain_w.last_cg_info["iterations"]
    assert total == plain_r.last_cg_info["iterations"] >= 2
    k = total // 2
    path = str(tmp_path / "cross.npz")
    first = _learn(writer, X, y, path=path, interval=max(1, k // 2), max_iter=k, **kw)
    assert first.last_cg_info["iterations"] == k
    second = _learn(reader, X, y, path=path, interval=50, max_iter=300, **kw)
    assert second.last_cg_info["iterations"] == total
    scale = np.abs(plain_w.alphas).max()
    np.testing.assert_allclose(second.alphas, plain_w.alphas, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(second.alphas, plain_r.alphas, rtol=0, atol=1e-3 * scale)


def test_checkpoint_files_have_the_same_keys_and_types(tmp_path):
    X, y = _slow_problem()
    files = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.npz")
        _learn(pkg, X, y, path=path, interval=5, max_iter=10, kernel=0, epsilon=1e-8)
        with np.load(path) as z:
            files[pkg] = {key: (z[key].shape, z[key].dtype.kind) for key in z.files}
            assert int(z["version"]) == tckpt.CHECKPOINT_VERSION == jckpt.CHECKPOINT_VERSION
            assert int(z["k"]) == 10
    assert files["jax"] == files["torch"]
    assert set(files["torch"]) == {"version", "k", "x", "r", "d", "delta", "delta0", "q",
                                   "QA_cost", "meta_dept", "meta_kernel"}
    # each package's loader reads the other's file
    state, q, QA, meta = tckpt.load_cg_checkpoint(str(tmp_path / "jax.npz"),
                                                  device="cpu", dtype=torch.float32)
    assert state.k == 10 and state.x.dtype == torch.float32 and q.dtype == torch.float32
    assert QA.dtype == torch.float32 and state.x.device.type == "cpu"
    jstate, jq, _, jmeta = jckpt.load_cg_checkpoint(str(tmp_path / "torch.npz"))
    assert int(jstate.k) == 10 and int(jmeta["dept"]) == 119
    assert np.asarray(jq).shape == tuple(q.shape)


def test_checkpointed_jacobi_matches_plain_jacobi(tmp_path):
    X, y = _slow_problem()
    kw = dict(kernel=0, epsilon=1e-8, max_iter=300, precond="jacobi")
    plain = _learn("torch", X, y, **kw)
    path = str(tmp_path / "jacobi.npz")
    first = _learn("torch", X, y, path=path, interval=7, **{**kw, "max_iter": 20})
    assert first.last_cg_info["iterations"] == 20
    resumed = _learn("torch", X, y, path=path, interval=7, **kw)
    assert resumed.last_cg_info["iterations"] == plain.last_cg_info["iterations"] > 20
    np.testing.assert_array_equal(resumed.alphas, plain.alphas)
    # and against the JAX package's checkpointed Jacobi learn, three iterations in
    # two chunks (this system amplifies the packages' summation orders tenfold
    # and more per iteration: measured 3.6e-10 at 3, 5.5e-5 at 6)
    early = {**kw, "max_iter": 3}
    jref = _learn("jax", X, y, path=str(tmp_path / "j.npz"), interval=2, **early)
    tref = _learn("torch", X, y, path=str(tmp_path / "t.npz"), interval=2, **early)
    assert tref.last_cg_info["iterations"] == jref.last_cg_info["iterations"] == 3
    scale = np.abs(jref.alphas).max()
    np.testing.assert_allclose(tref.alphas, jref.alphas, rtol=0, atol=1e-8 * scale)


@pytest.mark.parametrize("kernel", ["0", "2"])
def test_verbose_cg_lines_match_the_jax_cli(tmp_path, capsys, kernel):
    """``--verbose_cg``: one ``Start Iteration`` line per iteration, line for
    line the JAX CLI's (numbers to 1e-6 relative or 1e-12 of the first
    residual: two packages' sums)."""
    X, y = make_blobs(60, 7, seed=3)
    data = str(tmp_path / "v.libsvm")
    with open(data, "w") as fh:
        for xi, yi in zip(X, y):
            fh.write(f"{int(yi)} " + " ".join(f"{j}:{v:.17g}" for j, v in enumerate(xi))
                     + "\n")
    outs = {}
    for name, main in (("jax", jax_train), ("torch", torch_train)):
        argv = ["-t", kernel, "-e", "1e-6", "--verbose_cg", data, str(tmp_path / f"{name}.model")]
        if name == "torch":
            argv[:0] = ["-p", "cpu"]
        else:
            os.environ["PLSSVM_DEVICES"] = "1"
        try:
            assert main(argv) == 0
        finally:
            os.environ.pop("PLSSVM_DEVICES", None)
        outs[name] = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("Start Iteration")]
    assert len(outs["torch"]) == len(outs["jax"]) >= 2

    def fields(line):
        words = line.replace("(", " ").replace(")", " ").replace(":", " ").split()
        text = [w for w in words if not _is_number(w)]
        return text, [float(w.rstrip(".")) for w in words if _is_number(w)]

    delta0 = fields(outs["jax"][0])[1][2]
    for got, want in zip(outs["torch"], outs["jax"]):
        (gt, gn), (wt, wn) = fields(got), fields(want)
        assert gt == wt
        assert gn[:2] == wn[:2]  # iteration number and cap
        # a residual near the target is mostly rounding: 1e-12 of delta0 absolute
        np.testing.assert_allclose(gn[2:], wn[2:], rtol=1e-6, atol=1e-12 * delta0)
    assert outs["torch"][0].startswith("Start Iteration 1 (max: 7) with current residuum ")
    assert outs["torch"][0].endswith("). ")


def _is_number(word: str) -> bool:
    try:
        float(word.rstrip("."))
        return True
    except ValueError:
        return False


def test_other_version_is_ignored(tmp_path):
    X, y = _slow_problem()
    path = str(tmp_path / "old.npz")
    kw = dict(kernel=0, epsilon=1e-8, max_iter=30)
    _learn("torch", X, y, path=path, interval=10, **kw)
    with np.load(path) as z:
        payload = {key: z[key] for key in z.files}
    payload["version"] = np.asarray(2)
    payload["k"] = np.asarray(29)
    np.savez(path, **payload)
    assert tckpt.load_cg_checkpoint(path) is None
    again = _learn("torch", X, y, path=path, interval=10, **kw)  # starts afresh
    plain = _learn("torch", X, y, **kw)
    assert again.last_cg_info["iterations"] == 30
    np.testing.assert_array_equal(again.alphas, plain.alphas)
    assert tckpt.load_cg_checkpoint(path)[0].k == 30  # and writes version 1 over it
    assert tckpt.load_cg_checkpoint(str(tmp_path / "absent.npz")) is None


def test_interrupted_write_leaves_no_partial_file(tmp_path, monkeypatch):
    state = CGState(k=3, x=torch.ones(4), r=torch.ones(4), d=torch.ones(4),
                    delta=torch.tensor(1.0), delta0=torch.tensor(2.0))
    path = str(tmp_path / "sub" / "cg.npz")
    tckpt.save_cg_checkpoint(path, state, torch.zeros(4), torch.tensor(0.5), {"dept": 4})
    before = open(path, "rb").read()

    def failing_savez(fh, **payload):
        fh.write(b"half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(tckpt.np, "savez", failing_savez)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_cg_checkpoint(path, state._replace(k=4), torch.zeros(4), torch.tensor(0.5),
                                 {"dept": 4})
    assert os.listdir(tmp_path / "sub") == ["cg.npz"]  # no temp file left
    assert open(path, "rb").read() == before           # the old checkpoint intact
    monkeypatch.undo()
    assert tckpt.load_cg_checkpoint(path)[0].k == 3


@pytest.mark.parametrize("flag", [{"checkpoint": True}, {"verbose_cg": True}])
def test_sparse_learns_still_refuse(tmp_path, flag):
    X, y = make_blobs(40, 8, seed=2)
    kw = {"verbose_cg": True} if "verbose_cg" in flag else {}
    path = str(tmp_path / "s.npz") if "checkpoint" in flag else None
    for kernel in (0, 2):
        with pytest.raises(PLSSVMError, match="not supported on the sparse learn path"):
            _learn("torch", X, y, path=path, kernel=kernel, sparse_threshold=1.0, **kw)
    assert not os.path.exists(str(tmp_path / "s.npz"))


def test_checkpoint_runs_the_fixed_tier_not_the_plan(tmp_path, monkeypatch):
    """The chunked CG loop never takes the adaptive plan (``base.py:539-544``
    of the JAX package): with the plan forced, a checkpointed float32 learn
    reports no fast tier and equals the fixed-tier learn."""
    X, y = make_blobs(80, 10, seed=4)
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1")  # implicit mode

    def learn(**kw):
        p = tp.Parameter(kernel=tp.KernelType.rbf, gamma=0.1, epsilon=1e-5, dtype=np.float32,
                         print_info=False, devices=1, max_iter=100, **kw)
        p.data = TParsed(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = tp.make_csvm(p)
        svm.learn()
        return svm

    ck = learn(checkpoint_path=str(tmp_path / "t.npz"), checkpoint_interval=3)
    assert ck.last_cg_info["mode"] == "implicit"
    assert ck.last_cg_info["fast_iterations"] == ck.last_cg_info["iterations"]
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "highest")
    fixed = learn()
    assert ck.last_cg_info["iterations"] == fixed.last_cg_info["iterations"]
    np.testing.assert_array_equal(ck.alphas, fixed.alphas)


def test_timings_sink_splits_setup_and_cg(tmp_path):
    from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

    X, y = _slow_problem()
    p = tp.Parameter(kernel=tp.KernelType.linear, epsilon=1e-8, max_iter=25, dtype=np.float64,
                     print_info=False, devices=1, checkpoint_path=str(tmp_path / "t.npz"),
                     checkpoint_interval=10)
    p.data = TParsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = tp.make_csvm(p)
    svm.timings = Timings()
    svm.learn()
    assert len(svm.timings.records["setup"]) == 2  # system and operator; initial residual
    assert len(svm.timings.records["cg"]) == 3     # chunks of 10, 10, 5
    assert all(ms >= 0 for v in svm.timings.records.values() for ms in v)
