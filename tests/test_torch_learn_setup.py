"""The one-device dense learn's set-up, its split, and its kept layouts, on
the CPU.

- The set-up pads on the device and prepares the operators' operands once.
  Against the set-up it replaced (``_host_padded_learn`` below: the rows
  padded in a host array, copied across, each operator preparing its own
  row norms and operands), every learn gives the same alphas, bias and
  iterations, bit for bit, on the dense and the sparse ``dense`` tiers.
- An ``implicit`` learn keeps its system's tensors and operators in its
  layout (``solver.cg.layout``): a second learn of the layout writes into
  the same tensors and is bitwise a fresh learn; ``cost`` and ``eps`` keep
  the layout, ``gamma`` replaces it; :func:`~solver.cg.clear_graphs` frees
  it.  Where the step graphs are kept is tested with fake A·v callables.
- The ``setup`` span splits into ``load``, ``pad``, ``h2d``, ``operands``
  and ``system``, the ``cg`` span has its ``capture`` part, the CLIs'
  ``cli`` span its parse, learn or predict, and write parts; each span's
  parts add up to no more than the span.
- A learn on a kept layout is held against the JAX package as
  ``test_torch_model.py`` holds a fresh one.
"""

import gc
import weakref

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu_torch.constants import PAD_SIZE, ROW_BLOCK_SIZE
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
from plssvm_sparse_fp22_tpu_torch.ops.matvec import (build_operator, choose_mode, jacobi_minv,
                                                     resolve_mxu_plan, tier_precision)
from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

from utils import make_blobs

CPU = torch.device("cpu")
SETUP_PARTS = {"load", "pad", "h2d", "operands", "system"}


@pytest.fixture(autouse=True)
def _no_kept_layouts():
    tcg.clear_graphs()
    yield
    tcg.clear_graphs()


def _svm(X, y, *, sparse=False, **kw):
    kw.setdefault("dtype", np.float64)
    kw.setdefault("kernel", tp.KernelType.rbf)
    kw.setdefault("gamma", 1.0 / X.shape[1])
    p = tp.Parameter(devices=1, print_info=False, coef0=1.0, **kw)
    csr = sp.csr_matrix(X)
    if sparse:
        p.sparse_threshold = 1.0
        p.data = TParsed(csr=csr, values=y)
    else:
        p.data = TParsed(csr=csr, values=y, _dense=X)
    p.values = np.asarray(y, np.float64)
    return tp.make_csvm(p)


def _learned(X, y, **kw):
    svm = _svm(X, y, **kw)
    svm.learn()
    return svm


def _host_padded_learn(svm):
    """``(alphas, bias, iterations)`` of the one-device dense learn with the
    set-up this port used before: the rows zero-padded in a host array of
    the learn's dtype (densified with ``toarray()`` for sparse data),
    copied to the device, and each operator preparing its own row norms and
    operands; then the same CG."""
    data, dtype, np_dtype = svm.data, svm.dtype, svm._np_dtype
    y = np.asarray(svm.values, np.float64)
    n, f = data.csr.shape
    dept = n - 1
    D = -(-dept // max(PAD_SIZE, ROW_BLOCK_SIZE)) * max(PAD_SIZE, ROW_BLOCK_SIZE)
    X_pad = np.zeros((D, f), dtype=np_dtype)
    if svm._use_sparse():
        X_pad[:dept] = data.csr[:dept].toarray()
        x_last = data.csr[-1].toarray().ravel()
        mode = "implicit"
    else:
        X_pad[:dept] = data.dense[:dept]
        x_last = data.dense[-1]
        mode = choose_mode(svm.kernel, dept, dtype, num_features=f, backend=svm.backend)
    b_pad = np.zeros(D, dtype=np_dtype)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D, dtype=np_dtype)
    mask[:dept] = 1.0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype))

    Xd, x_last, b, m = dev(X_pad), dev(x_last), dev(b_pad), dev(mask)
    kw = {"degree": svm.degree, "gamma": svm.gamma, "coef0": svm.coef0}
    cost_inv = torch.tensor(1.0, dtype=dtype) / torch.tensor(svm.cost, dtype=dtype)
    q = gram_block(svm.kernel, Xd, x_last[None, :], **kw)[:, 0] * m
    QA_cost = kernel_scalar(svm.kernel, x_last, x_last, **kw) + cost_inv
    minv = None
    if svm.params.precond == "jacobi":
        minv = jacobi_minv(svm.kernel, Xd, q, m, QA_cost, cost_inv, svm.degree, svm.gamma,
                           svm.coef0)
    plan = resolve_mxu_plan(mode, dtype, svm.backend)
    tiers = [None] if plan is None else [tier_precision(t) for t in plan]
    ops = [build_operator(svm.kernel, Xd, q, m, QA_cost, cost_inv, mode=mode,
                          backend=svm.backend, precision=tier, **kw) for tier in tiers]
    imax = svm.params.max_iter
    if plan is None:
        res = tcg.cg_solve(ops[0].matvec, b, m, svm.epsilon, imax, minv=minv)
    else:
        res = tcg.cg_solve_adaptive(ops[0].matvec, ops[1].matvec, b, m, svm.epsilon, imax,
                                    minv=minv)
    s, t = torch.sum(res.x), torch.dot(q, res.x)
    x = res.x.numpy().astype(np.float64)[:dept]
    bias = float(y[-1]) + float(QA_cost) * float(s) - float(t)
    return np.concatenate([x, [-float(s)]]), bias, res.iterations


# (kernel, dtype, environment, Parameter keywords, sparse data)
SETUP_CASES = {
    "rbf implicit f64": (tp.KernelType.rbf, np.float64, {"PLSSVM_K_CACHE_BYTES": "1000"}, {},
                         False),
    "rbf implicit f32": (tp.KernelType.rbf, np.float32, {"PLSSVM_K_CACHE_BYTES": "1000"}, {},
                         False),
    "poly implicit jacobi": (tp.KernelType.polynomial, np.float64,
                             {"PLSSVM_K_CACHE_BYTES": "1000"}, {"precond": "jacobi"}, False),
    "rbf cached": (tp.KernelType.rbf, np.float64, {}, {}, False),
    "linear": (tp.KernelType.linear, np.float64, {}, {}, False),
    "rbf adaptive f32": (tp.KernelType.rbf, np.float32,
                         {"PLSSVM_K_CACHE_BYTES": "1000", "PLSSVM_MATMUL_PRECISION": "adaptive"},
                         {}, False),
    "sparse dense tier f64": (tp.KernelType.rbf, np.float64, {"PLSSVM_SPARSE_MODE": "dense"}, {},
                              True),
    "sparse dense tier adaptive f32": (tp.KernelType.polynomial, np.float32,
                                       {"PLSSVM_SPARSE_MODE": "dense",
                                        "PLSSVM_MATMUL_PRECISION": "adaptive"}, {}, True),
}


def _data(sparse, seed=3, n=90, f=24):
    X, y = make_blobs(n, f, seed=seed)
    if sparse:
        rng = np.random.default_rng(seed)
        X = X * (rng.random(X.shape) < 0.2)
        X[np.arange(n), rng.integers(f, size=n)] = 1.0
    return X, y


@pytest.mark.parametrize("case", list(SETUP_CASES))
def test_learn_is_bitwise_the_host_padded_learn(case, monkeypatch):
    kernel, dtype, env, kw, sparse = SETUP_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    X, y = _data(sparse)
    svm = _learned(X, y, kernel=kernel, dtype=dtype, epsilon=1e-8, max_iter=200, sparse=sparse,
                   **kw)
    want = _host_padded_learn(_svm(X, y, kernel=kernel, dtype=dtype, epsilon=1e-8, max_iter=200,
                                   sparse=sparse, **kw))
    if sparse:
        assert svm.last_cg_info["mode"] == "sparse_dense_implicit"
    np.testing.assert_array_equal(svm.alphas, want[0])
    assert svm.bias_ == want[1]
    assert svm.last_cg_info["iterations"] == want[2]


@pytest.mark.parametrize("zeros", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_learn_from_parsed_csr_rows_is_bitwise_the_host_padded_learn(zeros, dtype, monkeypatch):
    """Dense data as a parse gives it, CSR only: with every entry stored the
    rows are the CSR's values (no copy on the host), with some zeros left
    out they are ``toarray()``'s."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(90, 24, seed=4)
    X = X * (np.random.default_rng(4).random(X.shape) >= zeros)

    def make():
        p = tp.Parameter(devices=1, print_info=False, kernel=tp.KernelType.rbf, gamma=0.05,
                         epsilon=1e-8, max_iter=200, dtype=dtype)
        p.data = TParsed(csr=sp.csr_matrix(X), values=y)
        p.values = y
        return tp.make_csvm(p)

    svm = make()
    assert (svm.data.stored_rows() is None) == (zeros > 0)
    svm.learn()
    want = _host_padded_learn(make())
    np.testing.assert_array_equal(svm.alphas, want[0])
    assert svm.bias_ == want[1]
    assert svm.last_cg_info["iterations"] == want[2]


def test_sparse_rows_with_a_repeated_entry_add_up_as_toarray(monkeypatch):
    """A CSR that repeats an entry (not a parse's output) is densified on
    the host, where its repeats add up as ``toarray()`` adds them."""
    monkeypatch.setenv("PLSSVM_SPARSE_MODE", "dense")
    X, y = _data(True)
    csr = sp.csr_matrix(X)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    doubled = sp.csr_matrix((np.concatenate([csr.data, [0.25]]),
                             (np.concatenate([rows, [3]]),
                              np.concatenate([csr.indices, [csr.indices[csr.indptr[3]]]]))),
                            shape=csr.shape)
    doubled.has_canonical_format = False  # keep the repeat: no sum on construction
    assert not doubled.has_canonical_format

    def make():
        p = tp.Parameter(devices=1, print_info=False, kernel=tp.KernelType.rbf, gamma=0.05,
                         epsilon=1e-8, max_iter=200, dtype=np.float64, sparse_threshold=1.0)
        p.data = TParsed(csr=doubled, values=y)
        p.values = y
        return tp.make_csvm(p)

    svm = make()
    svm.learn()
    want = _host_padded_learn(make())
    np.testing.assert_array_equal(svm.alphas, want[0])
    assert svm.last_cg_info["iterations"] == want[2]


def test_stored_rows_are_the_dense_rows():
    """The CSR of a dense file holds every entry once per row, in column
    order: its values are the dense rows, with no copy."""
    X, y = make_blobs(20, 6, seed=1)
    full = TParsed(csr=sp.csr_matrix(X), values=y)
    rows = full.stored_rows()
    assert rows is not None and np.shares_memory(rows, full.csr.data)
    np.testing.assert_array_equal(rows, full.csr.toarray())
    np.testing.assert_array_equal(full.dense, full.csr.toarray())
    X[3, 2] = 0.0
    assert TParsed(csr=sp.csr_matrix(X), values=y).stored_rows() is None
    given = TParsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    assert given.stored_rows() is X


# --- kept layouts -----------------------------------------------------------------------


def _kept():
    return tcg._LAYOUTS.get(CPU)


def test_second_learn_of_a_layout_reuses_its_system_bitwise(monkeypatch):
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(90, 24, seed=3)
    kw = dict(epsilon=1e-8, max_iter=200)
    first = _learned(X, y, **kw)
    kept = _kept()
    system = kept.buffers
    ptr, ops = system.X.data_ptr(), system.ops
    second = _learned(X, y, **kw)
    assert _kept() is kept and kept.buffers is system
    assert system.X.data_ptr() == ptr and system.ops is ops
    for op in ops:
        assert op.matvec.layout() is kept
    np.testing.assert_array_equal(second.alphas, first.alphas)
    assert second.bias_ == first.bias_
    assert second.last_cg_info == first.last_cg_info


def test_layout_keeps_cost_and_eps_and_changes_with_gamma(monkeypatch):
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(90, 24, seed=3)
    _learned(X, y, epsilon=1e-8, max_iter=200)
    kept = _kept()
    for kw in ({"cost": 2.0}, {"epsilon": 1e-4}):
        kw = {"epsilon": 1e-8, **kw}
        reused = _learned(X, y, max_iter=200, **kw)
        assert _kept() is kept
        tcg.clear_graphs()
        fresh = _learned(X, y, max_iter=200, **kw)
        np.testing.assert_array_equal(reused.alphas, fresh.alphas)
        assert reused.bias_ == fresh.bias_
        assert reused.last_cg_info["iterations"] == fresh.last_cg_info["iterations"]
        kept = _kept()
    _learned(X, y, gamma=2.0 / 24, epsilon=1e-8, max_iter=200)
    assert _kept() is not kept and _kept().key != kept.key


def test_layout_follows_the_fixed_tier_as_it_resolves(monkeypatch):
    """The fixed tier follows ``PLSSVM_MATMUL_PRECISION``, read at each
    learn (on the ``cuda`` backend): a learn whose tier resolves otherwise
    keeps a layout of its own, and runs its own tier."""
    from plssvm_sparse_fp22_tpu_torch.models import base

    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(90, 24, seed=3)
    kw = dict(dtype=np.float32, epsilon=1e-8, max_iter=200)
    exact = _learned(X, y, **kw)
    kept = _kept()
    monkeypatch.setattr(base, "fixed_tier", lambda backend: "bf16cast")
    cast = _learned(X, y, **kw)
    assert _kept() is not kept
    tcg.clear_graphs()
    fresh = _learned(X, y, **kw)
    np.testing.assert_array_equal(cast.alphas, fresh.alphas)
    assert not np.array_equal(cast.alphas, exact.alphas)


@pytest.mark.parametrize("dtype,precision", [(np.float64, ""), (np.float32, "adaptive")])
def test_fewer_rows_in_a_kept_layout_leave_no_stale_rows(dtype, precision, monkeypatch):
    """A learn of other, fewer points into the same padded size zeroes the
    rows the previous learn filled and prepares its own operands (the bf16
    tiers' too): bitwise a fresh learn of its own."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", precision)
    X, y = make_blobs(200, 24, seed=5)
    kw = dict(epsilon=1e-8, max_iter=200, dtype=dtype)
    _learned(X[50:], y[50:], **kw)
    kept = _kept()
    small = _learned(X[:150], y[:150], **kw)
    assert _kept() is kept
    system = kept.buffers
    assert not system.X[149:].any() and not system.mask[149:].any()  # the padding invariant
    tcg.clear_graphs()
    fresh = _learned(X[:150], y[:150], **kw)
    np.testing.assert_array_equal(small.alphas, fresh.alphas)
    assert small.bias_ == fresh.bias_
    assert small.last_cg_info == fresh.last_cg_info


def test_a_replaced_layout_is_freed_at_once(monkeypatch):
    """No reference cycle holds a learn's layout: replaced, it is freed at
    once, not later by the garbage collector, which may run in the middle
    of another layout's CUDA-graph capture (and a graph freed there
    invalidates that capture)."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(90, 24, seed=3)
    gc.collect()
    gc.disable()
    try:
        _learned(X, y)
        kept = weakref.ref(_kept())
        system = weakref.ref(_kept().buffers)
        tcg.layout(("another layout",), CPU)
        assert kept() is None and system() is None
    finally:
        gc.enable()


def test_only_implicit_learns_keep_a_layout(monkeypatch):
    X, y = make_blobs(90, 24, seed=3)
    _learned(X, y)  # cached
    _learned(X, y, kernel=tp.KernelType.linear)
    assert _kept() is None
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    _learned(X, y)
    assert _kept() is not None
    tcg.clear_graphs()
    assert _kept() is None and not tcg._GRAPHS


def test_learn_on_a_kept_layout_matches_jax(monkeypatch):
    """Held as ``test_torch_model.test_learn_float64_matches_jax`` holds a
    fresh learn: the layout first holds another data set's values."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    other, y_other = make_blobs(80, 40, seed=9)
    X, y = make_blobs(80, 40, seed=3)
    kw = dict(kernel=tp.KernelType.rbf, epsilon=1e-3, max_iter=200)
    _learned(other, y_other, **kw)
    kept = _kept()
    t = _learned(X, y, **kw)
    assert _kept() is kept
    p = jp.Parameter(devices=1, print_info=False, kernel=jp.KernelType.rbf, gamma=1.0 / 40,
                     coef0=1.0, epsilon=1e-3, max_iter=200, dtype=np.float64)
    p.data = JParsed(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    j = jp.make_csvm(p)
    j.learn()
    assert t.last_cg_info["mode"] == j.last_cg_info["mode"] == "implicit"
    assert t.last_cg_info["iterations"] == j.last_cg_info["iterations"]
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9, atol=1e-9 * np.abs(j.alphas).max())
    assert t.bias_ == pytest.approx(j.bias_, abs=1e-9 * t.QA_cost_ * np.abs(j.alphas).sum())


# --- where the step graphs are kept (fake A·v) -------------------------------------------


def _fake(name, layout=None):
    def matvec(v):
        return v

    matvec.__qualname__ = name
    if layout is not None:
        matvec.layout = weakref.ref(layout)
    return matvec


def test_graph_store_is_the_layout_and_its_key_the_loop():
    kept = tcg.layout(("system", 1), CPU)
    assert tcg.layout(("system", 1), "cpu") is kept
    b = torch.zeros(8)
    store, key = tcg._graph_store(_fake("op[bf16cast]", kept), b, None, tcg._dot, True)
    assert store is kept.graphs
    # another callable of the layout's operator (a later learn) finds the same
    # graphs: the key holds the loop, not the callable
    again, key_again = tcg._graph_store(_fake("op[bf16cast]", kept), b, None, tcg._dot, True)
    assert again is store and key_again == key
    keys = {key,
            tcg._graph_store(_fake("op[bf16x3]", kept), b, None, tcg._dot, True)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), b, b, tcg._dot, True)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), b, None, tcg._dot, False)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), torch.zeros(16), None, tcg._dot,
                             True)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), b.double(), None, tcg._dot, True)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), b, None, tcg._dot, True, 16)[1],
            tcg._graph_store(_fake("op[bf16cast]", kept), b, None, tcg._dot, True,
                             tcg.CHUNK, 1)[1]}
    # the tier, minv, the stagnation loop, D, dtype, the chunk's slots and
    # the refresh interval each count
    assert len(keys) == 8
    plain = _fake("op[bf16cast]")
    own, _ = tcg._graph_store(plain, b, None, tcg._dot, True)
    assert own is tcg._GRAPHS[plain] and own is not store


def test_one_layout_per_device_the_replaced_one_freed():
    kept = tcg.layout(("system", 1), CPU)
    kept.graphs["loop"] = object()
    gone = weakref.ref(kept)
    other = tcg.layout(("system", 1), "meta")  # another device keeps its own
    assert tcg.layout(("system", 1), CPU) is kept
    assert tcg.layout(("system", 2), CPU) is not kept
    del kept
    gc.collect()
    assert gone() is None
    assert tcg.layout(("system", 1), "meta") is other
    tcg.clear_graphs()
    assert tcg.layout(("system", 1), "meta") is not other


# --- the split -------------------------------------------------------------------------

SPLIT_CASES = {
    "rbf implicit": ({"PLSSVM_K_CACHE_BYTES": "1000"}, False),
    "rbf cached": ({}, False),
    "rbf adaptive": ({"PLSSVM_K_CACHE_BYTES": "1000", "PLSSVM_MATMUL_PRECISION": "adaptive"},
                     False),
    "sparse dense tier": ({"PLSSVM_SPARSE_MODE": "dense"}, True),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_learn_spans_split_into_parts(case, monkeypatch):
    env, sparse = SPLIT_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    X, y = _data(sparse)
    svm = _svm(X, y, dtype=np.float32, epsilon=1e-6, max_iter=200, sparse=sparse)
    svm.timings = Timings()
    svm.learn()
    t = svm.timings
    assert set(t.records) == {"setup", "cg"}
    assert set(t.part_summary("setup")) == SETUP_PARTS
    assert set(t.part_summary("cg")) == {"capture"}
    for name in ("setup", "cg"):
        parts = t.part_summary(name)
        assert all(ms >= 0.0 for ms in parts.values())
        assert sum(parts.values()) <= t.summary()[name]
    assert t.part_summary("cg")["capture"] == 0.0  # no CUDA graph on the CPU


def test_timings_keep_parts_apart_from_spans():
    t = Timings()
    t("setup", 5.0)
    t("setup/pad", 2.0)
    t("setup/pad", 1.0)
    t("cg/capture", 0.5)
    assert t.records == {"setup": [5.0]}
    assert t.summary() == {"setup": 5.0}
    assert t.part_summary("setup") == {"pad": 3.0}
    assert t.part_summary("cg") == {"capture": 0.5}
    assert t.part_summary("cli") == {}


def test_cli_spans_split_into_parts(tmp_path, monkeypatch):
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict
    from plssvm_sparse_fp22_tpu_torch.cli.train import main as train
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import write_libsvm_file

    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(60, 8, seed=2)
    data, model, out = tmp_path / "d.libsvm", tmp_path / "d.model", tmp_path / "d.predict"
    write_libsvm_file(data, X, y)
    t = Timings()
    assert train(["-q", "-t", "2", "-e", "1e-6", str(data), str(model)], timings=t) == 0
    assert set(t.records) == {"cli", "setup", "cg"}
    parts = t.part_summary("cli")
    assert set(parts) == {"parse", "learn", "write"}
    assert sum(parts.values()) <= t.summary()["cli"]
    assert t.summary()["setup"] + t.summary()["cg"] <= parts["learn"]
    assert set(t.part_summary("setup")) == SETUP_PARTS
    t = Timings()
    assert predict(["-q", str(data), str(model), str(out)], timings=t) == 0
    parts = t.part_summary("cli")
    assert set(t.records) == {"cli"}
    assert set(parts) == {"parse_model", "parse_data", "predict", "write"}
    assert sum(parts.values()) <= t.summary()["cli"]
    # a failed run records no span
    t = Timings()
    assert predict(["-q", str(data), str(tmp_path / "missing.model"), str(out)],
                   timings=t) == 1
    assert "cli" not in t.records
