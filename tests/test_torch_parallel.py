"""The port's row-sharded learn on logical CPU shards.

Mirrors ``test_sharded_learn_matches_single_device``,
``test_sharded_implicit_pallas_ring`` and ``test_sharded_matvec_determinism``
of ``tests/test_parallel.py``: the same padded system goes through the port's
``make_sharded_learn`` over 2, 4 and 8 logical shards of the CPU, through the
port's single-device operator and CG, and through the JAX package's
``make_sharded_learn`` on its virtual CPU devices.

Tolerances.  Sharding changes the order of the sums (per-shard partials added
in shard order), and CG from x0 = 1 amplifies that, so the parity checks stop
early (eps 1e-2: two to four iterations) and hold iterations equal and the
solution to 1e-9 of its scale in float64 (measured <= 3e-12); converged runs
(eps 1e-6) are held to the numpy oracle at 1e-4, as the JAX package's own
test does.  float32 tiers are compared matvec by matvec at 1e-5 of the
result's scale (same operands, another order of f32 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plssvm_sparse_fp22_tpu.parallel.sharded import (make_sharded_learn as jax_sharded_learn,
                                                     make_sharded_predict as jax_sharded_predict,
                                                     make_sharded_w as jax_sharded_w,
                                                     shard_system as jax_shard_system)
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
from plssvm_sparse_fp22_tpu_torch.ops.matvec import (build_operator, choose_mode,
                                                     choose_sharded_mode, jacobi_minv)
from plssvm_sparse_fp22_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from plssvm_sparse_fp22_tpu_torch.parallel.sharded import (_build_local_matvec, _psum_dot,
                                                           make_sharded_learn,
                                                           make_sharded_learn_fns,
                                                           make_sharded_predict, make_sharded_w,
                                                           shard_rows, shard_system)
from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve, cg_solve_adaptive
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType
from plssvm_sparse_fp22_tpu_torch.utils import oracle

from utils import make_blobs

HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
COST = 2.0
#: every (kernel, mode) the sharded learn supports
CASES = [(KernelType.linear, "linear"), (KernelType.linear, "cached"),
         (KernelType.linear, "implicit"), (KernelType.polynomial, "cached"),
         (KernelType.polynomial, "implicit"), (KernelType.rbf, "cached"),
         (KernelType.rbf, "implicit")]
CASE_IDS = [f"{k.name}-{m}" for k, m in CASES]


def _padded_system(n=97, f=12, D=128, seed=5, dtype=np.float64):
    X, y = make_blobs(n, f, seed=seed)
    dept = n - 1
    X_pad = np.zeros((D, f), dtype)
    X_pad[:dept] = X[:dept]
    b_pad = np.zeros(D, dtype)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D, dtype)
    mask[:dept] = 1.0
    return X.astype(dtype), y, X_pad, b_pad, mask, dept


def _sharded(kernel, mode, ndev, system, eps, imax, **kw):
    X, y, X_pad, b_pad, mask, dept = system
    mesh = make_mesh(ndev, devices=["cpu"])
    learn = make_sharded_learn(mesh, kernel, HYPER["degree"], mode, **kw)
    Xs, b, m = shard_system(mesh, X_pad, b_pad, mask)
    return learn(Xs, torch.from_numpy(X[-1]), b, m, HYPER["gamma"], HYPER["coef0"], COST,
                 eps, imax)


def _single_system(kernel, system, precond="none"):
    """The single-device system's pieces: ``(Xd, b, m, q, QA, cost_inv, minv)``."""
    X, y, X_pad, b_pad, mask, dept = system
    Xd, b, m = (torch.from_numpy(a) for a in (X_pad, b_pad, mask))
    xl = torch.from_numpy(X[-1])
    cost_inv = torch.tensor(1.0 / COST, dtype=Xd.dtype)
    q = gram_block(kernel, Xd, xl[None, :], **HYPER)[:, 0] * m
    QA = kernel_scalar(kernel, xl, xl, **HYPER) + cost_inv
    minv = None
    if precond == "jacobi":
        minv = jacobi_minv(kernel, Xd, q, m, QA, cost_inv, HYPER["degree"], HYPER["gamma"],
                           HYPER["coef0"])
    return Xd, b, m, q, QA, cost_inv, minv


def _single(kernel, mode, system, eps, imax, precond="none"):
    Xd, b, m, q, QA, cost_inv, minv = _single_system(kernel, system, precond)
    op = build_operator(kernel, Xd, q, m, QA, cost_inv, mode=mode, **HYPER)
    return cg_solve(op.matvec, b, m, eps, imax, minv=minv)


def _jax_sharded(kernel, mode, ndev, system, eps, imax, **kw):
    X, y, X_pad, b_pad, mask, dept = system
    mesh = jax_make_mesh(ndev)
    learn = jax_sharded_learn(mesh, JKernel(int(kernel)), HYPER["degree"], mode, **kw)
    Xs, bs, ms = jax_shard_system(mesh, X_pad, b_pad, mask)
    f64 = jnp.float64
    return learn(Xs, jnp.asarray(X[-1]), bs, ms, f64(HYPER["gamma"]), f64(HYPER["coef0"]),
                 f64(COST), f64(eps), jnp.int32(imax))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def test_mesh_is_an_ordered_device_list():
    assert DATA_AXIS == "data"
    assert make_mesh(3, devices=["cpu"]) == [torch.device("cpu")] * 3
    assert make_mesh(devices=["cpu"]) == [torch.device("cpu")]
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_mesh(1, devices=two) == two[:1]
    assert make_mesh(4, devices=two) == two + two  # more shards than devices: logical
    if not torch.cuda.is_available():
        assert make_mesh() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, devices=["cpu"])


@pytest.mark.parametrize("kernel,mode", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_learn_matches_single_device(kernel, mode, ndev):
    system = _padded_system()
    X, y, X_pad, b_pad, mask, dept = system

    # early stop: the port's shards against its one device and the JAX package's shards
    x, s, t, QA, iters, delta, delta0 = _sharded(kernel, mode, ndev, system, 1e-2, 60)
    ref = _single(kernel, mode, system, 1e-2, 60)
    assert iters == ref.iterations >= 1
    _close(x, ref.x, 1e-9)
    jx, js, jt, jQA, jiters, jdelta, jdelta0 = _jax_sharded(kernel, mode, ndev, system, 1e-2, 60)
    assert iters == int(jiters)
    _close(x, jx, 1e-9)
    assert float(s) == pytest.approx(float(js), rel=1e-9, abs=1e-9)
    assert float(t) == pytest.approx(float(jt), rel=1e-9, abs=1e-9)
    assert float(QA) == pytest.approx(float(jQA), rel=1e-12)
    assert float(delta0) == pytest.approx(float(jdelta0), rel=1e-9)
    assert not x[dept:].any()  # padding stays zero

    # converged: against the numpy oracle, as tests/test_parallel.py
    eps, imax = 1e-6, 60
    x, s, t, QA, iters, delta, delta0 = _sharded(kernel, mode, ndev, system, eps, imax)
    alpha_ref, bias_ref, info = oracle.solve_lssvm(X, y, kernel=kernel, cost=COST, epsilon=eps,
                                                   max_iter=imax, **HYPER)
    assert abs(iters - info["iterations"]) <= 2
    np.testing.assert_allclose(x.numpy()[:dept], alpha_ref[:dept], rtol=1e-4, atol=1e-4)
    bias = float(y[-1]) + float(QA) * float(s) - float(t)
    assert bias == pytest.approx(bias_ref, rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_implicit_pallas_ring(ndev):
    """The ring of the ``implicit`` mode, hop by hop through K2's plain
    version, against the JAX package's ring with the fused Pallas kernel per
    hop (on float64 that is its exact XLA hop) and the numpy oracle."""
    system = _padded_system()
    X, y, X_pad, b_pad, mask, dept = system
    eps, imax = 1e-6, 60
    gm.reset_launches()
    x = _sharded(KernelType.rbf, "implicit", ndev, system, eps, imax)[0]
    assert not any(gm.launches.values())  # CPU tensors: the plain version, no kernel
    jx = _jax_sharded(KernelType.rbf, "implicit", ndev, system, eps, imax, use_pallas=True)[0]
    alpha_ref, _, _ = oracle.solve_lssvm(X, y, kernel=KernelType.rbf, cost=COST, epsilon=eps,
                                         max_iter=imax, **HYPER)
    np.testing.assert_allclose(x.numpy()[:dept], alpha_ref[:dept], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", ["exact", "bf16x3", "bf16cast"])
@pytest.mark.parametrize("kernel", list(KernelType), ids=lambda k: k.name)
@pytest.mark.parametrize("ndev", [2, 4])
def test_ring_hops_at_each_tier_match_the_single_device_operator(tier, kernel, ndev):
    """float32: every hop is K2's plain version at the tier, on operands
    prepared once per operator; p squared hops give the single-device A·v."""
    system = _padded_system(dtype=np.float32)
    X, y, X_pad, b_pad, mask, dept = system
    Xd, b, m, q, QA, cost_inv, _ = _single_system(kernel, system)
    mesh = make_mesh(ndev, devices=["cpu"])
    Xs, _, _ = shard_system(mesh, X_pad, b_pad, mask)
    gm.reset_preparations()
    mv = _build_local_matvec(kernel, mesh, Xs, q, m, QA, cost_inv, HYPER["degree"],
                             HYPER["gamma"], HYPER["coef0"], "implicit", precision=tier)
    rng = np.random.default_rng(1)
    vs = [torch.from_numpy(rng.normal(size=len(b)).astype(np.float32)) * m for _ in range(2)]
    got = [mv(v) for v in vs]
    assert gm.preparations[tier] == ndev  # one split or cast per shard, none per A·v
    op = build_operator(kernel, Xd, q, m, QA, cost_inv, mode="implicit", precision=tier, **HYPER)
    for g, v in zip(got, vs):
        _close(g, op.matvec(v), 1e-5)
        assert not g[dept:].any()
    if tier != "exact":
        exact = build_operator(kernel, Xd, q, m, QA, cost_inv, mode="implicit",
                               precision="exact", **HYPER).matvec(vs[0])
        _close(got[0], exact, {"bf16x3": 1e-3, "bf16cast": 3e-2}[tier])


@pytest.mark.parametrize("kernel,mode", [(KernelType.linear, "linear"),
                                         (KernelType.rbf, "implicit")])
@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_learn_under_the_adaptive_plan(kernel, mode, ndev):
    """``mxu_plan``: the two-tier CG over the sharded operator at two tiers
    equals the single-device two-tier CG (float32, real bf16 rounding)."""
    system = _padded_system(dtype=np.float32)
    X, y, X_pad, b_pad, mask, dept = system
    eps, imax = 1e-3, 60
    out = _sharded(kernel, mode, ndev, system, eps, imax, mxu_plan=("default", "high"))
    assert len(out) == 8
    x, s, t, QA, iters, delta, delta0, k_fast = out
    Xd, b, m, q, QA1, cost_inv, _ = _single_system(kernel, system)

    def op(tier):
        return build_operator(kernel, Xd, q, m, QA1, cost_inv, mode=mode, precision=tier,
                              **HYPER).matvec

    ref = cg_solve_adaptive(op("bf16cast"), op("bf16x3"), b, m, eps, imax)
    assert float(delta) <= eps * eps * float(delta0)
    assert (iters, k_fast) == (ref.iterations, ref.fast_iterations)
    _close(x, ref.x, 1e-3)  # measured <= 5e-4: float32 CG, another order of sums
    if kernel == KernelType.linear:
        # a tighter target makes the bf16cast leg stagnate: the sharded learn
        # escalates to bf16x3 and ends on that tier's residual
        eps = 1e-4
        x, s, t, QA, iters, delta, delta0, k_fast = _sharded(
            kernel, mode, ndev, system, eps, imax, mxu_plan=("default", "high"))
        assert k_fast < iters <= imax
        assert float(delta) <= eps * eps * float(delta0)
        alpha_ref, _, _ = oracle.solve_lssvm(X.astype(np.float64), y, kernel=kernel, cost=COST,
                                             epsilon=eps, max_iter=imax, **HYPER)
        np.testing.assert_allclose(x.numpy()[:dept], alpha_ref[:dept], rtol=0,
                                   atol=0.1 * np.abs(alpha_ref).max())
    # without a plan the learn returns seven values
    assert len(_sharded(kernel, mode, ndev, system, eps, imax)) == 7


@pytest.mark.parametrize("kernel,mode", [(KernelType.linear, "linear"),
                                         (KernelType.polynomial, "cached"),
                                         (KernelType.rbf, "implicit")])
@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_jacobi(kernel, mode, ndev):
    system = _padded_system()
    out = _sharded(kernel, mode, ndev, system, 1e-2, 60, precond="jacobi")
    ref = _single(kernel, mode, system, 1e-2, 60, precond="jacobi")
    assert out[4] == ref.iterations
    _close(out[0], ref.x, 1e-9)
    jout = _jax_sharded(kernel, mode, ndev, system, 1e-2, 60, precond="jacobi")
    assert out[4] == int(jout[4])
    _close(out[0], jout[0], 1e-9)
    # the preconditioner changes the iterates, not the system
    plain = _sharded(kernel, mode, ndev, system, 1e-2, 60)
    assert float(plain[6]) == float(out[6])


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_matvec_determinism(ndev):
    """Same mesh, same inputs: bitwise identical results across calls (the
    partials are summed in shard order)."""
    system = _padded_system()
    out1 = _sharded(KernelType.rbf, "implicit", ndev, system, 1e-6, 60)
    out2 = _sharded(KernelType.rbf, "implicit", ndev, system, 1e-6, 60)
    assert torch.equal(out1[0], out2[0])
    assert float(out1[5]) == float(out2[5])
    a, b = torch.arange(16.0), torch.ones(16)
    assert float(_psum_dot(a, b, ndev)) == 120.0


@pytest.mark.parametrize("kernel,mode", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_setup_and_chunks_equal_one_shot(kernel, mode, precond):
    """``make_sharded_learn_fns``: set-up plus chunks of 3 iterations is the
    one-shot learn bit for bit, and a pair builds its operator once."""
    system = _padded_system()
    X, y, X_pad, b_pad, mask, dept = system
    eps, imax, ndev = 1e-6, 60, 4
    one = _sharded(kernel, mode, ndev, system, eps, imax, precond=precond)
    mesh = make_mesh(ndev, devices=["cpu"])
    Xs, b, m = shard_system(mesh, X_pad, b_pad, mask)
    xl = torch.from_numpy(X[-1])
    scalars = (HYPER["gamma"], HYPER["coef0"], COST)
    setup, chunk = make_sharded_learn_fns(mesh, kernel, HYPER["degree"], mode, precond=precond)
    gm.reset_preparations()
    q, QA, state = setup(Xs, xl, b, m, *scalars)
    assert state.k == 0 and state.x.shape == (128,)
    built = dict(gm.preparations)
    state0, first = state, chunk(Xs, b, m, xl, *scalars, eps, 3, state)
    target = eps * eps * float(state.delta0)
    while state.k < imax and float(state.delta) > target:
        state = chunk(Xs, b, m, xl, *scalars, eps, min(state.k + 3, imax), state)
    assert state.k == one[4]
    assert torch.equal(state.x, one[0])
    assert float(state.delta) == float(one[5]) and float(QA) == float(one[3])
    if mode == "implicit":
        assert gm.preparations == built  # no operand was prepared again per chunk
    # a pair whose first call is a chunk (a resumed learn) builds the operator there
    _, chunk2 = make_sharded_learn_fns(mesh, kernel, HYPER["degree"], mode, precond=precond)
    again = chunk2(Xs, b, m, xl, *scalars, eps, 3, state0)
    assert again.k == first.k == 3 and torch.equal(again.x, first.x)


@pytest.mark.parametrize("kernel", list(KernelType), ids=lambda k: k.name)
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_predict_and_w(kernel, ndev):
    rng = np.random.default_rng(2)
    X, _ = make_blobs(96, 12, seed=5)
    alphas = rng.normal(size=96)
    P, _ = make_blobs(20, 12, seed=8)
    bias = 0.25
    mesh = make_mesh(ndev, devices=["cpu"])
    Xs, a_s = shard_rows(mesh, X), shard_rows(mesh, alphas)
    got = make_sharded_predict(mesh, kernel, HYPER["degree"])(
        torch.from_numpy(P), Xs, a_s, torch.tensor(bias, dtype=torch.float64),
        HYPER["gamma"], HYPER["coef0"])
    want = oracle.predict_values(X, alphas, bias, P, kernel=kernel, **HYPER)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    jmesh = jax_make_mesh(ndev)
    jXs, jas, _ = jax_shard_system(jmesh, X, alphas, alphas)
    jgot = jax_sharded_predict(jmesh, JKernel(int(kernel)), HYPER["degree"])(
        jnp.asarray(P), jXs, jas, jnp.float64(bias), jnp.float64(HYPER["gamma"]),
        jnp.float64(HYPER["coef0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-10, atol=1e-10)
    w = make_sharded_w(mesh)(Xs, a_s)
    np.testing.assert_allclose(w.numpy(), X.T @ alphas, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jax_sharded_w(jmesh)(jXs, jas)),
                               rtol=1e-12, atol=1e-12)


def test_shard_system_places_equal_row_blocks():
    X, y, X_pad, b_pad, mask, dept = _padded_system()
    mesh = make_mesh(4, devices=["cpu"])
    Xs, b, m = shard_system(mesh, X_pad, b_pad, mask)
    assert [tuple(x.shape) for x in Xs] == [(32, 12)] * 4
    assert all(x.is_contiguous() and x.dtype == torch.float64 for x in Xs)
    np.testing.assert_array_equal(torch.cat(Xs).numpy(), X_pad)
    assert b.shape == m.shape == (128,)
    Xs32, b32, _ = shard_system(mesh, X_pad, b_pad, mask, dtype=torch.float32)
    assert Xs32[0].dtype == b32.dtype == torch.float32
    with pytest.raises(ValueError, match="do not divide evenly"):
        shard_system(make_mesh(3, devices=["cpu"]), X_pad, b_pad, mask)
    learn = make_sharded_learn(mesh, KernelType.rbf, 3, "implicit")
    with pytest.raises(ValueError, match="row blocks for a mesh"):
        learn(Xs[:2], torch.from_numpy(X[-1]), b, m, 0.1, 1.0, COST, 1e-6, 10)
    with pytest.raises(PLSSVMError, match="backend 'cuda' needs the system on CUDA devices"):
        make_sharded_learn(mesh, KernelType.rbf, 3, "implicit", backend=BackendType.cuda)(
            Xs, torch.from_numpy(X[-1]), b, m, 0.1, 1.0, COST, 1e-6, 10)
    with pytest.raises(ValueError, match="unknown sharded matvec mode"):
        make_sharded_learn(mesh, KernelType.rbf, 3, "ring")(
            Xs, torch.from_numpy(X[-1]), b, m, 0.1, 1.0, COST, 1e-6, 10)


def test_choose_sharded_mode_applies_the_budget_per_device(monkeypatch):
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", str(1000 * 1000 * 8))
    f64 = torch.float64
    assert choose_mode(KernelType.rbf, 1000, f64) == "cached"
    assert choose_mode(KernelType.rbf, 1500, f64) == "implicit"
    assert choose_sharded_mode(KernelType.rbf, 1500, f64, 4) == "cached"
    assert choose_sharded_mode(KernelType.rbf, 2001, f64, 4) == "implicit"
    assert choose_sharded_mode(KernelType.linear, 10**6, f64, 4) == "linear"
    # narrow float32 data on the cuda backend recomputes the Gram matrix
    assert choose_sharded_mode(KernelType.rbf, 100, torch.float32, 2, num_features=64,
                               backend=BackendType.cuda) == "implicit"
