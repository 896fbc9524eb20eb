"""The adaptive two-tier CG (``solver/cg.cg_solve_adaptive``) on the CPU,
against the JAX package.

The six solver tests of ``tests/test_adaptive.py:52-137`` run through both
packages on the same system and the same deliberately noisy fast matvec
(its error floor above the tolerance, the failure mode of a too-coarse
tier), each written in its own framework.  Both must take the same number
of iterations on each tier.  The systems are float64 (the suite runs JAX
with x64): in float32 the two frameworks' rounding moved the eps = 0 run's
exit, where the residual underflows to an exact 0, from 33 to 39
iterations (measured), and the noise term ``sin(7919 v)`` turns any
rounding difference in ``v`` into different noise; in float64 both stay at
the rounding level.  ``x`` is held to 1e-8 of its scale.

The product surface: ``PLSSVM_MATMUL_PRECISION=adaptive`` through
``make_csvm`` runs real bf16 tiers on the CPU (the port's plain versions,
the JAX package's interpret-mode Pallas kernels): the dense rbf learn and
the sparse panel learn must meet the accurate-tier residual with accuracy
1.0 in both packages, after the same iterations on each tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu.solver import cg as jcg
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg

from utils import make_blobs


def _spd_system(n=48, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return M @ M.T / n + np.eye(n) * 2.0, rng.normal(size=n), np.ones(n)


def _matvecs(A, mask, level):
    """(jax exact, jax noisy, torch exact, torch noisy) matvecs: ``A v``
    plus a deterministic nonlinear perturbation of relative size ``level``
    (``tests/test_adaptive.py:32-42``)."""
    jA, jm = jnp.asarray(A), jnp.asarray(mask)
    tA, tm = torch.from_numpy(A), torch.from_numpy(mask)
    n = A.shape[0]

    def j_exact(v):
        return jnp.dot(jA, v) * jm

    def j_noisy(v):
        Av = jnp.dot(jA, v)
        return (Av + level * jnp.linalg.norm(Av) * jnp.sin(v * 7919.0) / n ** 0.5) * jm

    def t_exact(v):
        return (tA @ v) * tm

    def t_noisy(v):
        Av = tA @ v
        return (Av + level * torch.linalg.norm(Av) * torch.sin(v * 7919.0) / n ** 0.5) * tm

    return j_exact, j_noisy, t_exact, t_noisy


def _both_adaptive(A, b, mask, level, eps, imax, minv=None, same_tiers=False):
    je, jn, te, tn = _matvecs(A, mask, level)
    if same_tiers:
        jn, tn = je, te
    jres = jcg.cg_solve_adaptive(jn, je, jnp.asarray(b), jnp.asarray(mask), eps, imax,
                                 minv=None if minv is None else jnp.asarray(minv))
    tres = tcg.cg_solve_adaptive(tn, te, torch.from_numpy(b), torch.from_numpy(mask), eps, imax,
                                 minv=None if minv is None else torch.from_numpy(minv))
    assert tres.iterations == int(jres.iterations)
    assert tres.fast_iterations == int(jres.fast_iterations)
    x = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x.numpy(), x, rtol=0, atol=1e-8 * np.abs(x).max())
    return jres, tres


def test_adaptive_escalates_and_converges():
    """Fast tier floors at ~1e-3; both detect it, re-enter on the accurate
    tier, and meet the target the fast tier never could."""
    A, b, mask = _spd_system()
    eps = 1e-5
    _, res = _both_adaptive(A, b, mask, 1e-3, eps, 200)
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    assert res.iterations > res.fast_iterations > 0  # escalated
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b), rtol=2e-3, atol=2e-3)


def test_adaptive_stays_fast_when_sufficient():
    """Identical tiers: the fast stage converges, the accurate residual
    check passes, no escalation; equal to the plain solve."""
    A, b, mask = _spd_system(seed=3)
    eps = 1e-5
    _, res = _both_adaptive(A, b, mask, 0.0, eps, 200, same_tiers=True)
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    assert res.iterations == res.fast_iterations
    _, _, te, _ = _matvecs(A, mask, 0.0)
    ref = tcg.cg_solve(te, torch.from_numpy(b), torch.from_numpy(mask), eps, 200)
    torch.testing.assert_close(res.x, ref.x, rtol=0, atol=0)


def test_adaptive_eps_zero_pins_fast_tier():
    """eps = 0: stagnation and escalation disarm; every iteration runs on
    the fast tier (imax of them unless the residual underflows to 0)."""
    A, b, mask = _spd_system(seed=5)
    _, res = _both_adaptive(A, b, mask, 1e-3, 0.0, 40)
    assert res.iterations == res.fast_iterations
    assert res.iterations == 40 or float(res.delta) == 0.0


def test_stagnation_exit_fires():
    """The stagnation runner alone exits long before imax on a noisy
    matvec with an unreachable target (refresh every step, so delta is the
    noisy true residual and visibly floors)."""
    A, b, mask = _spd_system(seed=7)
    _, jn, _, tn = _matvecs(A, mask, 1e-2)
    js = jcg.cg_run_stagnation(jn, jnp.asarray(b), jnp.asarray(mask), 1e-8, 500,
                               jcg.cg_init(jn, jnp.asarray(b), jnp.asarray(mask)), patience=6,
                               refresh_interval=1)
    bt, mt = torch.from_numpy(b), torch.from_numpy(mask)
    ts = tcg.cg_run_stagnation(tn, bt, mt, 1e-8, 500, tcg.cg_init(tn, bt, mt), patience=6,
                               refresh_interval=1)
    assert ts.k == int(js.k) < 500
    assert float(ts.delta) > 1e-16 * float(ts.delta0)  # stagnated, not converged


def test_stagnation_respects_convergence_and_imax(monkeypatch):
    A, b, mask = _spd_system(seed=9)
    je, _, te, _ = _matvecs(A, mask, 0.0)
    jb, jm = jnp.asarray(b), jnp.asarray(mask)
    bt, mt = torch.from_numpy(b), torch.from_numpy(mask)
    for eps, imax in [(1e-6, 500), (1e-6, 3)]:
        js = jcg.cg_run_stagnation(je, jb, jm, eps, imax, jcg.cg_init(je, jb, jm), patience=6)
        ts = tcg.cg_run_stagnation(te, bt, mt, eps, imax, tcg.cg_init(te, bt, mt), patience=6)
        assert ts.k == int(js.k)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
    assert ts.k == 3
    assert float(tcg.cg_run_stagnation(te, bt, mt, 1e-6, 500, tcg.cg_init(te, bt, mt)).delta) \
        <= 1e-12 * float(ts.delta0)
    # the patience comes from PLSSVM_CG_STAG_PATIENCE when not given
    monkeypatch.setenv("PLSSVM_CG_STAG_PATIENCE", "3")
    assert tcg._default_patience() == jcg._default_patience() == 3
    monkeypatch.setenv("PLSSVM_CG_STAG_PATIENCE", "many")
    assert tcg._default_patience() == tcg.STAGNATION_PATIENCE == 8


def test_adaptive_preconditioned():
    """The adaptive solve composes with the Jacobi preconditioner."""
    A, b, mask = _spd_system(seed=11)
    minv = mask / np.diagonal(A)
    eps = 1e-5
    _, res = _both_adaptive(A, b, mask, 1e-3, eps, 200, minv=minv)
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b), rtol=2e-3, atol=2e-3)


# --- the product surface ----------------------------------------------------------


def _dense_params(mod, Parsed, X, y, **kw):
    p = mod.Parameter(kernel=mod.KernelType.rbf, gamma=1.0 / X.shape[1], cost=1.0,
                      epsilon=1e-6, print_info=False, dtype=np.float32, devices=1, **kw)
    p.data = Parsed(csr=sp.csr_matrix(X), values=y, _dense=X.astype(np.float64))
    p.values = y
    return p


def test_product_surface_adaptive_dense(monkeypatch):
    """``tests/test_adaptive.py:140-167`` through both packages: the dense
    rbf learn in ``implicit`` mode (the port's torch backend caches K while
    it fits, so a 1000-byte budget forces ``implicit``), K1's plain version
    at both tiers against the JAX package's interpret-mode learn: equal
    fast-tier and total iteration counts."""
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    X, y = make_blobs(96, 16, dtype=np.float32)
    jsvm = jp.make_csvm(_dense_params(jp, JParsed, X, y, backend=jp.BackendType.pallas))
    jsvm.learn()
    tsvm = tp.make_csvm(_dense_params(tp, TParsed, X, y, backend=tp.BackendType.torch))
    tsvm.learn()
    ji, ti = jsvm.last_cg_info, tsvm.last_cg_info
    assert ti["mode"] == ji["mode"] == "implicit"
    assert (ti["iterations"], ti["fast_iterations"]) == (ji["iterations"], ji["fast_iterations"])
    assert ti["delta"] <= 1e-12 * ti["delta0"]
    assert tsvm.accuracy() == jsvm.accuracy() == pytest.approx(1.0)


def test_product_surface_adaptive_linear(monkeypatch):
    """The ``linear`` mode takes the plan too: plain products of bf16
    operands on the port (the JAX package's CPU dots ignore the tier, so
    only the contract is compared)."""
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    X, y = make_blobs(96, 16, dtype=np.float32)
    p = _dense_params(tp, TParsed, X, y, backend=tp.BackendType.torch)
    p.kernel, p.max_iter = tp.KernelType.linear, 200  # imax defaults to f = 16
    svm = tp.make_csvm(p)
    svm.learn()
    info = svm.last_cg_info
    assert info["mode"] == "linear" and info["fast_iterations"] >= 1
    assert info["delta"] <= 1e-12 * info["delta0"]
    assert svm.accuracy() == pytest.approx(1.0)


def _separable_sparse(n=300, f=64, density=0.15, seed=21):
    """Sparse non-negative rows, class +1 on the first half of the
    features and class -1 on the second: separable."""
    rng = np.random.default_rng(seed)
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    rows = []
    for label in y:
        mask = rng.random(f // 2) < 2 * density
        mask[rng.integers(f // 2)] = True
        row = np.zeros(f)
        half = slice(0, f // 2) if label > 0 else slice(f // 2, f)
        row[half] = np.where(mask, rng.random(f // 2) + 0.5, 0.0)
        rows.append(row)
    return sp.csr_matrix(np.asarray(rows, np.float32)), y


def test_product_surface_adaptive_sparse_panel(monkeypatch, capsys):
    """The sparse panel tier over two panels with the plan forced: the
    port's torch backend (plain pairs at both tiers) against the JAX
    package's panel learn on its interpret-mode Pallas pair kernel."""
    from plssvm_sparse_fp22_tpu.models.sparse_learn import learn_sparse_panel_jit
    from plssvm_sparse_fp22_tpu.ops.sparse import TiledHybrid, stream_panel_rows

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")  # 256-row panels
    csr, y = _separable_sparse()
    gamma = 0.05
    p = tp.Parameter(kernel=tp.KernelType.rbf, gamma=gamma, epsilon=1e-6, print_info=True,
                     dtype=np.float32, sparse_threshold=1.0, backend=tp.BackendType.torch)
    p.data = TParsed(csr=csr, values=y)
    p.values = y
    tsvm = tp.make_csvm(p)
    tsvm.learn()
    tsvm.print_info = False
    ti = tsvm.last_cg_info
    kf = ti["fast_iterations"]
    assert (f"Adaptive precision: {kf} iterations on the fast bf16 tier, "
            f"{ti['iterations'] - kf} after escalating") in capsys.readouterr().out
    assert ti["mode"] == "sparse_implicit"
    assert ti["delta"] <= 1e-12 * ti["delta0"]
    assert tsvm.accuracy() == pytest.approx(1.0)

    n, dept, D = len(y), len(y) - 1, 512
    th = TiledHybrid.from_csr(csr[:dept], dtype=np.float32, pad_rows=D)
    b = np.zeros(D, np.float32)
    b[:dept] = y[:dept] - y[-1]
    mask = (np.arange(D) < dept).astype(np.float32)
    x_last = csr[-1].toarray().ravel().astype(np.float32)
    panel_rows = stream_panel_rows(D, th.tell.padded_features, 4, 1000)
    assert panel_rows == 256
    # the heavy rows the packing spilled, with their O(n) vectors (base.py:900-907)
    hs, hg = np.zeros(D, np.float32), np.zeros(D, np.float32)
    hrows = csr[th.heavy_idx]
    hs[th.heavy_idx] = np.asarray(hrows.multiply(hrows).sum(axis=1)).ravel()
    hg[th.heavy_idx] = np.asarray((hrows @ csr[-1].T).todense()).ravel()
    out = learn_sparse_panel_jit(
        th.tell.vals, th.tell.lcols, jnp.asarray(x_last), jnp.asarray(b), jnp.asarray(mask),
        jnp.asarray(gamma, np.float32), jnp.asarray(0.0, np.float32),
        jnp.asarray(1.0, np.float32), jnp.asarray(1e-6, np.float32), jnp.asarray(dept),
        kernel=jp.KernelType.rbf, degree=3, ntiles=th.tell.ntiles, Lt=th.tell.Lt,
        panel_rows=panel_rows, use_pallas=True, interpret=True, heavy=th.heavy,
        heavy_rows=tuple(int(r) for r in th.heavy_idx), heavy_sq_vec=jnp.asarray(hs),
        heavy_g_vec=jnp.asarray(hg), mxu_plan=("default", "high"), sweep="unrolled")
    x, s, t, QA_cost, iters, delta, delta0, k_fast = out
    assert float(delta) <= 1e-12 * float(delta0)
    # the fast tier stagnates and both escalate after the same iterations
    assert (ti["fast_iterations"], ti["iterations"]) == (int(k_fast), int(iters))
    assert ti["escalated"]
    # the JAX package's model from its x: alphas, bias (csvm.cpp:257-258)
    jalphas = np.concatenate([np.asarray(x, np.float64)[:dept], [-float(s)]])
    jbias = float(y[-1]) + float(QA_cost) * float(s) - float(t)
    np.testing.assert_allclose(tsvm.alphas, jalphas, rtol=0, atol=1e-3 * np.abs(jalphas).max())
    state = {"kernel": 2, "degree": 3, "gamma": gamma, "coef0": 0.0, "alphas": jalphas,
             "bias_": jbias, "support_vectors": csr, "values": y, "sparse_threshold": 1.0}
    assert tp.csvm_from_state(state, print_info=False).accuracy() == pytest.approx(1.0)
