"""The port's CG against the JAX package's, on the CPU.

Both solvers get the same explicit SPD matrix as their A·v, so they differ
only in the solver.  ``imax`` runs past the residual refresh at k = 49 (and
k = 99); iteration counts must be equal and ``x`` equal to rtol 1e-10 in
float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu.solver import cg as jcg
from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg


def _spd(D=1000, dept=990, cond=100.0, seed=0):
    """SPD matrix on the first ``dept`` entries (zero padding after).  Its
    eigenvalues spread evenly over [1, cond]: CG then needs ~76 steps to
    reach eps = 1e-8, and rounding differences between the two solvers stay
    at the rounding level along the way (a geometric spread makes CG
    amplify them past 1e-3 within 30 steps, in either package)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(dept, dept)))
    A = np.zeros((D, D))
    A[:dept, :dept] = (Q * np.linspace(1.0, cond, dept)) @ Q.T
    b = np.zeros(D)
    b[:dept] = rng.normal(size=dept)
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return A, b, mask


def _solve_both(A, b, mask, eps, imax, minv=None):
    jA = jnp.asarray(A)
    tA = torch.from_numpy(A)
    jres = jcg.cg_solve(lambda v: jA @ v, jnp.asarray(b), jnp.asarray(mask), eps, imax,
                        minv=None if minv is None else jnp.asarray(minv))
    tres = tcg.cg_solve(lambda v: tA @ v, torch.from_numpy(b), torch.from_numpy(mask), eps,
                        imax, minv=None if minv is None else torch.from_numpy(minv))
    return jres, tres


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("imax", [49, 50, 51, 120])
def test_cg_pinned_iterations_cross_the_refresh(precond, imax):
    """eps = 0: both run exactly imax steps, across k = 49 (and 99)."""
    A, b, mask = _spd()
    minv = mask / np.where(mask > 0, np.diag(A), 1.0) if precond == "jacobi" else None
    jres, tres = _solve_both(A, b, mask, 0.0, imax, minv)
    assert tres.iterations == int(jres.iterations) == imax
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jres.x)).max())
    # at imax = 120 the residual sits near the rounding floor (~1e-18)
    assert float(tres.delta) == pytest.approx(float(jres.delta), rel=1e-5)
    assert float(tres.delta0) == pytest.approx(float(jres.delta0), rel=1e-12)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("eps", [1e-3, 1e-8])
def test_cg_converges_in_the_same_iteration(precond, eps):
    A, b, mask = _spd(seed=1)
    minv = mask / np.where(mask > 0, np.diag(A), 1.0) if precond == "jacobi" else None
    jres, tres = _solve_both(A, b, mask, eps, 500, minv)
    assert tres.iterations == int(jres.iterations) < 500
    assert float(tres.delta) <= eps * eps * float(tres.delta0)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jres.x)).max())
    np.testing.assert_array_equal(tres.x.numpy()[990:], np.zeros(10))


def test_cg_init_state_matches_jax():
    A, b, mask = _spd(seed=2)
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    js = jcg.cg_init(lambda v: jA @ v, jnp.asarray(b), jnp.asarray(mask))
    ts = tcg.cg_init(lambda v: tA @ v, torch.from_numpy(b), torch.from_numpy(mask))
    assert ts.k == int(js.k) == 0
    for name in ("x", "r", "d"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-12)


def test_cg_run_resumes_where_it_stopped():
    """Two cg_run legs (40 + 40 steps) equal one 80-step run: the
    iteration counter keeps the refresh at k = 49 aligned."""
    A, b, mask = _spd(seed=3)
    tA = torch.from_numpy(A)
    mv = lambda v: tA @ v  # noqa: E731
    bt, mt = torch.from_numpy(b), torch.from_numpy(mask)
    state = tcg.cg_init(mv, bt, mt)
    one = tcg.cg_run(mv, bt, mt, 0.0, 80, state)
    two = tcg.cg_run(mv, bt, mt, 0.0, 80, tcg.cg_run(mv, bt, mt, 0.0, 40, state))
    assert one.k == two.k == 80
    torch.testing.assert_close(one.x, two.x, rtol=0, atol=0)
