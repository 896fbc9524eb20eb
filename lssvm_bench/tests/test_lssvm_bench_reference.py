"""The plain reference: its kernel rows in blocks and over several devices
agree with the kept matrix, its CG meets the stopping rule, its lower
precisions round as TF32 and bf16 do."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lssvm_bench.reference.lssvm import System, decision_values, round_mantissa  # noqa: E402


def problem(n=401, f=7, seed=1):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(n, f, generator=g, dtype=torch.float64)
    y = np.where(torch.rand(n, generator=g).numpy() < 0.3, 1.0, -1.0)
    return X, y


def test_blocks_over_devices_equal_the_kept_matrix():
    X, y = problem()
    kept = System(X, y, kernel="rbf", gamma=0.2)
    spread = System(X, y, kernel="rbf", gamma=0.2, cache_bytes=0, block_bytes=8 * 400 * 29,
                    spread=["cpu", "cpu", "cpu"])
    assert kept.K is not None and spread.K is None and len(spread.shares) == 3
    v = torch.randn(400, dtype=torch.float64)
    torch.testing.assert_close(kept.matvec(v, 2.0), spread.matvec(v, 2.0), rtol=1e-13,
                               atol=1e-13)


def test_matvec_is_the_reduced_system():
    """A v = K v + QA sum(v) - sum(v) q - (q.v) + v / C, written out whole."""
    X, y = problem(n=60)
    s = System(X, y, kernel="rbf", gamma=0.3)
    K = torch.exp(-0.3 * torch.cdist(X, X) ** 2)
    m, C = 59, 4.0
    A = (K[:m, :m] + K[m, m] + 1 / C - K[:m, m][:, None] - K[:m, m][None, :]
         + torch.eye(m, dtype=torch.float64) / C)
    v = torch.randn(m, dtype=torch.float64)
    torch.testing.assert_close(s.matvec(v, C), A @ v, rtol=1e-12, atol=1e-12)
    x = torch.linalg.solve(A, s.b)
    assert s.bias(x, C) == pytest.approx(y[-1] + (K[m, m] + 1 / C) * float(x.sum())
                                         - float(K[:m, m] @ x))


def test_cg_meets_its_stopping_rule():
    X, y = problem()
    s = System(X, y, kernel="rbf", gamma=0.2)
    x, k, delta, delta0 = s.solve(1.0, 1e-8, 1000)
    r = s.residual(x, 1.0)
    assert 0 < k < 1000 and delta <= 1e-16 * delta0
    assert float(r @ r) == pytest.approx(delta, rel=1e-3)
    x2, k2, _, _ = s.solve(1.0, 1e-8, 3)
    assert k2 == 3


@pytest.mark.parametrize("bits, value, want", [
    (10, 1.0 + 2.0 ** -11, 1.0),  # a tie rounds to even
    (10, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),
    (7, 1.0 + 2.0 ** -9, 1.0),
    (7, -(1.0 + 2.0 ** -7), -(1.0 + 2.0 ** -7)),
])
def test_round_mantissa(bits, value, want):
    t = torch.tensor([value], dtype=torch.float32)
    assert float(round_mantissa(t, bits)[0]) == want


def test_decision_values():
    X, _ = problem(n=50)
    P = torch.randn(30, 7, dtype=torch.float64)
    a = np.linspace(-1, 1, 50)
    K = torch.exp(-0.5 * torch.cdist(P, X) ** 2).numpy()
    got = decision_values(X.numpy(), a, 0.25, P.numpy(), kernel="rbf", gamma=0.5,
                          block_bytes=8 * 50 * 7)
    np.testing.assert_allclose(got, K @ a + 0.25, rtol=1e-12)
