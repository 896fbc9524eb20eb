"""The CUDA kernels on the card: K1, K2 and K3 against their plain PyTorch
versions at every precision tier, determinism, launch counts, the wrappers'
checks, a small learn/predict on the ``cuda`` backend against the ``torch``
backend, a streaming sparse learn through K3, and the adaptive two-tier
learn.

Every test needs a CUDA device and skips without one.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
from plssvm_sparse_fp22_tpu_torch.models import make_csvm
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.params import Parameter
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

pytestmark = pytest.mark.cuda

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
#: exact-f32 budget relative to the result's scale (test_solver.py:133-134):
#: kernel and plain version differ only in summation order
TOL = 1e-5
#: a bf16 tier against its plain version: the same exact products of the
#: same bf16 operands, but the tensor core's f32 accumulation does not round
#: to nearest at every add, and bf16x3 sums three products per entry (up to
#: 1.5e-5 measured at f = 4096 on an H100), so the budget is chip_smoke's
TIER_TOL = 1e-4
BF16_TIERS = ["bf16x3", "bf16cast"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hyper(f):
    return {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _counts(**nonzero):
    """The launch counters with the given ``<kernel>__<tier>`` entries."""
    want = {key: 0 for key in gm.launches}
    want.update({key.replace("__", "/"): n for key, n in nonzero.items()})
    return want


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(40, 5), (96, 33), (64, 7), (300, 130), (257, 256)])
def test_k1_matches_plain(dev, kernel, shape):
    D, f = shape
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
    got = gm.gram_matvec_sym(kernel, X, v, **_hyper(f))
    want = gm.gram_matvec_sym_plain(kernel, X, v, **_hyper(f))
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 256, 300), (40, 5, 129), (200, 33, 64)])
def test_k2_matches_plain(dev, kernel, shape):
    D, f, N = shape
    rng = np.random.default_rng(4)
    P = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(N, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    got = gm.gram_matvec(kernel, P, a, Y=Y, **_hyper(f))
    want = gm.gram_matvec_plain(kernel, P, a, Y=Y, **_hyper(f))
    assert _rel_err(got, want) <= TOL


def test_kernels_are_deterministic_and_counted(dev):
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.normal(size=(700, 40)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=700), dtype=torch.float32, device=dev)
    gm.reset_launches()
    a = gm.gram_matvec_sym(KernelType.rbf, X, v, gamma=0.05)
    b = gm.gram_matvec_sym(KernelType.rbf, X, v, gamma=0.05)
    c = gm.gram_matvec(KernelType.rbf, X, v, gamma=0.05)
    d = gm.gram_matvec(KernelType.rbf, X, v, gamma=0.05)
    assert torch.equal(a, b) and torch.equal(c, d)
    assert gm.launches == _counts(gram_matvec_sym__exact=2, gram_matvec_rect__exact=2)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(40, 40, 5), (300, 170, 100), (256, 512, 64), (129, 1, 33)])
def test_k3_matches_plain(dev, kernel, shape):
    Di, Dj, f = shape
    rng = np.random.default_rng(7)
    Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32, device=dev)
    vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
    kw = dict(same=False, **_hyper(f))
    oi, oj = gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, **kw)
    wi, wj = gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, **kw)
    assert _rel_err(oi, wi) <= TOL and _rel_err(oj, wj) <= TOL


def test_k3_is_deterministic_and_counted(dev):
    rng = np.random.default_rng(8)
    Xi = torch.tensor(rng.normal(size=(700, 40)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(500, 40)), dtype=torch.float32, device=dev)
    vi = torch.tensor(rng.normal(size=700), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=500), dtype=torch.float32, device=dev)
    gm.reset_launches()
    a = gm.pair_gram_contrib(KernelType.rbf, Xi, Xj, vi, vj, same=False, gamma=0.05)
    b = gm.pair_gram_contrib(KernelType.rbf, Xi, Xj, vi, vj, same=False, gamma=0.05)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # same=True is K1 on the panel, counted there
    s_i, s_j = gm.pair_gram_contrib(KernelType.rbf, Xi, Xi, vi, vi, same=True, gamma=0.05)
    assert not s_j.any()
    assert _rel_err(s_i, gm.gram_matvec_sym_plain(KernelType.rbf, Xi, vi, gamma=0.05)) <= TOL
    assert gm.launches == _counts(gram_matvec_sym__exact=1, gram_pair_contrib__exact=2)


def test_sparse_implicit_learn_runs_k3(dev, monkeypatch):
    """The streaming panel learn on the cuda backend, over several panels,
    launches K3 for the cross-panel pairs and matches the torch backend
    (both on the exact tier: the plan is off when a tier is pinned)."""
    import scipy.sparse as sp_

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "highest")
    monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", str(8 * 256 * 512 * 4))  # 256-row panels
    rng = np.random.default_rng(9)
    csr = sp_.random(700, 500, density=0.05, format="csr", random_state=rng,
                     data_rvs=lambda k: rng.random(k))
    y = np.where(rng.normal(size=700) > 0, 1.0, -1.0)
    out = {}
    for backend in (BackendType.cuda, BackendType.torch):
        p = Parameter(kernel=KernelType.rbf, gamma=0.1, epsilon=1e-6, max_iter=100,
                      dtype=np.float32, backend=backend, print_info=False, sparse_threshold=1.0)
        p.data = ParsedData(csr=csr, values=y)
        p.values = y
        svm = make_csvm(p)
        gm.reset_launches()
        svm.learn()
        out[backend] = (svm.last_cg_info, svm.alphas, dict(gm.launches))
    info_c, alphas_c, launches_c = out[BackendType.cuda]
    info_t, alphas_t, launches_t = out[BackendType.torch]
    assert info_c["mode"] == info_t["mode"] == "sparse_implicit"
    assert launches_c["gram_pair_contrib/exact"] > 0 and launches_c["gram_matvec_sym/exact"] > 0
    assert not any(launches_t.values())
    assert abs(info_c["iterations"] - info_t["iterations"]) <= 1
    np.testing.assert_allclose(alphas_c, alphas_t, rtol=0, atol=1e-2 * np.abs(alphas_t).max())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    X = torch.ones((8, 4), dtype=torch.float64, device=dev)
    with pytest.raises(PLSSVMError, match="float32 only"):
        gm.gram_matvec_sym(KernelType.rbf, X, torch.ones(8, dtype=torch.float64, device=dev))
    X32 = torch.ones((4, 8), dtype=torch.float32, device=dev).T
    with pytest.raises(PLSSVMError, match="contiguous"):
        gm.gram_matvec(KernelType.linear, X32, torch.ones(4, device=dev),
                       Y=torch.ones((4, 4), device=dev))


@pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
def test_learn_predict_cuda_backend_matches_torch_backend(dev, kernel, monkeypatch):
    """On the exact tier (pinned: the cuda backend's default is the
    adaptive plan)."""
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "highest")
    rng = np.random.default_rng(6)
    n, f = 300, 16
    X = np.concatenate([rng.normal(1.0, 1.0, (n // 2, f)), rng.normal(-1.0, 1.0, (n // 2, f))])
    y = np.concatenate([np.ones(n // 2), -np.ones(n // 2)])
    out = {}
    for backend in (BackendType.cuda, BackendType.torch):
        p = Parameter(kernel=kernel, gamma=1.0 / f, coef0=1.0, epsilon=1e-6, max_iter=200,
                      dtype=np.float32, backend=backend, print_info=False,
                      sparse_threshold=0.0)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        gm.reset_launches()
        svm.learn()
        dec = svm.predict(X)
        out[backend] = (svm.last_cg_info, svm.alphas, dec, dict(gm.launches))
    info_c, alphas_c, dec_c, launches_c = out[BackendType.cuda]
    info_t, alphas_t, dec_t, launches_t = out[BackendType.torch]
    # f <= 320: the cuda backend recomputes K (K1), the torch backend caches it
    assert (info_c["mode"], info_t["mode"]) == ("implicit", "cached")
    assert abs(info_c["iterations"] - info_t["iterations"]) <= 1
    # float32 CG carries the two operators' rounding (~1e-6 relative) up by
    # the system's condition number; at eps = 1e-6 that reaches ~3e-3 of
    # the alphas' scale (measured on the H100), so the budget is 1e-2
    np.testing.assert_allclose(alphas_c, alphas_t, rtol=0, atol=1e-2 * np.abs(alphas_t).max())
    np.testing.assert_array_equal(np.sign(dec_c), np.sign(dec_t))
    assert launches_c["gram_matvec_sym/exact"] > 0 and launches_c["gram_matvec_rect/exact"] == 1
    assert not any(launches_t.values())


# --- the bf16 tiers ---------------------------------------------------------------


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(40, 5), (300, 130), (257, 256)])
def test_k1_tiers_match_plain(dev, kernel, tier, shape):
    D, f = shape
    rng = np.random.default_rng(13)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
    got = gm.gram_matvec_sym(kernel, X, v, tier=tier, **_hyper(f))
    want = gm.gram_matvec_sym_plain(kernel, X, v, tier=tier, **_hyper(f))
    assert _rel_err(got, want) <= TIER_TOL
    exact = gm.gram_matvec_sym(kernel, X, v, tier="exact", **_hyper(f))
    assert _rel_err(got, exact) <= (1e-3 if tier == "bf16x3" else 3e-2)


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 256, 300), (40, 5, 129), (200, 33, 64)])
def test_k2_tiers_match_plain(dev, kernel, tier, shape):
    D, f, N = shape
    rng = np.random.default_rng(14)
    P = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(N, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    got = gm.gram_matvec(kernel, P, a, Y=Y, tier=tier, **_hyper(f))
    want = gm.gram_matvec_plain(kernel, P, a, Y=Y, tier=tier, **_hyper(f))
    assert _rel_err(got, want) <= TIER_TOL


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(40, 40, 5), (300, 170, 100), (129, 1, 33), (256, 130, 1001)])
def test_k3_tiers_match_plain(dev, kernel, tier, shape):
    Di, Dj, f = shape
    rng = np.random.default_rng(15)
    Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32, device=dev)
    vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
    kw = dict(same=False, tier=tier, **_hyper(f))
    oi, oj = gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, **kw)
    wi, wj = gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, **kw)
    assert _rel_err(oi, wi) <= TIER_TOL and _rel_err(oj, wj) <= TIER_TOL


@pytest.mark.parametrize("tier", BF16_TIERS)
def test_tiers_repeat_bitwise_and_are_counted(dev, tier):
    rng = np.random.default_rng(16)
    X = torch.tensor(rng.normal(size=(700, 40)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(500, 40)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=700), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=500), dtype=torch.float32, device=dev)
    gm.reset_launches()
    mv = gm.make_sym_matvec(KernelType.rbf, X, gamma=0.05, tier=tier)
    runs = [(mv(v),
             gm.gram_matvec(KernelType.rbf, X, vj, Y=Xj, gamma=0.05, tier=tier),
             *gm.pair_gram_contrib(KernelType.rbf, X, Xj, v, vj, same=False, gamma=0.05,
                                   tier=tier)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert gm.launches == _counts(**{f"gram_matvec_sym__{tier}": 2,
                                     f"gram_matvec_rect__{tier}": 2,
                                     f"gram_pair_contrib__{tier}": 2})


def test_tier_wrappers_check_their_operands(dev):
    X = torch.ones((8, 4), device=dev)
    v = torch.ones(8, device=dev)
    sq = gm.row_sqnorms(X)
    with pytest.raises(PLSSVMError, match="takes 2 operand"):
        gm._launch_sym(KernelType.rbf, "bf16x3", (X.bfloat16(),), v, sq, 3, 1.0, 0.0)
    with pytest.raises(PLSSVMError, match="expected torch.bfloat16"):
        gm._launch_sym(KernelType.rbf, "bf16cast", (X,), v, sq, 3, 1.0, 0.0)


def test_adaptive_learn_runs_both_tiers(dev, monkeypatch):
    """The cuda backend's default plan: a float32 implicit learn starts on
    bf16cast K1 and verifies on bf16x3 K1; with patience 2 and a tight eps
    the fast tier stagnates and the solve escalates."""
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION", raising=False)
    rng = np.random.default_rng(17)
    n, f = 400, 16
    X = np.concatenate([rng.normal(1.0, 1.0, (n // 2, f)), rng.normal(-1.0, 1.0, (n // 2, f))])
    y = np.concatenate([np.ones(n // 2), -np.ones(n // 2)])
    infos = {}
    for patience, eps in (("8", 1e-6), ("2", 1e-9)):
        monkeypatch.setenv("PLSSVM_CG_STAG_PATIENCE", patience)
        p = Parameter(kernel=KernelType.rbf, gamma=1.0 / f, epsilon=eps, max_iter=400,
                      dtype=np.float32, backend=BackendType.cuda, print_info=False,
                      sparse_threshold=0.0)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        gm.reset_launches()
        svm.learn()
        infos[patience] = (svm.last_cg_info, dict(gm.launches))
        assert svm.accuracy() >= 0.95
    info, launches = infos["8"]
    assert info["mode"] == "implicit" and info["fast_iterations"] >= 1
    assert info["delta"] <= 1e-12 * info["delta0"]
    assert launches["gram_matvec_sym/bf16cast"] > 0 and launches["gram_matvec_sym/bf16x3"] > 0
    assert launches["gram_matvec_sym/exact"] == 0
    info, launches = infos["2"]
    assert info["escalated"] and info["iterations"] > info["fast_iterations"]
    assert info["delta"] <= 1e-18 * info["delta0"] or info["iterations"] == 400
