"""The CUDA kernels on the card: K1, K2 and K3 against their plain PyTorch
versions at every precision tier (the bf16 tiers run the TMA-fed ``wgmma``
tile, K2 in its row-only mode: ragged rows and features, more tile pairs
than SMs, operands prepared by the caller), the one-pass bf16 split bit for
bit against its plain version, determinism, launch counts, the scratch in
strips (bitwise the one-strip result, the slab within its budget), the
sparse tiers' X scattered from CSR rows bit for bit the host pad, the
sparse gram tier's Gram from the CSR rows (the pair kernel against its
plain version and the float64 Gram, its launches and counters), the
wrappers' checks, a small learn/predict on the ``cuda`` backend against the
``torch`` backend, a streaming sparse learn through K3, the adaptive
two-tier learn, and the step graphs kept across learns of one layout.

Every test needs a CUDA device and skips without one.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_rows_load_on_the_card_bitwise_the_host_pad(dev, dtype):
    """X of the gram and sparse ``dense`` tiers on the card: the CSR rows
    staged page-locked, copied and scattered (``load_csr_rows``) are bit
    for bit ``np.zeros((D, f))[:dept] = csr[:dept].toarray()`` in the
    learn's dtype, an empty row and the padding rows zero, the last point
    left out."""
    from plssvm_sparse_fp22_tpu_torch.ops.sparse import load_csr_rows, stage_csr_rows

    rng = np.random.default_rng(12)
    n, f = 1200, 3001
    csr = sp.random(n, f, density=0.01, format="lil", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    csr[5, :] = 0.0
    csr[n - 1, 7] = 0.5
    csr = csr.tocsr()
    csr.eliminate_zeros()
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    p = Parameter(kernel=KernelType.rbf, gamma=0.1, dtype=dtype, print_info=False,
                  sparse_threshold=1.0)
    p.data = ParsedData(csr=csr, values=y)
    p.values = y
    svm = make_csvm(p)
    assert svm.device.type == "cuda"
    dept, D = n - 1, n + 80
    staged = stage_csr_rows(svm.data.csr, dept, svm.dtype, svm.device)
    assert len(staged) == 3 and all(t.is_pinned() for t in staged)
    X = torch.full((D, f), float("nan"), dtype=svm.dtype, device=dev)
    load_csr_rows(X, dept, staged)
    want = np.zeros((D, f), dtype=dtype)
    want[:dept] = csr[:dept].toarray()
    uint = np.uint32 if dtype == np.float32 else np.uint64
    assert np.array_equal(X.cpu().numpy().view(uint), want.view(uint))
    assert csr.indptr[5] == csr.indptr[6] and csr[-1].nnz > 0


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


def test_float64_implicit_learn_launches_no_kernel(dev, monkeypatch):
    """A float64 rbf learn forced to ``implicit`` (K at 512 x 512 over a
    1000-byte budget) runs the blocked float64 product on the card, as the
    JAX package runs float64 outside Pallas: no K1, no K2 in the predict,
    and the numpy oracle's float64 learn to its float64 early-stop
    tolerance (``tests/test_torch_model.py``: equal iterations, alphas and
    decision values to 1e-9 of their scale at eps 1e-3)."""
    from plssvm_sparse_fp22_tpu_torch.utils import oracle

    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION", raising=False)
    rng = np.random.default_rng(12)
    n, f = 512, 32
    X = np.concatenate([rng.normal(1.0, 1.0, (n // 2, f)), rng.normal(-1.0, 1.0, (n // 2, f))])
    y = np.concatenate([np.ones(n // 2), -np.ones(n // 2)])
    hyper = {"kernel": KernelType.rbf, "gamma": 1.0 / f}
    p = Parameter(epsilon=1e-3, max_iter=200, dtype=np.float64, backend=BackendType.cuda,
                  print_info=False, sparse_threshold=0.0, **hyper)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    gm.reset_launches()
    svm.learn()
    dec = svm.predict(X)
    assert svm.last_cg_info["mode"] == "implicit"
    assert not any(gm.launches.values())
    alphas, bias, info = oracle.solve_lssvm(X, y, epsilon=1e-3, max_iter=200, **hyper)
    assert svm.last_cg_info["iterations"] == info["iterations"]
    scale = np.abs(alphas).max()
    np.testing.assert_allclose(svm.alphas, alphas, rtol=1e-9, atol=1e-9 * scale)
    want = oracle.predict_values(X, alphas, bias, X, **hyper)
    np.testing.assert_allclose(dec, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_default_linear_learn_keeps_the_float64_accuracy(dev, monkeypatch):
    """The dense ``linear`` learn at float32 with the tier unpinned runs the
    fixed exact tier on the card, not the bf16 plan (no bf16 operand is
    prepared), and its training accuracy lies within one point of a direct
    float64 solve's.  Two blobs at -0.2 and +0.2, 4096 x 32: CG stops at
    eps 1e-6 near enough to the solution for the accuracies to compare (a
    CPU rehearsal on the ``torch`` backend: 87.8 % against 88.0 %)."""
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION", raising=False)
    rng = np.random.default_rng(11)
    n, f = 4096, 32
    X = np.concatenate([rng.normal(-0.2, 1.0, (n // 2, f)),
                        rng.normal(0.2, 1.0, (n // 2, f))]).astype(np.float32)
    y = np.concatenate([-np.ones(n // 2), np.ones(n // 2)])
    p = Parameter(kernel=KernelType.linear, epsilon=1e-6, dtype=np.float32,
                  backend=BackendType.cuda, print_info=False, sparse_threshold=0.0)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    gm.reset_preparations()
    svm.learn()
    assert svm.last_cg_info["mode"] == "linear"
    assert gm.preparations["bf16x3"] == gm.preparations["bf16cast"] == 0
    Xd = X.astype(np.float64)
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = Xd @ Xd.T + np.eye(n)
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    direct = np.mean(np.sign(Xd @ (Xd.T @ sol[:n]) + sol[n]) == y)
    assert svm.accuracy() >= direct - 0.01, (svm.accuracy(), direct)


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
    # bf16x3: one split when K1's closure is built, two (both sides) in each
    # call of K2 and K3
    assert gm.launches == _counts(**{f"gram_matvec_sym__{tier}": 2,
                                     f"gram_matvec_rect__{tier}": 2,
                                     f"gram_pair_contrib__{tier}": 2,
                                     "split_bf16": 9 if tier == "bf16x3" else 0})


def test_tier_wrappers_check_their_operands(dev):
    X = torch.ones((8, 4), device=dev)
    v = torch.ones(8, device=dev)
    sq = gm.row_sqnorms(X)
    with pytest.raises(PLSSVMError, match="takes 2 operand"):
        gm._launch_sym(KernelType.rbf, "bf16x3", (X.bfloat16(),), v, sq, 3, 1.0, 0.0)
    with pytest.raises(PLSSVMError, match="expected torch.bfloat16"):
        gm._launch_sym(KernelType.rbf, "bf16cast", (X,), v, sq, 3, 1.0, 0.0)


# --- the wgmma tile of the bf16 tiers -----------------------------------------------


def _tier_budget(tier):
    return 1e-3 if tier == "bf16x3" else 3e-2


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 1), (129, 8), (3000, 1001), (1, 1001), (640, 512)])
def test_wgmma_k1_ragged_shapes_match_plain(dev, kernel, tier, shape):
    """Rows that end inside a tile (D = 1, 129, 3000: the TMA unit fills the
    rest with zeros and the epilogue masks it), features that end inside a
    64-feature box (f = 1, 8, 1001: padded by ``tier_operands``), one chunk
    to 16 chunks per tile, 1 to 300 tile pairs (more than the card's SMs).
    Longer feature axes are
    :func:`test_wgmma_k1_long_feature_axis_on_few_rows`'s."""
    D, f = shape
    rng = np.random.default_rng(31)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
    got = gm.gram_matvec_sym(kernel, X, v, tier=tier, **_hyper(f))
    want = gm.gram_matvec_sym_plain(kernel, X, v, tier=tier, **_hyper(f))
    assert _rel_err(got, want) <= TIER_TOL
    exact = gm.gram_matvec_sym(kernel, X, v, tier="exact", **_hyper(f))
    assert _rel_err(got, exact) <= _tier_budget(tier)


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 129, 1), (129, 1, 8), (3000, 129, 1001), (1700, 3000, 64),
                                   (512, 512, 4096)])
def test_wgmma_k3_ragged_shapes_match_plain(dev, kernel, tier, shape):
    """K3 with each panel's operands prepared by the caller, as the panel
    schedules hand them over; the call without them gives the same bits."""
    Di, Dj, f = shape
    rng = np.random.default_rng(32)
    Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32, device=dev)
    vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
    kw = dict(same=False, tier=tier, **_hyper(f))
    ops = (gm.tier_operands(tier, Xi), gm.tier_operands(tier, Xj))
    oi, oj = gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, operands=ops, **kw)
    wi, wj = gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, operands=ops, **kw)
    assert _rel_err(oi, wi) <= TIER_TOL and _rel_err(oj, wj) <= TIER_TOL
    ei, ej = gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, same=False, tier="exact", **_hyper(f))
    assert _rel_err(oi, ei) <= _tier_budget(tier) and _rel_err(oj, ej) <= _tier_budget(tier)
    ni, nj = gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, **kw)
    assert torch.equal(ni, oi) and torch.equal(nj, oj)


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 300, 256), (129, 1, 8), (3000, 1700, 1001),
                                   (130, 4096, 64), (64, 640, 200), (65, 129, 1),
                                   (200, 700, 512), (17000, 300, 64), (1, 40000, 256)])
def test_wgmma_k2_ragged_shapes_match_plain(dev, kernel, tier, shape):
    """K2's row-only epilogue: one point, 64 and 65 rows (either side of a
    wgmma's 64 rows), rows and support vectors that end inside a tile,
    features that end inside a box, more tiles than SMs; a row block
    resident in shared memory (f <= 256; f = 512 at bf16cast only) and both
    operands streamed (f = 1001; f = 512 at bf16x3); more row blocks than
    SMs (17000 rows: a unit is a whole row of tiles, a CTA takes several)
    and one row block cut into 128 runs (40000 support vectors); with the
    operands prepared by the caller and, same bits, prepared inside the
    call."""
    D, N, f = shape
    rng = np.random.default_rng(35)
    P = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(N, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=N), dtype=torch.float32, device=dev)
    ops = (gm.tier_operands(tier, P), gm.tier_operands(tier, Y))
    got = gm.gram_matvec(kernel, P, a, Y=Y, tier=tier, operands=ops, **_hyper(f))
    want = gm.gram_matvec_plain(kernel, P, a, Y=Y, tier=tier, operands=ops, **_hyper(f))
    assert _rel_err(got, want) <= TIER_TOL
    exact = gm.gram_matvec(kernel, P, a, Y=Y, tier="exact", **_hyper(f))
    assert _rel_err(got, exact) <= _tier_budget(tier)
    assert torch.equal(gm.gram_matvec(kernel, P, a, Y=Y, tier=tier, **_hyper(f)), got)


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("shape", [(129, 4096), (640, 2048)])
def test_wgmma_k1_long_feature_axis_on_few_rows(dev, tier, shape):
    """f = 4096 on 129 rows and f = 2048 on 640: 64 and 32 chunks a tile, and
    the shapes where the tensor core's accumulation shows.  It adds into its
    f32 accumulator without rounding to nearest, so the f / 16 (bf16cast) or
    3 f / 16 (bf16x3) additions that build a diagonal entry g_ii = |x_i|^2 ~ f
    leave it low by up to ~5e-5 of itself at f = 4096 (measured on an H100),
    which the plain version's correctly rounded sums do not share.  For the
    linear and polynomial kernels that stays inside ``TIER_TOL`` of the
    result's scale.  rbf turns it into K_ii = exp(-2 gamma (|x_i|^2 - g_ii))
    ~ 1 - 7e-5, an error of 7e-5 |v_i| in entry i, while with so few rows the
    result's scale is little more than one |v_i|: it is held to ``TIER_TOL``
    of max(K |v|), the scale of the sums' terms, and to the tier's budget of
    the exact kernel."""
    D, f = shape
    rng = np.random.default_rng(34)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
    for kernel in KERNELS:
        got = gm.gram_matvec_sym(kernel, X, v, tier=tier, **_hyper(f))
        want = gm.gram_matvec_sym_plain(kernel, X, v, tier=tier, **_hyper(f))
        if kernel == KernelType.rbf:  # K > 0, so K |v| is the sum of the terms' sizes
            terms = gm.gram_matvec_sym_plain(kernel, X, v.abs(), tier=tier, **_hyper(f))
            assert float((got - want).abs().max() / terms.max()) <= TIER_TOL
        else:
            assert _rel_err(got, want) <= TIER_TOL
        exact = gm.gram_matvec_sym(kernel, X, v, tier="exact", **_hyper(f))
        assert _rel_err(got, exact) <= _tier_budget(tier)


@pytest.mark.parametrize("tier", BF16_TIERS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_wgmma_tiles_repeat_bitwise(dev, kernel, tier):
    """More tile pairs than SMs (300 for K1, 336 for K2 and K3), so the
    persistent CTAs and their two consumer warpgroups share the pairs:
    whichever runs a pair, its slab slot gets the same bits."""
    rng = np.random.default_rng(33)
    f = 200
    X = torch.tensor(rng.normal(size=(3000, f)), dtype=torch.float32, device=dev)
    Xj = torch.tensor(rng.normal(size=(1700, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=3000), dtype=torch.float32, device=dev)
    vj = torch.tensor(rng.normal(size=1700), dtype=torch.float32, device=dev)
    mv = gm.make_sym_matvec(kernel, X, tier=tier, **_hyper(f))
    ops = (gm.tier_operands(tier, X), gm.tier_operands(tier, Xj))
    runs = [(mv(v), gm.gram_matvec(kernel, X, vj, Y=Xj, tier=tier, operands=ops, **_hyper(f)),
             *gm.pair_gram_contrib(kernel, X, Xj, v, vj, same=False, tier=tier,
                                   operands=ops, **_hyper(f))) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_wgmma_wrappers_reject_what_the_tile_does_not_take(dev):
    X = torch.ones((8, 100), device=dev)
    v = torch.ones(8, device=dev)
    sq = gm.row_sqnorms(X)
    args = (v, sq, 3, 1.0, 0.0)
    good = gm.tier_operands("bf16cast", X)
    assert good[0].shape == (8, 128)
    with pytest.raises(PLSSVMError, match="expected torch.bfloat16"):
        gm._launch_sym(KernelType.rbf, "bf16cast", (X.double(),), *args)
    with pytest.raises(PLSSVMError, match="contiguous"):
        gm._launch_sym(KernelType.rbf, "bf16cast", (good[0].T.contiguous().T,), *args)
    with pytest.raises(PLSSVMError, match="padded"):
        gm._launch_sym(KernelType.rbf, "bf16cast", (X.bfloat16(),), *args)
    with pytest.raises(PLSSVMError, match="padded"):
        gm._launch_pair(KernelType.rbf, "bf16x3", gm.tier_operands("bf16x3", X, pad=False),
                        gm.tier_operands("bf16x3", X), v, v, sq, sq, 3, 1.0, 0.0)
    with pytest.raises(PLSSVMError, match="padded"):
        gm._launch_rect(KernelType.rbf, "bf16cast", (X.bfloat16(),), (X.bfloat16(),), v, sq, sq,
                        3, 1.0, 0.0)
    with pytest.raises(PLSSVMError, match="padded"):
        gm.gram_matvec(KernelType.rbf, X, v, tier="bf16x3",
                       operands=(gm.tier_operands("bf16x3", X, pad=False),
                                 gm.tier_operands("bf16x3", X)))
    with pytest.raises(PLSSVMError, match="float32 only"):
        gm.pair_gram_contrib(KernelType.rbf, X.double(), X.double(), v.double(), v.double(),
                             same=False, tier="bf16cast")


# --- the split kernel -------------------------------------------------------------


def _special_floats(rng, shape):
    """Random bit patterns (every exponent, NaNs and infinities of both
    signs, subnormals), a third normal draws, and the written-out cases:
    zeros, subnormals, the smallest normal and its neighbour, remainders
    that are subnormal, rounding ties of the remainder."""
    n = int(np.prod(shape))
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    normal = rng.normal(size=n).astype(np.float32).view(np.uint32)
    bits = np.where(rng.random(n) < 1 / 3, normal, bits)
    cases = [0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x00800000, 0x00800001,
             0x80810001, 0x01000001, 0x3F808000, 0x3F818000, 0x3F800180, 0x7F800000, 0xFF800000,
             0x7FC00000, 0x7F800001]
    bits[:min(n, len(cases))] = cases[:n]
    return bits.view(np.float32).reshape(shape)


def _same_bits(a, b):
    """Equal bits; a NaN matches a NaN (a cast makes every NaN canonical)."""
    nan = a.isnan()
    return a.shape == b.shape and torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int16).masked_fill(nan, 0), b.view(torch.int16).masked_fill(nan, 0))


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("shape", [(257, 1001), (64, 4), (33, 12), (3, 1), (130, 63), (129, 256),
                                   (100003,), (0, 5)])
def test_split_kernel_equals_plain_bitwise(dev, shape, pad):
    """Vector and scalar loads (f % 4), vector and scalar stores (the padded
    and the ragged feature axis), a vector, an empty matrix; the pad columns
    are zero and a second padding is a no-op."""
    rng = np.random.default_rng(36)
    X = torch.tensor(_special_floats(rng, shape), device=dev)
    pad = pad and X.dim() == 2
    gm.reset_launches()
    got = gm.split_bf16(X, pad=pad)
    want = gm.split_bf16_plain(X)
    if pad:
        want = tuple(gm._pad_features(t) for t in want)
    assert gm.launches["split_bf16"] == (1 if X.numel() else 0)
    f = shape[-1]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous() and _same_bits(g, w)
        assert not g[..., f:].any()
        assert not pad or gm._pad_features(g) is g
    assert all(_same_bits(a, b) for a, b in zip(gm.tier_operands("bf16x3", X, pad=pad), got))


def test_split_wrapper_rejects_what_the_kernel_does_not_take(dev):
    X = torch.ones((8, 12), device=dev)
    with pytest.raises(PLSSVMError, match="float32 only"):
        gm.split_bf16(X.double())
    with pytest.raises(PLSSVMError, match="contiguous"):
        gm.split_bf16(X.T)
    with pytest.raises(PLSSVMError, match="a vector or a matrix"):
        gm.split_bf16(X.reshape(2, 4, 12))


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


@pytest.mark.parametrize("precision", ["", "highest"])
def test_learns_of_one_layout_capture_once(dev, precision, monkeypatch):
    """Step graphs kept per layout (``solver.cg.layout``): on fresh CSVMs, a
    second learn of one layout captures no graph and is bitwise the first (a
    fresh learn, after ``clear_graphs``); a learn at another ``cost`` or
    ``eps`` captures only the loops its layout has not run yet (the plan's
    escalation to bf16x3; on ``highest`` none, the chunk graph holds the
    refresh step), none on a repeat, so no graph is captured twice and
    each loop has one; another ``gamma`` captures its own graphs."""
    from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", precision)
    rng = np.random.default_rng(23)
    n, f = 1025, 64
    X = np.concatenate([rng.normal(0.5, 1.0, (n // 2, f)), rng.normal(-0.5, 1.0, (n - n // 2, f))])
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])

    def learn(**kw):
        kw = {"gamma": 1.0 / f, "epsilon": 1e-6, **kw}
        p = Parameter(kernel=KernelType.rbf, max_iter=400, dtype=np.float32,
                      backend=BackendType.cuda, print_info=False, sparse_threshold=0.0,
                      devices=1, **kw)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        before = tcg.counts["captures"]
        kept = _graphs()
        svm.learn()
        assert svm.last_cg_loop["graph"]
        captured = tcg.counts["captures"] - before
        if kw["gamma"] == 1.0 / f and kept:
            assert captured == _graphs() - kept  # new loops only, none captured twice
        return svm, captured

    def _graphs():
        kept = tcg._LAYOUTS.get(torch.device("cuda", torch.cuda.current_device()))
        return 0 if kept is None else sum(g.handles is not None for g in kept.graphs.values())

    tcg.clear_graphs()
    first, captured = learn()
    assert captured > 0
    second, captured = learn()
    assert captured == 0
    np.testing.assert_array_equal(second.alphas, first.alphas)
    assert second.bias_ == first.bias_
    assert second.last_cg_info == first.last_cg_info
    for kw in ({"cost": 2.0}, {"epsilon": 1e-8}):
        captured = learn(**kw)[1]
        assert captured == 0 or not precision
        assert learn(**kw)[1] == 0
    assert learn(gamma=2.0 / f)[1] > 0


def test_learns_of_one_data_set_follow_the_pinned_tier(dev, monkeypatch):
    """``PLSSVM_MATMUL_PRECISION`` is read at each learn: a learn on
    ``high`` after one on ``highest`` (one data set, one padded size) runs
    K1 at bf16x3, not the kept layout's exact operator."""
    rng = np.random.default_rng(29)
    X = rng.normal(size=(600, 32))
    y = np.where(X[:, 0] > 0, 1.0, -1.0)
    for precision, tier in (("highest", "exact"), ("high", "bf16x3"), ("highest", "exact")):
        monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", precision)
        p = Parameter(kernel=KernelType.rbf, gamma=1.0 / 32, epsilon=1e-6, max_iter=200,
                      dtype=np.float32, backend=BackendType.cuda, print_info=False,
                      sparse_threshold=0.0, devices=1)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        gm.reset_launches()
        make_csvm(p).learn()
        assert {k for k, v in gm.launches.items() if v} == {f"gram_matvec_sym/{tier}"} | (
            {"split_bf16"} if tier == "bf16x3" else set())


# the scratch in strips: a launch's slab bounded by ``scratch_bytes``
SLOT = gm.CUDA_TILE * 4
#: D = 1000 rows (8 row blocks) against 700 (6): budgets for 1, 3 and 8
#: strips of K1, K2 and K3 (tests/test_torch_scratch_strips.py)
STRIP_BUDGETS = {"sym": {1: 64 * SLOT, 3: 40 * SLOT, 8: 20 * SLOT},
                 "rect": {1: 48 * SLOT, 3: 18 * SLOT, 8: 6 * SLOT},
                 "pair": {1: 96 * SLOT, 3: 36 * SLOT, 8: 12 * SLOT}}


def _strip_data(dev, f=40, seed=21):
    g = torch.Generator(device="cpu").manual_seed(seed)
    X, Y = torch.randn(1000, f, generator=g), torch.randn(700, f, generator=g)
    v, w = torch.randn(1000, generator=g), torch.randn(700, generator=g)
    return X.to(dev), Y.to(dev), v.to(dev), w.to(dev)


@pytest.mark.parametrize("tier", ["exact", *BF16_TIERS])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k1_in_strips_is_bitwise_one_strip(dev, kernel, tier):
    """K1 in 3 and 8 strips gives the one-strip bits (each row's partials
    are added in the one ascending order across the strips), one launch per
    strip, and equals the plain twin of the schedule."""
    X, _, v, _ = _strip_data(dev)
    kw = _hyper(X.shape[1])
    one = gm.make_sym_matvec(kernel, X, tier=tier, scratch_bytes=STRIP_BUDGETS["sym"][1], **kw)(v)
    for strips in (3, 8):
        gm.reset_launches()
        got = gm.make_sym_matvec(kernel, X, tier=tier,
                                 scratch_bytes=STRIP_BUDGETS["sym"][strips], **kw)(v)
        assert gm.launches[f"gram_matvec_sym/{tier}"] == strips
        assert torch.equal(got, one)
    twin = gm.gram_matvec_sym_strips_plain(kernel, X, v, tier=tier,
                                           scratch_bytes=STRIP_BUDGETS["sym"][8], **kw)
    assert _rel_err(one, twin) <= (TOL if tier == "exact" else TIER_TOL)


@pytest.mark.parametrize("tier", ["exact", *BF16_TIERS])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k2_and_k3_in_strips_are_bitwise_one_strip(dev, kernel, tier):
    X, Y, v, w = _strip_data(dev)
    kw = _hyper(X.shape[1])

    def k2(strips):
        return gm.gram_matvec(kernel, X, w, Y=Y, tier=tier,
                              scratch_bytes=STRIP_BUDGETS["rect"][strips], **kw)

    def k3(strips):
        return torch.cat(gm.pair_gram_contrib(kernel, X, Y, v, w, same=False, tier=tier,
                                              scratch_bytes=STRIP_BUDGETS["pair"][strips], **kw))

    one2, one3 = k2(1), k3(1)
    for strips in (3, 8):
        gm.reset_launches()
        assert torch.equal(k2(strips), one2) and torch.equal(k3(strips), one3)
        assert gm.launches[f"gram_matvec_rect/{tier}"] == strips
        assert gm.launches[f"gram_pair_contrib/{tier}"] == strips
    twin = gm.gram_matvec_strips_plain(kernel, X, w, Y=Y, tier=tier,
                                       scratch_bytes=STRIP_BUDGETS["rect"][8], **kw)
    assert _rel_err(one2, twin) <= (TOL if tier == "exact" else TIER_TOL)


def test_k1_slab_stays_within_its_budget(dev):
    """At D = 65536 (one slab: 128 MiB) under a 16 MiB budget, the peak
    memory a call adds is the slab and the output, within the budget."""
    X = torch.randn(65536, 64, device=dev)
    v = torch.randn(65536, device=dev)
    ops, sq = gm.tier_operands("bf16cast", X), gm.row_sqnorms(X)
    budget = 16 * 1024**2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = gm._launch_sym(KernelType.rbf, "bf16cast", ops, v, sq, 3, 1 / 64, 1.0,
                         scratch_bytes=budget)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= budget + 65536 * 4
    want = gm._launch_sym(KernelType.rbf, "bf16cast", ops, v, sq, 3, 1 / 64, 1.0,
                          scratch_bytes=512 * 1024**2)
    assert torch.equal(got, want)


# --- the sparse gram tier's Gram from the CSR rows (csrc/sparse_gram.cu) ---------------


def _gram_rows(csr, dev):
    """The first n - 1 rows of ``csr`` as the gram tier stages them, on
    ``dev``, with the padded D."""
    dept = csr.shape[0] - 1
    rows = csr[:dept]
    staged = (torch.tensor(np.diff(rows.indptr), dtype=torch.int64, device=dev),
              torch.tensor(rows.indices, dtype=torch.int64, device=dev),
              torch.tensor(rows.data, dtype=torch.float32, device=dev))
    return staged, dept, -(-dept // 256) * 256


def _uniform_csr(n, f, density, seed):
    rng = np.random.default_rng(seed)
    return sp.random(n, f, density=density, format="csr", random_state=rng,
                     data_rvs=lambda k: rng.normal(size=k))


@pytest.mark.parametrize("profile,threshold", [("zipf", None), ("zipf", 1 << 40),
                                               ("uniform 25 %", None),
                                               ("uniform 25 %", 1 << 40)],
                         ids=["zipf", "zipf-all-light", "uniform", "uniform-all-light"])
def test_sparse_gram_pairs_match_plain_and_float64(dev, profile, threshold):
    """The Gram from the rows on the card at a Zipf shape like rcv1's (4096
    x 8192) and a uniform 25 %-dense one, at the split's threshold and all
    light: the same bits on two calls, bitwise the plain version on the
    same slab product, within float32 rounding of the float64 Gram, the
    padding zero, ``sq`` G's diagonal; one launch where a light pair is
    left."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg
    from utils import zipf_csr

    csr = (zipf_csr(4096, 8192, seed=5) if profile == "zipf"
           else _uniform_csr(1024, 512, 0.25, seed=5))
    (counts, cols, vals), dept, D = _gram_rows(csr, dev)
    f = csr.shape[1]
    split = sg.split_rows(counts, cols, vals, D, f, threshold=threshold)
    if profile == "zipf" and threshold is None:
        assert 0 < split.heavy < 8192 and split.light_pairs > 0
    if profile != "zipf" and threshold is None:
        assert split.light_pairs == 0  # dense columns: the slab's product alone
    sg.reset_launches()
    G, sq = sg.gram_from_rows(split)
    G2, _ = sg.gram_from_rows(sg.split_rows(counts, cols, vals, D, f, threshold=threshold))
    assert sg.launches["sparse_gram_pairs"] == (2 if split.light_pairs else 0)
    assert torch.equal(G, G2) and torch.equal(sq, torch.diagonal(G))
    plain = split.slab @ split.slab.T
    sg.sparse_gram_pairs_plain(plain, split.rptr, split.rcol, split.rval, split.cptr,
                               split.crow, split.cval)
    assert torch.equal(G, plain)
    want = (csr[:dept] @ csr[:dept].T).toarray()
    got = G.double().cpu().numpy()
    assert not got[dept:].any() and not got[:, dept:].any()
    assert np.abs(got[:dept, :dept] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("max_chunk", [256, 250, 1000])
def test_sparse_gram_pairs_chunked_rows_match_one_chunk(dev, max_chunk):
    """The kernel's chunked walk (a row cut into chunks, each list narrowed
    to the chunk by binary search), which a D above what shared memory
    holds takes, forced at 4096 by a cap on the chunk: 16 chunks of 256
    floats, chunks of 250 (the one-float copies) and of 1000 (a last chunk
    of 96): bitwise the one-chunk kernel and the plain version, the
    padding zero."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg
    from utils import zipf_csr

    csr = zipf_csr(4096, 8192, seed=7)
    (counts, cols, vals), dept, D = _gram_rows(csr, dev)
    split = sg.split_rows(counts, cols, vals, D, csr.shape[1])
    assert split.light_pairs > 0 and D > max_chunk
    args = (split.rptr, split.rcol, split.rval, split.cptr, split.crow, split.cval)
    one = sg.sparse_gram_pairs(split.slab @ split.slab.T, *args)
    chunked = sg.sparse_gram_pairs(split.slab @ split.slab.T, *args, max_chunk=max_chunk)
    plain = sg.sparse_gram_pairs_plain(split.slab @ split.slab.T, *args)
    assert torch.equal(chunked, one) and torch.equal(chunked, plain)
    assert not chunked[dept:].any() and not chunked[:, dept:].any()


def test_gram_tier_learns_count_the_pair_kernel_and_the_path(dev):
    """Each float32 gram-tier learn launches the pair kernel once and counts
    ``gram_from_rows`` once (with its split's heavy columns and light
    pairs); the float64 learn keeps the dense product: no launch, no
    count."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg
    from plssvm_sparse_fp22_tpu_torch.utils import timing
    from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings
    from utils import zipf_csr

    csr = zipf_csr(2048, 8192, seed=9)
    y = np.where(np.arange(csr.shape[0]) % 3 == 0, 1.0, -1.0)
    old = timing.TRACED
    try:
        for dtype, launches in ((np.float32, 1), (np.float64, 0)):
            timing.TRACED = Timings()
            p = Parameter(kernel=KernelType.rbf, gamma=1.0, dtype=dtype, print_info=False,
                          devices=1, epsilon=1e-3)
            p.data = ParsedData(csr=csr, values=y)
            p.values = y
            sg.reset_launches()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                for k in range(2):
                    svm = make_csvm(p)
                    svm.learn()
                    assert svm.last_cg_info["mode"] == "sparse_gram"
                    assert sg.launches["sparse_gram_pairs"] == launches * (k + 1)
            counters = timing.TRACED.counters
            assert counters.get("gram_from_rows", 0) == 2 * launches
            assert counters["densify_on_device"] == 2
            if launches:
                assert counters["gram_heavy_cols"] % 2 == 0 < counters["gram_light_pairs"]
            else:
                assert "gram_heavy_cols" not in counters
    finally:
        timing.TRACED = old
