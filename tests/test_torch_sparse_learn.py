"""The port's sparse learns, tier routing, sparse predict and CLIs against the
JAX package on the CPU (mirrors the learn-level tests of ``test_sparse.py``).

Tolerances and why (``test_torch_model.py`` measured the same for the
dense learns).  CG starts from x0 = 1 and amplifies the two packages'
different summation orders, so:

- float64, early stop (eps 1e-3): equal iteration counts, alphas to 1e-9
  of their scale and the bias to 1e-9 of ``QA_cost * sum|alpha|``, the
  scale of its own rounding (bias = y_last + QA_cost * sum(x) - q.x);
- float64, converged (eps 1e-10): iteration counts within one, alphas to
  1e-5 of their scale and the bias to 1e-6 against a direct solve of the
  LS-SVM system;
- prediction from the same trained state: decision values to 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.cli.predict import main as jax_predict
from plssvm_sparse_fp22_tpu.cli.train import main as jax_train
from plssvm_sparse_fp22_tpu.exceptions import PLSSVMError as JError
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu.models.base import CSVM as JCSVM
from plssvm_sparse_fp22_tpu.utils import oracle
from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
from plssvm_sparse_fp22_tpu_torch.cli.train import main as train_main
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.io.model import write_model_file
from plssvm_sparse_fp22_tpu_torch.models.base import CSVM as TCSVM
from plssvm_sparse_fp22_tpu_torch.models.sparse_learn import learn_sparse_panel
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

PKGS = {"jax": (jp, JParsed), "torch": (tp, TParsed)}
KT = tp.KernelType


def _random_sparse(n, f, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y


def _params(pkg, csr, y, kernel, **kw):
    mod, Parsed = PKGS[pkg]
    kw.setdefault("dtype", np.float64)
    p = mod.Parameter(kernel=mod.KernelType(int(kernel)), gamma=0.2, coef0=1.0,
                      sparse_threshold=1.0, devices=1, print_info=False, **kw)
    p.data = Parsed(csr=csr, values=y)
    p.values = y
    return p


def _learn(pkg, csr, y, kernel, **kw):
    svm = PKGS[pkg][0].make_csvm(_params(pkg, csr, y, kernel, **kw))
    svm.learn()
    return svm


def _exact(csr, y, kernel, cost=1.0):
    X = csr.toarray()
    n = len(y)
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = oracle.kernel_matrix(jp.KernelType(int(kernel)), X, X, degree=3, gamma=0.2,
                                     coef0=1.0) + np.eye(n) / cost
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    return sol[:n], sol[n]


# (tier name, kernel, environment): each of the five learns, the panel learn
# in both sweep schedules and over more than one panel
TIERS = [
    ("sparse_linear", KT.linear, {}),
    ("sparse_gram", KT.polynomial, {"PLSSVM_SPARSE_MODE": "gram"}),
    ("sparse_gram", KT.rbf, {"PLSSVM_SPARSE_MODE": "gram"}),
    ("sparse_dense_implicit", KT.rbf, {"PLSSVM_SPARSE_MODE": "dense"}),
    ("sparse_implicit", KT.polynomial,
     {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": "1000"}),
    ("sparse_implicit", KT.rbf,
     {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": "1000",
      "PLSSVM_SPARSE_PANEL_SWEEP": "windowed"}),
    ("sparse_implicit", KT.rbf,
     {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_SPARSE_STREAM": "gather"}),
]
TIER_IDS = ["linear", "gram-poly", "gram-rbf", "dense-rbf", "panel-unrolled-poly",
            "panel-windowed-rbf", "gather-rbf"]


@pytest.mark.parametrize("mode,kernel,env", TIERS, ids=TIER_IDS)
def test_sparse_learn_matches_jax(mode, kernel, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    csr, y = _random_sparse(300, 40, density=0.15, seed=13)
    kw = dict(epsilon=1e-3, max_iter=200)
    j, t = _learn("jax", csr, y, kernel, **kw), _learn("torch", csr, y, kernel, **kw)
    ji, ti = j.last_cg_info, t.last_cg_info
    assert ti["mode"] == ji["mode"] == mode
    assert ti["iterations"] == ji["iterations"]
    assert (ti["dept"], ti["padded"]) == (ji["dept"], ji["padded"]) == (299, 512)
    scale = np.abs(j.alphas).max()
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9, atol=1e-9 * scale)
    assert t.bias_ == pytest.approx(j.bias_, abs=1e-9 * t.QA_cost_ * np.abs(j.alphas).sum())


@pytest.mark.parametrize("mode,kernel,env", TIERS, ids=TIER_IDS)
def test_sparse_learn_converges_to_the_exact_solution(mode, kernel, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    csr, y = _random_sparse(300, 40, density=0.15, seed=13)
    kw = dict(epsilon=1e-10, max_iter=500)
    j, t = _learn("jax", csr, y, kernel, **kw), _learn("torch", csr, y, kernel, **kw)
    assert t.last_cg_info["mode"] == mode
    assert abs(t.last_cg_info["iterations"] - j.last_cg_info["iterations"]) <= 1
    alphas, bias = _exact(csr, y, kernel)
    scale = np.abs(alphas).max()
    np.testing.assert_allclose(t.alphas, alphas, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=0, atol=1e-5 * scale)
    assert t.bias_ == pytest.approx(bias, abs=1e-6)


def test_sparse_learn_with_heavy_rows_matches_jax(monkeypatch):
    """The panel learn with heavy rows spilled from the tiled packing, over
    several panels, and Jacobi PCG."""
    monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "5000000")
    rng = np.random.default_rng(31)
    n, f = 520, 600
    csr = sp.random(n, f, density=0.03, format="lil", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for r in (11, 250, 400):
        csr[r, :] = rng.normal(size=f)
    csr = csr.tocsr()
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    kw = dict(epsilon=1e-3, max_iter=200, precond="jacobi")
    j, t = _learn("jax", csr, y, KT.rbf, **kw), _learn("torch", csr, y, KT.rbf, **kw)
    assert t.last_cg_info["mode"] == j.last_cg_info["mode"] == "sparse_implicit"
    assert t.last_cg_info["iterations"] == j.last_cg_info["iterations"]
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=1e-9,
                               atol=1e-9 * np.abs(j.alphas).max())


# --- the tier policy -----------------------------------------------------------


@pytest.mark.parametrize("budget,mode", [(None, "sparse_gram"), ("100000", "sparse_dense_implicit"),
                                         ("1000", "sparse_implicit")])
def test_auto_routing_matches_jax(budget, mode, monkeypatch):
    if budget is not None:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", budget)
    csr, y = _random_sparse(200, 30, density=0.12, seed=31)
    kw = dict(epsilon=1e-3, max_iter=100)
    j, t = _learn("jax", csr, y, KT.rbf, **kw), _learn("torch", csr, y, KT.rbf, **kw)
    assert t.last_cg_info["mode"] == j.last_cg_info["mode"] == mode


def test_plan_sparse_panel_policy():
    csr, y = _random_sparse(128, 64, density=0.1, seed=61)
    svm = tp.CSVM(_params("torch", csr, y, KT.rbf))
    th, use_cuda, sweep = svm._plan_sparse_panel(csr, 127, 128)
    jth, _, jsweep = JCSVM(_params("jax", csr, y, KT.rbf))._plan_sparse_panel(csr, 127, 128)
    assert th.tell.vals.shape[0] == 128 and th.tell.Lt == jth.tell.Lt
    assert use_cuda is False  # torch backend on the CPU: the plain versions
    assert sweep == jsweep == "unrolled"
    # extreme sparsity (the gather regime) and dense-ish packings: no plan
    wide, yw = _random_sparse(64, 200_000, density=0.00001, seed=63)
    assert tp.CSVM(_params("torch", wide, yw, KT.rbf))._plan_sparse_panel(wide, 63, 64) is None
    rng = np.random.default_rng(5)
    dense = sp.random(96, 256, density=0.9, format="csr", random_state=rng)
    assert svm._plan_sparse_panel(dense, 95, 96) is None
    assert svm._device_memory_bytes() == 1 << 40


def test_tier_guards_respect_physical_memory(monkeypatch):
    """Dense X fits the budget but not the device's working set: both cached
    tiers refuse and the learn streams, in both packages."""
    csr, y = _random_sparse(256, 64, density=0.1, seed=67)
    physical = 2 * 256 * 64 * 8
    monkeypatch.setattr(TCSVM, "_device_memory_bytes", lambda self: physical)
    monkeypatch.setattr(JCSVM, "_device_memory_bytes", staticmethod(lambda: physical))
    kw = dict(epsilon=1e-3, max_iter=100)
    j, t = _learn("jax", csr, y, KT.rbf, **kw), _learn("torch", csr, y, KT.rbf, **kw)
    assert t.last_cg_info["mode"] == j.last_cg_info["mode"] == "sparse_implicit"


def test_plan_goes_windowed_beyond_memory(monkeypatch):
    csr, y = _random_sparse(128, 64, density=0.1, seed=61)
    svm = tp.CSVM(_params("torch", csr, y, KT.rbf))
    dense_bytes = 128 * 128 * 8
    monkeypatch.setattr(TCSVM, "_device_memory_bytes", lambda self: 4 * dense_bytes - 1)
    assert svm._plan_sparse_panel(csr, 127, 128)[2] == "windowed"
    monkeypatch.setattr(TCSVM, "_device_memory_bytes", lambda self: 1024)
    assert svm._plan_sparse_panel(csr, 127, 128) is None


def test_panel_tier_on_cuda_runs_float64_on_plain_pairs(monkeypatch):
    """On the ``cuda`` backend the panel pairs run K1/K3 at float32; float64
    panels run the plain pairs on the card, as the JAX package's
    ``use_pallas`` sends them to XLA (``base.py:751-753``), and nothing is
    refused."""
    csr, y = _random_sparse(128, 64, density=0.1, seed=61)
    monkeypatch.setattr(TCSVM, "_device_memory_bytes", lambda self: 80 << 30)
    for dtype, use_cuda in ((np.float64, False), (np.float32, True)):
        svm = tp.CSVM(_params("torch", csr, y, KT.rbf, dtype=dtype))
        svm.backend = tp.BackendType.cuda
        assert svm._plan_sparse_panel(csr, 127, 128)[1] is use_cuda


def test_sparse_refusals():
    csr, y = _random_sparse(40, 20, density=0.15, seed=3)
    msgs = {}
    for pkg in PKGS:
        svm = PKGS[pkg][0].make_csvm(_params(pkg, csr, y, KT.rbf, verbose_cg=True))
        with pytest.raises((JError, PLSSVMError)) as info:
            svm.learn()
        msgs[pkg] = str(info.value)
    assert msgs["torch"] == msgs["jax"]
    assert "sparse learn path" in msgs["torch"]
    # a mxu_plan is no longer refused: the panel learn runs the two-tier CG
    # (at float64 both tiers resolve to exact, so it never escalates)
    th = tp.CSVM(_params("torch", csr, y, KT.rbf))._plan_sparse_panel(csr, 39, 40)[0]
    b = torch.from_numpy(np.where(np.arange(40) < 39, y[:40] - y[-1], 0.0))
    out = learn_sparse_panel(th.tell.vals, th.tell.lcols,
                             torch.from_numpy(csr[-1].toarray().ravel()), b,
                             (torch.arange(40) < 39).double(), 0.2, 1.0, 1.0, 1e-3, 10,
                             kernel=KT.rbf, degree=3, ntiles=th.tell.ntiles, Lt=th.tell.Lt,
                             panel_rows=40, mxu_plan=("default", "high"))
    assert out[7] == out[4] > 0


def _csr_form(form, n=41, f=30, seed=71):
    """A CSR of ``n`` x ``f`` whose last row holds values: ``canonical``;
    ``empty row`` (rows 0 and 17 store nothing); ``repeated entries`` (each
    value stored as two parts of one column, split in float64, which
    ``toarray()`` adds back up in float64: not in canonical form)."""
    csr, _ = _random_sparse(n, f, density=0.2, seed=seed)
    if form == "empty row":
        lil = csr.tolil()
        lil[0, :] = 0.0
        lil[17, :] = 0.0
        csr = lil.tocsr()
        csr.eliminate_zeros()
        assert csr.indptr[1] == 0 and csr.indptr[17] == csr.indptr[18]
    if form == "repeated entries":
        rng = np.random.default_rng(seed)
        part = csr.data * rng.uniform(0.1, 0.9, csr.nnz)
        data = np.stack([part, csr.data - part], axis=1).ravel()
        csr = sp.csr_matrix((data, np.repeat(csr.indices, 2), 2 * csr.indptr), shape=csr.shape)
        assert not csr.has_canonical_format
    assert csr[-1].nnz > 0
    return csr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("form", ["canonical", "empty row", "repeated entries"])
def test_csr_rows_load_bitwise_the_host_pad(form, dtype):
    """The rows staged from the CSR and written into X on the device
    (``load_csr_rows``, shared by the gram and sparse ``dense`` tiers) are
    bit for bit the host pad ``np.zeros((D, f))[:dept] = csr[:dept].toarray()``
    in the learn's dtype: padding rows zero, the last point left out.
    Canonical rows are staged as counts, columns and values (a scatter);
    repeated entries as the dense rows, their sums ``toarray()``'s."""
    from plssvm_sparse_fp22_tpu_torch.ops.sparse import load_csr_rows, stage_csr_rows

    csr = _csr_form(form)
    y = np.where(np.arange(csr.shape[0]) % 2 == 0, 1.0, -1.0)
    svm = tp.make_csvm(_params("torch", csr, y, KT.rbf, dtype=dtype))
    (n, f), tdt = csr.shape, svm.dtype
    dept, D = n - 1, n + 7
    staged = stage_csr_rows(svm.data.csr, dept, svm.dtype, svm.device)
    assert len(staged) == (1 if form == "repeated entries" else 3)
    if len(staged) == 3:
        assert [t.dtype for t in staged] == [torch.int64, torch.int64, tdt]
        assert staged[0].tolist() == np.diff(csr.indptr[:n]).tolist()
    X = torch.full((D, f), float("nan"), dtype=tdt)
    load_csr_rows(X, dept, staged)
    want = np.zeros((D, f), dtype=dtype)
    want[:dept] = csr[:dept].toarray()
    uint = np.uint32 if dtype == np.float32 else np.uint64
    assert np.array_equal(X.numpy().view(uint), want.view(uint))
    assert not X[dept:].any() and csr[-1].toarray().any()



# --- the float32 gram tier's Gram from the CSR rows (ops/sparse_gram.py) --------


def _gram_case(case, n=60, f=80, seed=29):
    """``(csr, dept, D, threshold)`` of one case of the Gram from the rows:
    a CSR of ``n`` x ``f`` at 10 % density, the rows the Gram takes, its
    padded size and the split's threshold (``None``: ``split_threshold``'s)."""
    rng = np.random.default_rng(seed)
    lil = sp.random(n, f, density=0.1, format="lil", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    dept, D, threshold = n - 1, 128, None
    if case == "all light":
        threshold = 1 << 40
    elif case == "all heavy":
        threshold = 1
    elif case == "a column in every row":
        lil[:, 3] = rng.normal(size=(n, 1))
    elif case == "empty rows":
        for i in (0, 7, 30):
            lil[i, :] = 0.0
        threshold = 7
    elif case == "rows only in heavy columns":
        lil[:, 0] = rng.normal(size=(n, 1))
        lil[:, 1] = rng.normal(size=(n, 1))
        for i in (3, 11):
            lil[i, 2:] = 0.0
        threshold = 20  # columns 0 and 1 (n rows each) heavy, the others (about 6) light
    elif case == "dept < n":
        dept, D, threshold = n - 12, 64, 6
    csr = lil.tocsr()
    csr.eliminate_zeros()
    return csr, dept, D, threshold


GRAM_CASES = ["all light", "all heavy", "a column in every row", "empty rows",
              "rows only in heavy columns", "dept < n"]


def _split(csr, dept, D, threshold=None):
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg

    rows = csr[:dept]
    return sg.split_rows(torch.tensor(np.diff(rows.indptr)), torch.tensor(rows.indices).long(),
                         torch.tensor(rows.data, dtype=torch.float32), D, csr.shape[1],
                         threshold=threshold)


@pytest.mark.parametrize("case", GRAM_CASES)
def test_gram_from_rows_plain_matches_the_float64_gram(case):
    """The CPU path (the slab's product and the plain pairs) equals the
    float64 ``csr @ csr.T`` of the first dept rows within float32 rounding
    (about ten terms an entry: 1e-6 of the largest), padding rows and
    columns zero, whatever the split leaves on each side."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg

    csr, dept, D, threshold = _gram_case(case)
    split = _split(csr, dept, D, threshold)
    counts = np.bincount(csr[:dept].indices, minlength=csr.shape[1])
    if case == "all light":
        assert split.heavy == 0 and split.slab.shape == (D, 0)
    if case == "all heavy":
        assert split.light_pairs == 0 and split.heavy == np.count_nonzero(counts)
    if case == "rows only in heavy columns":
        assert split.heavy == 2 and split.light_pairs > 0
        assert split.rptr[4] == split.rptr[3] and split.rptr[12] == split.rptr[11]
    if case == "empty rows":
        assert 0 < split.heavy and split.light_pairs > 0
    assert split.slab.shape[1] % sg.SLAB_PAD == 0
    G, _ = sg.gram_from_rows(split)
    assert G.shape == (D, D) and G.dtype == torch.float32
    want = (csr[:dept] @ csr[:dept].T).toarray()
    got = G.double().numpy()
    assert not got[dept:].any() and not got[:, dept:].any()
    assert np.abs(got[:dept, :dept] - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("case", ["model's split", "all light", "all heavy"])
def test_gram_from_rows_sq_is_the_diagonal_bitwise(case):
    """``sq`` is G's diagonal bit for bit, so the rbf distance of a point
    to itself is exactly 0 before the clamp."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg

    csr, dept, D, _ = _gram_case("a column in every row")
    threshold = {"model's split": None, "all light": 1 << 40, "all heavy": 1}[case]
    G, sq = sg.gram_from_rows(_split(csr, dept, D, threshold))
    assert torch.equal(sq, torch.diagonal(G))
    assert not torch.any(sq + sq - 2.0 * torch.diagonal(G))


def _count_profile(profile):
    from utils import zipf_csr

    if profile == "zipf":
        csr = zipf_csr(2000, 3000, seed=17)
    else:
        csr = sp.random(1000, 400, density=0.25, format="csr", random_state=17)
    dept = csr.shape[0] - 1
    return csr, dept, -(-dept // 256) * 256


@pytest.mark.parametrize("profile", ["zipf", "uniform 25 %"])
def test_split_threshold_falls_where_the_cost_model_says(profile):
    """The split's T has the least modelled cost over every threshold
    (brute force, one at a time: the slab's product D² per heavy column at
    the slab's rate, the light columns' count² at the pair rate), and h and
    P are the heavy columns and light pairs at T.  Zipf counts split both
    ways; uniform 25 %-dense counts go all heavy, the slab's product over
    the occupied columns."""
    from plssvm_sparse_fp22_tpu_torch.constants import (SPARSE_GRAM_PAIR_RATE,
                                                        SPARSE_GRAM_SLAB_RATE)
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg

    csr, dept, D = _count_profile(profile)
    counts = np.bincount(csr[:dept].indices, minlength=csr.shape[1]).astype(np.int64)
    split = _split(csr, dept, D)
    T = split.threshold
    assert T == sg.split_threshold(D)

    def cost(t):
        light = counts[counts < t]
        return (D * D * int((counts >= t).sum()) / SPARSE_GRAM_SLAB_RATE
                + float((light**2).sum()) / SPARSE_GRAM_PAIR_RATE)

    least = min(cost(t) for t in range(1, counts.max() + 2))
    assert cost(T) <= least * (1 + 1e-12)
    assert split.heavy == int((counts >= T).sum())
    assert split.light_pairs == int((counts[counts < T] ** 2).sum())
    occupied = np.count_nonzero(counts)
    if profile == "zipf":
        assert 0 < split.heavy < occupied and split.light_pairs > 0
    else:
        assert split.heavy == occupied and split.light_pairs == 0


@pytest.mark.parametrize("kernel", [KT.polynomial, KT.rbf])
def test_float32_gram_learn_from_rows_matches_jax(kernel):
    """A float32 gram-tier learn through the Gram from the rows (a slab of
    heavy columns and light pairs, counted ``gram_from_rows``) matches the
    JAX package's dense product within float32's CG budgets
    (``test_torch_model.py::test_learn_float32_matches_jax``): converged
    to eps 1e-6, iterations within one (rbf) or three (polynomial), alphas
    to 1e-3 (rbf) or 1e-2 of their scale, the bias within the tolerance
    its stopping residual allows, the port's residual within the stopping
    rule."""
    from test_torch_model import cg_bias_tolerance, cg_residual
    from utils import zipf_csr

    from plssvm_sparse_fp22_tpu_torch.utils import timing

    csr = zipf_csr(400, 600, nnz_per_row=20, seed=3)
    score = np.asarray(csr[:, :50].sum(axis=1)).ravel()
    y = np.where(score > np.median(score), 1.0, -1.0)
    kw = dict(epsilon=1e-6, max_iter=400, dtype=np.float32)
    j = _learn("jax", csr, y, kernel, **kw)
    old = timing.TRACED
    timing.TRACED = timing.Timings()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            t = _learn("torch", csr, y, kernel, **kw)
        counters = timing.TRACED.counters
    finally:
        timing.TRACED = old
    assert counters["gram_from_rows"] == 1
    assert counters["gram_heavy_cols"] > 0 and counters["gram_light_pairs"] > 0
    rbf = kernel == KT.rbf
    ji, ti = j.last_cg_info, t.last_cg_info
    assert ti["mode"] == ji["mode"] == "sparse_gram"
    assert abs(ti["iterations"] - ji["iterations"]) <= (1 if rbf else 3)
    scale = np.abs(j.alphas).max()
    np.testing.assert_allclose(t.alphas, j.alphas, rtol=0, atol=(1e-3 if rbf else 1e-2) * scale)
    X = csr.toarray()
    hyper = dict(degree=3, gamma=0.2, coef0=1.0)
    assert cg_residual(X, y, kernel, 1.0, t.alphas, **hyper) <= \
        2 * 1e-6 * np.sqrt(ti["delta0"])
    btol = cg_bias_tolerance(X, y, kernel, 1.0, [t.alphas, j.alphas], np.float32, **hyper)
    assert abs(t.bias_ - j.bias_) <= btol

# --- predict ------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [KT.linear, KT.polynomial, KT.rbf])
def test_sparse_predict_from_jax_state_matches_jax(kernel):
    """A sparse JAX model carried over with ``csvm_from_state`` (CSR support
    vectors, sparse_threshold kept) predicts what the JAX model predicts:
    ``predict`` on dense points, ``predict_parsed`` on sparse and dense
    batches, and ``accuracy``."""
    csr, y = _random_sparse(50, 20, density=0.15, seed=13)
    j = _learn("jax", csr, y, kernel, epsilon=1e-8, max_iter=300)
    state = {"kernel": int(j.kernel), "degree": j.degree, "gamma": j.gamma, "coef0": j.coef0,
             "alphas": j.alphas, "bias_": j.bias_, "support_vectors": j.data.csr,
             "values": j.values, "sparse_threshold": j.params.sparse_threshold}
    t = tp.csvm_from_state(state, dtype=np.float64, print_info=False)
    assert t._use_sparse() and t.data._dense is None
    test_csr, _ = _random_sparse(15, 20, density=0.15, seed=14)
    P = test_csr.toarray()
    np.testing.assert_allclose(t.predict(P), j.predict(P), rtol=1e-10, atol=1e-10)
    for parsed_t, parsed_j in [(TParsed(csr=test_csr, values=None),
                                JParsed(csr=test_csr, values=None)),
                               (TParsed(csr=sp.csr_matrix(np.ones((3, 20))), values=None),
                                JParsed(csr=sp.csr_matrix(np.ones((3, 20))), values=None))]:
        np.testing.assert_allclose(t.predict_parsed(parsed_t), j.predict_parsed(parsed_j),
                                   rtol=1e-10, atol=1e-10)
    assert t.data._dense is None  # nothing densified the support vectors
    assert t.accuracy() == j.accuracy()
    np.testing.assert_array_equal(t.predict_label_parsed(TParsed(csr=test_csr, values=None)),
                                  j.predict_label_parsed(JParsed(csr=test_csr, values=None)))


@pytest.mark.parametrize("kernel", [KT.linear, KT.polynomial, KT.rbf])
def test_sparse_model_file_equals_dense(kernel, tmp_path):
    csr, y = _random_sparse(40, 18, density=0.2, seed=11)
    svm = _learn("torch", csr, y, kernel, epsilon=1e-8, max_iter=300)
    svm.write_model(str(tmp_path / "s.model"))
    write_model_file(str(tmp_path / "d.model"), kernel=svm.kernel, rho=-svm.bias_,
                     data=csr.toarray(), labels=y, alphas=svm.alphas, degree=svm.degree,
                     gamma=svm.gamma, coef0=svm.coef0)
    assert (tmp_path / "s.model").read_text() == (tmp_path / "d.model").read_text()


# --- CLIs ---------------------------------------------------------------------

#: (fixture, --sparse_threshold): the reference's 5x4.sparse (density 0.25)
#: takes the sparse path at the default threshold; 120x16.sparse (density
#: 0.40) takes the dense path there in both packages, and the sparse path
#: at 0.5
CLI_CASES = [("5x4.sparse", None), ("120x16.sparse", None), ("120x16.sparse", "0.5")]


@pytest.mark.parametrize("kernel_flag", ["0", "1", "2"])
@pytest.mark.parametrize("dataset,threshold", CLI_CASES)
def test_sparse_cli_matches_jax(dataset, threshold, kernel_flag, reference_data_dir, tmp_path):
    import os

    path = (os.path.join(os.path.dirname(__file__), "data", f"{dataset}.libsvm")
            if dataset.startswith("120") else f"{reference_data_dir}/libsvm/{dataset}.libsvm")
    extra = [] if threshold is None else ["--sparse_threshold", threshold]
    flags = ["-q", "-t", kernel_flag, "-e", "1e-6"] + extra
    t_model, j_model = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    gm.reset_launches()
    assert train_main(flags + [path, t_model]) == 0
    assert jax_train(flags + [path, j_model]) == 0
    assert predict_main(["-q"] + extra + [path, t_model, str(tmp_path / "t.predict")]) == 0
    assert jax_predict(["-q"] + extra + [path, j_model, str(tmp_path / "j.predict")]) == 0
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t.predict"),
                                  np.loadtxt(tmp_path / "j.predict"))
    assert not any(gm.launches.values())  # the CPU runs the plain versions
    p = tp.Parameter(kernel=tp.KernelType.from_string(kernel_flag), epsilon=1e-6,
                     print_info=False)
    if threshold is not None:
        p.sparse_threshold = float(threshold)
    p.parse_train_file(path)
    svm = tp.make_csvm(p)
    svm.learn()
    sparse = p.data.density <= p.sparse_threshold
    assert sparse == (dataset.startswith("5x4") or threshold is not None)
    want = {"0": "linear", "1": "cached", "2": "cached"}[kernel_flag]
    if sparse:
        want = "sparse_linear" if kernel_flag == "0" else "sparse_gram"
    assert svm.last_cg_info["mode"] == want
