"""The port's ``ops/sparse.py`` and K3's plain version against the JAX
package on the CPU (mirrors the op-level classes of ``test_sparse.py``).

The same seeded scipy matrices and numpy vectors go through both packages
in float64.  Packings are host numpy code in both, so they must agree
exactly.  Products and matvecs agree to 1e-12 relative (one-pass sums over
at most a few hundred terms, in another order); the panel matvecs and the
gather arm, which sum more terms through a kernel transform, to 1e-10
relative, as ``test_sparse.py`` holds the JAX package's own schedules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plssvm_sparse_fp22_tpu.ops import pallas_matvec as jpm
from plssvm_sparse_fp22_tpu.ops import sparse as js
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops import sparse as ts
from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_matrix
from plssvm_sparse_fp22_tpu_torch.types import KernelType

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
RTOL = 1e-12


def _random_sparse(n, f, density=0.1, seed=0):
    """``test_sparse.py``'s generator: no empty rows."""
    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    return csr.tocsr()


def _skewed(n=50, f=400, seed=3, heavy=(7,)):
    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=0.02, format="lil", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for r in heavy:
        csr[r, :] = rng.normal(size=f)
    csr = csr.tocsr()
    csr.eliminate_zeros()
    return csr


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- packings -----------------------------------------------------------------


@pytest.mark.parametrize("pad_rows", [None, 48])
def test_ell_packing_and_products_match_jax(pad_rows):
    csr = _random_sparse(30, 12, seed=1)
    t = ts.ELLMatrix.from_csr(csr, dtype=np.float64, pad_rows=pad_rows)
    j = js.ELLMatrix.from_csr(csr, dtype=np.float64, pad_rows=pad_rows)
    np.testing.assert_array_equal(_np(t.values), _np(j.values))
    np.testing.assert_array_equal(_np(t.cols), _np(j.cols))
    assert t.shape == j.shape and t.row_capacity == j.row_capacity
    rng = np.random.default_rng(2)
    u, v = rng.normal(size=12), rng.normal(size=t.shape[0])
    n = csr.shape[0]
    got = _np(ts.ell_matvec(t, _t(u)))
    np.testing.assert_allclose(got[:n], csr @ u, rtol=RTOL)
    assert not got[n:].any()
    np.testing.assert_allclose(got, _np(js.ell_matvec(j, jnp.asarray(u))), rtol=RTOL)
    np.testing.assert_allclose(_np(ts.ell_rmatvec(t, _t(v))),
                               _np(js.ell_rmatvec(j, jnp.asarray(v))), rtol=RTOL)
    np.testing.assert_allclose(_np(ts.ell_rmatvec(t, _t(v)))[:], csr.T @ v[:n], rtol=RTOL)
    np.testing.assert_allclose(_np(ts.ell_row_sqnorms(t)), _np(js.ell_row_sqnorms(j)),
                               rtol=RTOL)


def test_hybrid_packing_is_bounded_and_matches_jax():
    csr = _skewed()
    t = ts.HybridSparse.from_csr(csr, dtype=np.float64)
    j = js.HybridSparse.from_csr(csr, dtype=np.float64)
    for a, b in [(t.ell.values, j.ell.values), (t.ell.cols, j.ell.cols),
                 (t.coo_rows, j.coo_rows), (t.coo_cols, j.coo_cols), (t.coo_vals, j.coo_vals)]:
        np.testing.assert_array_equal(_np(a), _np(b))
    # the dense row spills into the COO tail instead of widening every row
    plain = ts.ELLMatrix.from_csr(csr, dtype=np.float64)
    assert plain.row_capacity == 400 and t.ell.row_capacity < 40
    assert t.ell.values.numel() + 3 * t.coo_vals.numel() < plain.values.numel() / 5
    # nonzeros are conserved: ELL cells + COO tail == nnz
    assert int((t.ell.values != 0).sum()) + t.coo_vals.numel() == csr.nnz


def test_hybrid_products_match_jax_and_csr():
    csr = _skewed()
    t = ts.HybridSparse.from_csr(csr, dtype=np.float64, pad_rows=64)
    j = js.HybridSparse.from_csr(csr, dtype=np.float64, pad_rows=64)
    rng = np.random.default_rng(5)
    u, v = rng.normal(size=400), rng.normal(size=64)
    v[50:] = 0.0
    cases = [(ts.hybrid_matvec(t, _t(u)), js.hybrid_matvec(j, jnp.asarray(u))),
             (ts.hybrid_rmatvec(t, _t(v)), js.hybrid_rmatvec(j, jnp.asarray(v))),
             (ts.hybrid_row_sqnorms(t), js.hybrid_row_sqnorms(j))]
    for got, want in cases:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(_np(cases[0][0])[:50], csr @ u, rtol=RTOL)
    np.testing.assert_allclose(_np(cases[1][0]), csr.T @ v[:50], rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(_np(cases[2][0])[:50],
                               np.asarray(csr.multiply(csr).sum(axis=1)).ravel(), rtol=RTOL)


@pytest.mark.parametrize("cap", [None, 0, 2])
def test_tiled_packing_matches_jax(cap):
    csr = _skewed(n=60, f=300, heavy=(7, 41))
    t = ts.pack_tiled_hybrid(csr, dtype=np.float32, pad_rows=64, cap=cap)
    j = js.pack_tiled_hybrid(csr, dtype=np.float32, pad_rows=64, cap=cap)
    np.testing.assert_array_equal(_np(t[0].vals), _np(j[0].vals))
    np.testing.assert_array_equal(_np(t[0].lcols), _np(j[0].lcols))
    assert (t[0].shape, t[0].ntiles, t[0].Lt) == (j[0].shape, j[0].ntiles, j[0].Lt)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])


def test_tiled_hybrid_skew_keeps_memory_bounded():
    rng = np.random.default_rng(3)
    csr = sp.random(2000, 1024, density=0.02, format="lil", random_state=rng)
    csr[7, :] = rng.normal(size=1024)
    csr = csr.tocsr()
    csr.eliminate_zeros()
    th = ts.TiledHybrid.from_csr(csr, dtype=np.float64)
    raw = ts.TiledELL.from_csr(csr, dtype=np.float64)
    assert raw.Lt == 128  # the uncapped packing blows up...
    assert th.tell.Lt < 16  # ...the capped one spills the row instead
    assert 7 in th.heavy_idx
    assert th.cells < 2000 * th.tell.padded_features // 5


def test_tiled_storage_never_exceeds_padded_dense():
    csr = sp.random(20, 140, density=0.9, format="csr", random_state=np.random.default_rng(11))
    tell = ts.TiledELL.from_csr(csr, dtype=np.float32)
    assert tell.Lt <= 128
    assert tell.vals.shape[1] <= tell.padded_features


# --- densify and tiled products ------------------------------------------------


@pytest.mark.parametrize("pad_rows", [None, 48])
def test_densify_tiled_matches_jax_and_csr(pad_rows):
    csr = _random_sparse(40, 300, density=0.08, seed=3)
    tell = ts.TiledELL.from_csr(csr, dtype=np.float64, pad_rows=pad_rows)
    jell = js.TiledELL.from_csr(csr, dtype=np.float64, pad_rows=pad_rows)
    got = _np(ts.densify_tiled(tell.vals, tell.lcols, tell.ntiles, tell.Lt))
    want = _np(js.densify_tiled(jell.vals, jell.lcols, jell.ntiles, jell.Lt))
    np.testing.assert_array_equal(got, want)
    expect = np.zeros((pad_rows or 40, tell.padded_features))
    expect[:40, :300] = csr.toarray()
    np.testing.assert_array_equal(got, expect)


def test_densify_tiled_keeps_real_entries_at_local_column_zero():
    """A tile whose real entry sits at local column 0 beside padding slots
    (value 0 at local column 0 as well): the padding must not overwrite it."""
    dense = np.zeros((3, 260))
    dense[0, [0, 5]] = [1.5, -2.0]  # tile 0: fill 2, one padding slot (Lt = 3)
    dense[1, [0, 1, 2]] = [3.0, 4.0, 5.0]  # tile 0: fill 3
    dense[1, 128] = 7.0  # tile 1, local column 0, two padding slots
    dense[2, [256, 259]] = [-1.0, 2.5]  # tile 2, local column 0
    tell = ts.TiledELL.from_csr(sp.csr_matrix(dense), dtype=np.float64)
    assert tell.Lt == 3
    got = _np(ts.densify_tiled(tell.vals, tell.lcols, tell.ntiles, tell.Lt))
    np.testing.assert_array_equal(got[:, :260], dense)
    assert not got[:, 260:].any()


def test_tiled_matvec_matches_jax():
    csr = _random_sparse(30, 200, density=0.1, seed=7)
    tell = ts.TiledELL.from_csr(csr, dtype=np.float64)
    jell = js.TiledELL.from_csr(csr, dtype=np.float64)
    u = np.random.default_rng(1).normal(size=tell.padded_features)
    got = _np(ts.tiled_matvec(tell.vals, tell.lcols, _t(u), tell.ntiles, tell.Lt))
    np.testing.assert_allclose(got, csr @ u[:200], rtol=RTOL)
    np.testing.assert_allclose(
        got, _np(js.tiled_matvec(jell.vals, jell.lcols, jnp.asarray(u), jell.ntiles, jell.Lt)),
        rtol=RTOL)
    np.testing.assert_array_equal(_np(ts.tiled_global_cols(3, 2)),
                                  _np(js.tiled_global_cols(3, 2)))


# --- K3's plain version ------------------------------------------------------


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("kernel", KERNELS)
def test_pair_gram_contrib_plain_matches_jax(kernel, same):
    """Against the Pallas kernel in interpret mode (as ``test_sparse.py:545``
    runs it) and against its XLA twin.  With ``same`` the two split the
    operator differently (triangle + transpose vs full), so their sums are
    compared."""
    rng = np.random.default_rng(19)
    Di, Dj, f = 24, 24 if same else 40, 33
    Xi = rng.normal(size=(Di, f))
    Xj = Xi if same else rng.normal(size=(Dj, f))
    vi = rng.normal(size=Di)
    vj = vi if same else rng.normal(size=Dj)
    kw = dict(same=same, degree=3, gamma=0.2, coef0=1.0)
    oi, oj = gm.pair_gram_contrib_plain(kernel, _t(Xi), _t(Xj), _t(vi), _t(vj), row_block=16,
                                        **kw)
    jk = JKernel(int(kernel))
    args = (jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(vi), jnp.asarray(vj))
    for want_i, want_j in (jpm.pair_gram_contrib(jk, *args, interpret=True, bm=16, **kw),
                           jpm.pair_gram_contrib_xla(jk, *args, **kw)):
        if same:
            np.testing.assert_allclose(_np(oi + oj), _np(want_i + want_j), rtol=1e-10,
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(_np(oi), _np(want_i), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(_np(oj), _np(want_j), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shapes", [(8, 8, 5), (100, 36, 129), (257, 64, 200), (64, 512, 64)])
def test_pair_gram_contrib_shape_fuzz(shapes):
    """The wrapper on CPU tensors (the plain version) at ragged panel shapes,
    against the XLA twin; it launches nothing."""
    Di, Dj, f = shapes
    rng = np.random.default_rng(Di + Dj + f)
    Xi, Xj = rng.normal(size=(Di, f)), rng.normal(size=(Dj, f))
    vi, vj = rng.normal(size=Di), rng.normal(size=Dj)
    kw = dict(same=False, degree=3, gamma=0.05, coef0=1.0)
    gm.reset_launches()
    oi, oj = gm.pair_gram_contrib(KernelType.rbf, _t(Xi), _t(Xj), _t(vi), _t(vj), **kw)
    assert not any(gm.launches.values())
    wi, wj = jpm.pair_gram_contrib_xla(JKernel.rbf, jnp.asarray(Xi), jnp.asarray(Xj),
                                       jnp.asarray(vi), jnp.asarray(vj), **kw)
    np.testing.assert_allclose(_np(oi), _np(wi), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(_np(oj), _np(wj), rtol=1e-9, atol=1e-11)


# --- panel matvecs ------------------------------------------------------------

MAKERS = {"unrolled": (ts.make_tiled_panel_matvec, js.make_tiled_panel_matvec),
          "windowed": (ts.make_tiled_panel_matvec_windowed,
                       js.make_tiled_panel_matvec_windowed)}


@pytest.mark.parametrize("schedule", sorted(MAKERS))
@pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
def test_panel_matvec_matches_dense_gram_and_jax(schedule, kernel):
    """Both pair-sweep schedules equal the dense kernel matvec, including a
    ragged last panel and the single-panel case, and the JAX schedule."""
    csr = _random_sparse(100, 60, density=0.15, seed=13)
    tell = ts.TiledELL.from_csr(csr, dtype=np.float64)
    jell = js.TiledELL.from_csr(csr, dtype=np.float64)
    make_t, make_j = MAKERS[schedule]
    K = _np(gram_matrix(kernel, _t(csr.toarray()), degree=3, gamma=0.3, coef0=1.0))
    v = np.random.default_rng(17).normal(size=100)
    for panel_rows in (100, 32, 48):
        mv, sq = make_t(tell.vals, tell.lcols, int(kernel), 3, 0.3, 1.0, ntiles=tell.ntiles,
                        Lt=tell.Lt, panel_rows=panel_rows, use_cuda=False)
        got = _np(mv(_t(v)))
        np.testing.assert_allclose(got, K @ v, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(_np(sq), np.asarray(csr.multiply(csr).sum(axis=1)).ravel(),
                                   rtol=RTOL)
        mv_j, _ = make_j(jell.vals, jell.lcols, int(kernel), 3, 0.3, 1.0, ntiles=jell.ntiles,
                         Lt=jell.Lt, panel_rows=panel_rows, use_pallas=False)
        np.testing.assert_allclose(got, _np(mv_j(jnp.asarray(v))), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("schedule", sorted(MAKERS))
def test_panel_matvec_places_heavy_rows(schedule):
    """Heavy rows in the first and a later panel land where they belong."""
    rng = np.random.default_rng(31)
    dense = np.zeros((96, 70))
    m = rng.random((96, 70)) < 0.1
    dense[m] = rng.normal(size=int(m.sum()))
    dense[5] = rng.normal(size=70)
    dense[70] = rng.normal(size=70)
    th = ts.TiledHybrid.from_csr(sp.csr_matrix(dense), dtype=np.float64)
    assert len(th.heavy_idx) >= 2
    hs = np.zeros(96)
    hs[th.heavy_idx] = (dense[th.heavy_idx] ** 2).sum(axis=1)
    mv, sq = MAKERS[schedule][0](
        th.tell.vals, th.tell.lcols, int(KernelType.rbf), 3, 0.1, 0.0, ntiles=th.tell.ntiles,
        Lt=th.tell.Lt, panel_rows=32, use_cuda=False, heavy=th.heavy,
        heavy_rows=tuple(int(r) for r in th.heavy_idx), heavy_sq_vec=_t(hs))
    v = rng.normal(size=96)
    K = _np(gram_matrix(KernelType.rbf, _t(dense), gamma=0.1))
    np.testing.assert_allclose(_np(mv(_t(v))), K @ v, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_np(sq), (dense ** 2).sum(axis=1), rtol=RTOL)


@pytest.mark.parametrize("tier", ["exact", "bf16x3", "bf16cast"])
@pytest.mark.parametrize("schedule", sorted(MAKERS))
def test_panel_matvec_prepares_each_panel_once_per_densify(schedule, tier, monkeypatch):
    """A panel's operands for the tier (the bf16 split or cast) are prepared
    once per densify and shared by every pair that uses the panel: at 3
    panels the ``unrolled`` sweep densifies and prepares 3 times per A·v
    (for 6 pairs), the ``windowed`` one 8 times (3 diagonal panels, the
    i-panels of rows 1 and 2, and a j-panel for each of the 3 cross pairs).
    The result equals the schedule without the sharing: each pair preparing
    its own panels."""
    csr = _random_sparse(96, 60, density=0.15, seed=14)
    tell = ts.TiledELL.from_csr(csr, dtype=np.float32)
    densifies = []
    densify = ts.densify_tiled
    monkeypatch.setattr(ts, "densify_tiled",
                        lambda *args: densifies.append(1) or densify(*args))
    mv, _ = MAKERS[schedule][0](tell.vals, tell.lcols, int(KernelType.rbf), 3, 0.3, 1.0,
                                ntiles=tell.ntiles, Lt=tell.Lt, panel_rows=32, use_cuda=False,
                                precision=tier)
    v = _t(np.random.default_rng(18).normal(size=96).astype(np.float32))
    gm.reset_preparations()
    got = mv(v)
    want_count = {"unrolled": 3, "windowed": 8}[schedule]
    assert len(densifies) == want_count
    assert gm.preparations == {t: (want_count if t == tier else 0) for t in gm.TIERS}

    # the same sweep with every pair preparing its own panels
    X = _t(csr.toarray().astype(np.float32))
    sq = gm.row_sqnorms(X)
    want = torch.zeros(96)
    for i in range(3):
        for j in range(i + 1):
            si, sj = slice(32 * i, 32 * i + 32), slice(32 * j, 32 * j + 32)
            oi, oj = gm.pair_gram_contrib_plain(KernelType.rbf, X[si], X[sj], v[si], v[sj],
                                                same=i == j, sq_i=sq[si], sq_j=sq[sj], degree=3,
                                                gamma=0.3, coef0=1.0, tier=tier)
            want[si] += oi
            want[sj] += oj
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6 * float(want.abs().max()))


def test_panel_schedules_and_sizes():
    assert ts.stream_panel_rows(16384, 4096, 4, 512 * 1024**2) == \
        js.stream_panel_rows(16384, 4096, 4, 512 * 1024**2) == 4096
    assert ts.stream_panel_rows(1000, 4096, 4, 10) == 256  # the 256-row floor
    assert ts.stream_panel_rows(100, 128, 8, 1 << 30) == 100
    assert ts.panel_sweep_strategy(1, 10, 1) == "unrolled"
    assert ts.panel_sweep_strategy(4, 100, 400) == "unrolled"
    assert ts.panel_sweep_strategy(4, 100, 399) == "windowed"
    assert ts.panel_sweep_strategy(4) == "unrolled"


def test_sweep_and_stream_strategies_obey_their_knobs(monkeypatch):
    assert ts.streaming_stream_strategy(100, 2048) == "panel"
    assert ts.streaming_stream_strategy(30, 1_300_000) == "gather"
    monkeypatch.setenv("PLSSVM_SPARSE_STREAM", "gather")
    assert ts.streaming_stream_strategy(100, 2048) == "gather"
    monkeypatch.setenv("PLSSVM_SPARSE_STREAM", "mxu")
    assert ts.streaming_stream_strategy(30, 1_300_000) == "panel"
    monkeypatch.setenv("PLSSVM_SPARSE_PANEL_SWEEP", "windowed")
    assert ts.panel_sweep_strategy(1) == "windowed"
    monkeypatch.setenv("PLSSVM_DEVICE_GRAM_MAX_FEATURES", "77")
    assert ts.device_gram_max_features() == js.device_gram_max_features() == 77
    monkeypatch.setenv("PLSSVM_DEVICE_GRAM_MAX_FEATURES", "many")
    assert ts.device_gram_max_features() == ts.DEVICE_GRAM_MAX_FEATURES


# --- the gather arm ------------------------------------------------------------


@pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
def test_gather_arm_matches_dense_gram_and_jax(kernel, monkeypatch):
    """The streaming gather matvec over an ELL+COO packing with a COO tail
    (a heavy row), with the row side cut into several gather chunks."""
    monkeypatch.setattr(ts, "GATHER_CHUNK_BYTES", 1)  # one bm-row block per chunk
    csr = _skewed(n=250, f=300, seed=9, heavy=(11, 200))
    n_pad = 256
    t = ts.HybridSparse.from_csr(csr, dtype=np.float64, pad_rows=n_pad)
    j = js.HybridSparse.from_csr(csr, dtype=np.float64, pad_rows=n_pad)
    assert t.coo_vals.numel() > 0
    mv, sq = ts.make_streaming_gram_matvec(t, int(kernel), 3, 0.05, 1.0, bm=128, bn=128)
    v = np.random.default_rng(4).normal(size=n_pad)
    v[250:] = 0.0
    got = _np(mv(_t(v)))
    dense = np.zeros((n_pad, 300))
    dense[:250] = csr.toarray()
    K = _np(gram_matrix(kernel, _t(dense), degree=3, gamma=0.05, coef0=1.0))
    np.testing.assert_allclose(got, K @ v, rtol=1e-10, atol=1e-10)
    mv_j, _ = js.make_streaming_gram_matvec(j, int(kernel), 3, 0.05, 1.0, bm=128, bn=128)
    np.testing.assert_allclose(got, _np(mv_j(jnp.asarray(v))), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="must divide"):
        ts.make_streaming_gram_matvec(t, int(kernel), 3, 0.05, 1.0, bm=100, bn=128)


# --- Gram helpers and the shared transform ---------------------------------------


def test_gram_helpers_match_jax():
    csr = sp.random(100, 37, density=0.15, random_state=0, format="csr")
    other = sp.random(20, 37, density=0.2, random_state=1, format="csr")
    np.testing.assert_array_equal(ts.host_gram_from_csr(csr, dept=99),
                                  js.host_gram_from_csr(csr, dept=99))
    np.testing.assert_array_equal(ts.host_cross_gram_from_csr(other, csr),
                                  js.host_cross_gram_from_csr(other, csr))
    t = ts.ELLMatrix.from_csr(csr, dtype=np.float64, pad_rows=128)
    G = _np(ts.device_gram_from_ell(t))
    np.testing.assert_allclose(G[:100, :100], js.host_gram_from_csr(csr), rtol=RTOL)
    assert not G[100:].any() and not G[:, 100:].any()
    np.testing.assert_allclose(
        G, _np(js.device_gram_from_ell(js.ELLMatrix.from_csr(csr, dtype=np.float64,
                                                              pad_rows=128))), rtol=RTOL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sparse_q_qa_kii_matches_jax(kernel):
    rng = np.random.default_rng(int(kernel))
    g, sq = rng.normal(size=16), rng.random(16) * 4
    mask = (np.arange(16) < 13).astype(np.float64)
    args = (int(kernel), 3, 0.25, 0.5)
    got = ts.sparse_q_qa_kii(*args, _t(g), torch.tensor(2.0, dtype=torch.float64), _t(sq),
                             _t(mask), torch.tensor(0.5, dtype=torch.float64))
    want = js.sparse_q_qa_kii(*args, jnp.asarray(g), jnp.asarray(2.0), jnp.asarray(sq),
                              jnp.asarray(mask), jnp.asarray(0.5))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-14)
    G = rng.normal(size=(4, 5))
    np.testing.assert_allclose(
        _np(ts._transform_block(int(kernel), _t(G), _t(sq[:4]), _t(sq[:5]), 3, 0.25, 0.5)),
        _np(js._transform_block(int(kernel), jnp.asarray(G), jnp.asarray(sq[:4]),
                                jnp.asarray(sq[:5]), 3, 0.25, 0.5)), rtol=1e-14)


def test_segment_sum_adds_every_duplicate():
    data = _t(np.array([1.0, 2.0, 3.0, 4.0, 0.0]))
    ids = torch.tensor([2, 0, 2, 3, 0], dtype=torch.int32)
    np.testing.assert_array_equal(_np(ts.segment_sum(data, ids, 5)), [2.0, 0, 4.0, 4.0, 0])
