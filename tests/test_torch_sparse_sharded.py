"""The port's sparse sharded learns on logical CPU shards.

The sparse cases of ``tests/test_sharded_api.py`` (``TestSparseSharded``,
``test_wide_sparse_on_mesh_picks_gram_tier``,
``test_sparse_ring_multi_panel_in_shard``, ``test_sparse_ring_with_heavy_rows``)
through the port's ``CSVM`` with ``devices=`` given, since the port's CPU
default is one device; then the functions of ``parallel/sharded.py`` against
the JAX package's on its 8 virtual devices: ``shard_sparse_system`` and
``shard_sparse_tiled_system`` give the same arrays, one A·v of each sparse
ring equals the JAX package's single-device operator on the densified data,
and each learn the JAX package's sharded learn.

The JAX package's ring learns run once each, on 8 devices (a JAX ring
compiles for seconds on the CPU); the port's run on 2, 4 and 8 shards.

Tolerances.  The learns run float64 to eps 1e-10 (1e-4 per alpha and 5e-3 on
the sums, as ``tests/test_sharded_api.py``; iterations within 2).  One A·v
is the same sums in another order: 1e-10 of its scale.  float32 panel pairs
at a tier against the single-device panel operator at that tier: 1e-5 of the
scale, as ``tests/test_torch_parallel.py``.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import plssvm_sparse_fp22_tpu as jp
import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed
from plssvm_sparse_fp22_tpu.ops.matvec import build_operator as jax_build_operator
from plssvm_sparse_fp22_tpu.ops.sparse import HybridSparse as JHybrid, TiledHybrid as JTiled
from plssvm_sparse_fp22_tpu.parallel import sharded as jsharded
from plssvm_sparse_fp22_tpu.parallel.mesh import make_mesh as jax_make_mesh
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
from plssvm_sparse_fp22_tpu_torch.ops.matvec import _corrections
from plssvm_sparse_fp22_tpu_torch.ops.sparse import (HybridSparse, TiledHybrid,
                                                     make_tiled_panel_matvec)
from plssvm_sparse_fp22_tpu_torch.parallel import sharded
from plssvm_sparse_fp22_tpu_torch.parallel.mesh import make_mesh
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

from utils import make_blobs

HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
COST = 2.0
N = 1100


def _random_sparse(n, f, density=0.15, seed=0):
    """``tests/test_sharded_api.py``'s generator: no empty row."""
    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y


def _train(csr, y, kernel, pkg=tp, parsed=ParsedData, sparse=True, **overrides):
    params = pkg.Parameter(kernel=pkg.KernelType(int(kernel)), cost=COST, epsilon=1e-10,
                           max_iter=300, print_info=False, dtype=np.float64,
                           sparse_threshold=1.0 if sparse else 0.25, **HYPER)
    for k, v in overrides.items():
        setattr(params, k, v)
    params.data = (parsed(csr=csr, values=y) if sparse
                   else parsed(csr=sp.csr_matrix(csr), values=y, _dense=np.asarray(csr)))
    params.values = y
    svm = pkg.make_csvm(params)
    svm.learn()
    return svm


def _assert_matches(alphas, bias, alpha_ref, bias_ref, tol=1e-4, sum_tol=5e-3):
    np.testing.assert_allclose(alphas[:-1], alpha_ref[:-1], rtol=tol, atol=tol)
    assert alphas[-1] == pytest.approx(alpha_ref[-1], rel=sum_tol, abs=sum_tol)
    assert bias == pytest.approx(bias_ref, rel=sum_tol, abs=sum_tol)


@pytest.fixture(scope="module")
def sparse_blobs():
    return _random_sparse(N, 40, density=0.15, seed=41)


@pytest.fixture(scope="module")
def sparse_blobs_small():
    return _random_sparse(520, 40, density=0.15, seed=43)


# ---------------------------------------------------------------------------
# the product surface (tests/test_sharded_api.py)
# ---------------------------------------------------------------------------

class TestSparseSharded:
    def test_sparse_linear_spans_mesh(self, sparse_blobs):
        """Linear CSR data row-shards over 8 shards (ELL+COO slabs, the
        feature-space product reduced over the shards) and matches the dense
        one-device learn."""
        csr, y = sparse_blobs
        svm = _train(csr, y, KernelType.linear, devices=8)
        assert svm.last_cg_info["mode"] == "sharded_sparse_linear[8]", svm.last_cg_info
        dense = _train(csr.toarray(), y, KernelType.linear, sparse=False, devices=1)
        _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)

    def test_sparse_linear_sharded_jacobi(self, sparse_blobs):
        csr, y = sparse_blobs
        svm = _train(csr, y, KernelType.linear, devices=8, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_sparse_linear[8]"
        dense = _train(csr.toarray(), y, KernelType.linear, sparse=False, devices=1)
        _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)

    def test_sparse_rbf_densifies_onto_mesh(self, sparse_blobs):
        """poly/rbf sparse data within the budget densifies onto the dense
        sharded learn."""
        csr, y = sparse_blobs
        svm = _train(csr, y, KernelType.rbf, devices=8)
        assert svm.last_cg_info["mode"] == "sharded_cached[8]", svm.last_cg_info
        dense = _train(csr.toarray(), y, KernelType.rbf, sparse=False, devices=1)
        _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)

    @pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf],
                             ids=lambda k: k.name)
    def test_sparse_beyond_budget_rings_the_mesh(self, sparse_blobs_small, monkeypatch, kernel):
        """Beyond the budget poly/rbf sparse data walks the ring, each shard
        holding its own packing, and matches the dense one-device learn."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        csr, y = sparse_blobs_small
        svm = _train(csr, y, kernel, devices=8)
        assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", svm.last_cg_info
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        dense = _train(csr.toarray(), y, kernel, sparse=False, devices=1)
        _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)

    def test_sparse_beyond_budget_ring_jacobi(self, sparse_blobs_small, monkeypatch):
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        csr, y = sparse_blobs_small
        svm = _train(csr, y, KernelType.rbf, devices=8, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]"
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        dense = _train(csr.toarray(), y, KernelType.rbf, sparse=False, devices=1)
        _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)

    def test_sparse_forced_tier_pins_single_chip(self, sparse_blobs, monkeypatch):
        """A forced ``PLSSVM_SPARSE_MODE`` keeps the one-device tier."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        csr, y = sparse_blobs
        svm = _train(csr, y, KernelType.rbf, devices=8, max_iter=25)
        assert svm.last_cg_info["mode"] == "sparse_implicit"


def test_wide_sparse_on_mesh_picks_gram_tier(monkeypatch):
    """Wide data (f >> n) on several devices: dense X is beyond the budget,
    the (D, D) Gram within it, so the one-device ``gram`` tier runs."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "10000000")
    csr, y = _random_sparse(520, 8192, density=0.005, seed=47)
    svm = _train(csr, y, KernelType.rbf, devices=8, max_iter=40)
    assert svm.last_cg_info["mode"] == "sparse_gram", svm.last_cg_info


def test_sparse_ring_multi_panel_in_shard(monkeypatch):
    """A budget below a shard's dense block cuts each shard into two panels
    (256 + 128 rows)."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "120000")
    csr, y = _random_sparse(1100, 40, density=0.15, seed=53)
    svm = _train(csr, y, KernelType.rbf, devices=4)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    dense = _train(csr.toarray(), y, KernelType.rbf, sparse=False, devices=1)
    _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)


def _heavy_csr(n=1100, f=300, seed=59, heavy=(3, 540, 1050), scale=1.0):
    """Sparse data with dense rows, values ``scale`` times normal, on several
    shards: the panel ring's heavy-row spill."""
    rng = np.random.default_rng(seed)
    csr = _random_sparse(n, f, density=0.05, seed=seed)[0].tolil()
    for r in heavy:
        csr[r, :] = scale * rng.normal(size=f)
    return csr.tocsr(), np.where(rng.normal(size=n) > 0, 1.0, -1.0)


def test_sparse_ring_with_heavy_rows(monkeypatch):
    """The heavy rows ride the ring beside the tiled slabs."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "100000")
    csr, y = _heavy_csr()
    svm = _train(csr, y, KernelType.rbf, devices=4)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    dense = _train(csr.toarray(), y, KernelType.rbf, sparse=False, devices=1)
    _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)


def test_gather_ring_through_the_api(sparse_blobs_small, monkeypatch):
    """``PLSSVM_SPARSE_STREAM=gather`` takes the gather ring, which matches
    the dense one-device learn."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    monkeypatch.setenv("PLSSVM_SPARSE_STREAM", "gather")
    csr, y = sparse_blobs_small
    svm = _train(csr, y, KernelType.rbf, devices=8)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    dense = _train(csr.toarray(), y, KernelType.rbf, sparse=False, devices=1)
    _assert_matches(svm.alphas, svm.bias_, dense.alphas, dense.bias_)


def test_ring_arms_refuse_the_chunked_cg_flags(sparse_blobs_small, monkeypatch, tmp_path):
    from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError

    csr, y = sparse_blobs_small
    with pytest.raises(PLSSVMError, match="not supported on the sparse"):
        _train(csr, y, KernelType.linear, devices=4, verbose_cg=True)
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    with pytest.raises(PLSSVMError, match="not supported on the sparse"):
        _train(csr, y, KernelType.rbf, devices=4, checkpoint_path=str(tmp_path / "x.npz"))


# ---------------------------------------------------------------------------
# the functions against the JAX package
# ---------------------------------------------------------------------------

def _system(n=257, f=300, seed=61, D=512):
    """A padded float64 system with a COO tail and heavy rows on several
    shards (dense rows, scaled to the other rows' norm so that CG converges
    in few iterations): ``(csr, y, dept, b_pad, mask, x_last)``."""
    csr, y = _heavy_csr(n, f, seed, heavy=(5, 130, 250), scale=0.25)
    dept = n - 1
    b_pad = np.zeros(D)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return csr, y, dept, b_pad, mask, csr[-1].toarray().ravel()


def _jax_operator(kernel, csr, dept, mask, x_last, D):
    """The JAX package's one-device operator on the densified system."""
    X = np.zeros((D, csr.shape[1]))
    X[:dept] = csr[:dept].toarray()
    Xd, m, xl = jnp.asarray(X), jnp.asarray(mask), jnp.asarray(x_last)
    kernel = JKernel(int(kernel))
    from plssvm_sparse_fp22_tpu.ops.kernel_functions import (gram_block as jgram,
                                                           kernel_scalar as jscalar)

    q = jgram(kernel, Xd, xl[None, :], **HYPER)[:, 0] * m
    cost_inv = 1.0 / COST
    QA = jscalar(kernel, xl, xl, **HYPER) + cost_inv
    mode = "linear" if kernel == JKernel.linear else "implicit"
    return jax_build_operator(kernel, Xd, q, m, QA, cost_inv, mode=mode, **HYPER).matvec


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("p", [2, 4, 8])
def test_shard_functions_give_the_jax_arrays(p):
    csr, y, dept, b_pad, mask, _ = _system()
    D = len(mask)
    mesh, jmesh = make_mesh(p, devices=["cpu"]), jax_make_mesh(p)
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    jh = JHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    assert h.coo_vals.shape[0] > 0  # the tail is exercised
    got = sharded.shard_sparse_system(mesh, h, b_pad, mask)
    want = jsharded.shard_sparse_system(jmesh, jh, b_pad, mask)
    for g, w in zip(got[:5], want[:5]):
        assert all(t.device == torch.device("cpu") for t in g) and len(g) == p
        np.testing.assert_array_equal(torch.stack(g).numpy().reshape(np.shape(w)), np.asarray(w))
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    th = TiledHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    jth = JTiled.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    assert len(th.heavy_idx) >= 3  # heavy rows on several shards
    got = sharded.shard_sparse_tiled_system(mesh, th, b_pad, mask)
    want = jsharded.shard_sparse_tiled_system(jmesh, jth, b_pad, mask)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(torch.stack(g).numpy().reshape(np.shape(w)), np.asarray(w))
    assert int(got[3][-1].max()) == D // p  # padding slots hold the inert row m_loc
    with pytest.raises(ValueError, match="must divide"):
        sharded.shard_sparse_system(make_mesh(3, devices=["cpu"]), h, b_pad, mask)


def _port_ring(which, kernel, p, system, panel_rows=128, backend=BackendType.torch,
               precision=None):
    """The port's ring operator and learn for ``which`` in linear / panel /
    gather: ``(mv, learn_args, learn)`` on ``p`` logical CPU shards."""
    csr, y, dept, b_pad, mask, x_last = system
    D = len(mask)
    mesh = make_mesh(p, devices=["cpu"])
    xl = torch.from_numpy(x_last)
    if which == "panel":
        th = TiledHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
        tv, tc, hv, hr, b, m = sharded.shard_sparse_tiled_system(mesh, th, b_pad, mask)
        kw = {"ntiles": th.tell.ntiles, "Lt": th.tell.Lt, "panel_rows": panel_rows}
        mv = sharded._prepare_sparse_panel_local(
            kernel, mesh, tv, tc, hv, hr, xl, m, HYPER["gamma"], HYPER["coef0"], COST,
            HYPER["degree"], backend=backend, precond="none", precision=precision, **kw)[3]
        learn = sharded.make_sharded_sparse_panel_learn(mesh, kernel, HYPER["degree"], **kw)
        return mv, (tv, tc, hv, hr, xl, b, m, HYPER["gamma"], HYPER["coef0"]), learn
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    vals, cols, tr, tc, tv, b, m = sharded.shard_sparse_system(mesh, h, b_pad, mask)
    if which == "linear":
        mv = sharded._prepare_sparse_linear(mesh, vals, cols, tr, tc, tv, xl, m, COST, "none")[3]
        return (mv, (vals, cols, tr, tc, tv, xl, b, m),
                sharded.make_sharded_sparse_linear_learn(mesh))
    mv = sharded._prepare_sparse_gather_local(kernel, mesh, vals, cols, tr, tc, tv, xl, m,
                                              HYPER["gamma"], HYPER["coef0"], COST,
                                              HYPER["degree"], "none")[3]
    return (mv, (vals, cols, tr, tc, tv, xl, b, m, HYPER["gamma"], HYPER["coef0"]),
            sharded.make_sharded_sparse_streaming_learn(mesh, kernel, HYPER["degree"]))


def _jax_ring_learn(which, kernel, p, system, panel_rows=128):
    csr, y, dept, b_pad, mask, x_last = system
    D = len(mask)
    jmesh = jax_make_mesh(p)
    f64 = jnp.float64
    tail = (f64(COST), f64(1e-10), jnp.int32(300))
    hyper = (f64(HYPER["gamma"]), f64(HYPER["coef0"]))
    if which == "panel":
        th = JTiled.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
        tv, tc, hv, hr, b, m = jsharded.shard_sparse_tiled_system(jmesh, th, b_pad, mask)
        learn = jsharded.make_sharded_sparse_panel_learn(
            jmesh, JKernel(int(kernel)), HYPER["degree"], ntiles=th.tell.ntiles, Lt=th.tell.Lt,
            panel_rows=panel_rows)
        return learn(tv, tc, hv, hr, jnp.asarray(x_last), b, m, *hyper, *tail)
    h = JHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    args = jsharded.shard_sparse_system(jmesh, h, b_pad, mask)
    if which == "linear":
        learn = jsharded.make_sharded_sparse_linear_learn(jmesh)
        return learn(*args[:5], jnp.asarray(x_last), *args[5:], *tail)
    learn = jsharded.make_sharded_sparse_streaming_learn(jmesh, JKernel(int(kernel)),
                                                        HYPER["degree"])
    return learn(*args[:5], jnp.asarray(x_last), *args[5:], *hyper, *tail)


RINGS = [("linear", KernelType.linear), ("panel", KernelType.rbf), ("gather", KernelType.rbf)]


@functools.lru_cache(maxsize=None)
def _jax_solution(which, kernel):
    """The JAX package's sharded learn of ``_system()`` on its 8 devices:
    ``(x, iterations)``, computed once per ring (a JAX ring compiles for
    seconds on the CPU)."""
    out = _jax_ring_learn(which, kernel, 8, _system())
    return np.asarray(out[0]), int(out[4])


@pytest.mark.parametrize("which,kernel", RINGS, ids=[f"{w}-{k.name}" for w, k in RINGS])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_sparse_ring_matches_the_jax_package(which, kernel, p):
    """One A·v against the JAX package's one-device operator on the dense
    data; the learn on ``p`` shards against the JAX package's sharded learn
    on its 8; two learns bitwise equal."""
    system = _system()
    csr, y, dept, b_pad, mask, x_last = system
    mv, args, learn = _port_ring(which, kernel, p, system)
    v = np.random.default_rng(p).normal(size=len(mask)) * mask
    _close(mv(torch.from_numpy(v)), _jax_operator(kernel, csr, dept, mask, x_last,
                                                   len(mask))(jnp.asarray(v)), 1e-10)
    out = learn(*args, COST, 1e-10, 300)
    jx, jiters = _jax_solution(which, kernel)
    assert abs(out[4] - jiters) <= 2
    np.testing.assert_allclose(out[0].numpy(), jx, rtol=1e-4, atol=1e-4)
    assert float(out[5]) <= 1e-20 * float(out[6])
    again = learn(*args, COST, 1e-10, 300)
    assert again[4] == out[4] and torch.equal(again[0], out[0]) and torch.equal(again[5], out[5])


@pytest.mark.parametrize("p,panel_rows", [(2, 64), (4, 32)])
def test_panel_ring_densifies_once_per_hop(p, panel_rows, monkeypatch):
    """A shard's own panels are densified once per operator; each panel of
    a block in flight once per hop (hop 0 reads the shard's own); every
    panel pair is one hop product: ``p² nP²`` per A·v."""
    counts = {"densify": 0, "pairs": 0}
    densify, plain = sharded.densify_tiled, sharded.gram_matvec_plain

    def counted_densify(*a, **kw):
        counts["densify"] += 1
        return densify(*a, **kw)

    def counted_pair(*a, **kw):
        counts["pairs"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(sharded, "densify_tiled", counted_densify)
    monkeypatch.setattr(sharded, "gram_matvec_plain", counted_pair)
    system = _system()
    mv = _port_ring("panel", KernelType.rbf, p, system, panel_rows=panel_rows)[0]
    nP = len(system[4]) // p // panel_rows
    assert nP >= 2 and counts == {"densify": p * nP, "pairs": 0}
    v = torch.from_numpy(system[4])
    for k in (1, 2):
        mv(v)
        assert counts == {"densify": p * nP + k * p * (p - 1) * nP, "pairs": k * p * p * nP * nP}


@pytest.mark.parametrize("tier", ["exact", "bf16x3", "bf16cast"])
def test_panel_ring_at_each_tier_matches_the_single_device_panels(tier):
    """float32: the ring's panel pairs at a tier give the single-device panel
    operator's A·v at that tier (K1/K3's plain versions there)."""
    csr, y, dept, b_pad, mask, x_last = _system()
    D = len(mask)
    b32, m32 = b_pad.astype(np.float32), mask.astype(np.float32)
    mesh = make_mesh(2, devices=["cpu"])
    th = TiledHybrid.from_csr(csr[:dept], dtype=np.float32, pad_rows=D)
    tv, tc, hv, hr, b, m = sharded.shard_sparse_tiled_system(mesh, th, b32, m32)
    xl = torch.from_numpy(x_last.astype(np.float32))
    gm.reset_preparations()
    q, QA, ci, mv, _ = sharded._prepare_sparse_panel_local(
        KernelType.rbf, mesh, tv, tc, hv, hr, xl, m, HYPER["gamma"], HYPER["coef0"], COST,
        HYPER["degree"], ntiles=th.tell.ntiles, Lt=th.tell.Lt, panel_rows=64,
        backend=BackendType.torch, precond="none", precision=tier)
    assert gm.preparations[tier] == D // 64  # each shard's own panels, once
    heavy_sq = np.zeros(D, np.float32)
    heavy_sq[th.heavy_idx] = np.sum(th.heavy.numpy() ** 2, axis=1)
    kv, _ = make_tiled_panel_matvec(th.tell.vals, th.tell.lcols, int(KernelType.rbf),
                                    HYPER["degree"], HYPER["gamma"], HYPER["coef0"],
                                    ntiles=th.tell.ntiles, Lt=th.tell.Lt, panel_rows=128,
                                    use_cuda=False, heavy=th.heavy,
                                    heavy_rows=tuple(int(r) for r in th.heavy_idx),
                                    heavy_sq_vec=torch.from_numpy(heavy_sq), precision=tier)
    v = torch.from_numpy((np.random.default_rng(3).normal(size=D) * mask).astype(np.float32))
    _close(mv(v), _corrections(kv(v), v, q, m, QA, ci), 1e-5)


def test_panel_ring_refuses_a_system_off_its_devices():
    from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError

    system = _system()
    with pytest.raises(PLSSVMError, match="backend 'cuda' needs the system on CUDA devices"):
        _port_ring("panel", KernelType.rbf, 2, system, backend=BackendType.cuda)
    csr, y, dept, b_pad, mask, x_last = system
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=len(mask))
    vals, cols, tr, tc, tv, b, m = sharded.shard_sparse_system(make_mesh(4, devices=["cpu"]),
                                                               h, b_pad, mask)
    learn = sharded.make_sharded_sparse_linear_learn(make_mesh(2, devices=["cpu"]))
    with pytest.raises(ValueError, match="row blocks for a mesh"):
        learn(vals, cols, tr, tc, tv, torch.from_numpy(x_last), b, m, COST, 1e-6, 10)


def test_x_last_and_q_match_the_dense_system():
    """q, QA_cost and the Jacobi diagonal of each sparse ring equal the
    dense one-device system's."""
    csr, y, dept, b_pad, mask, x_last = system = _system()
    X = np.zeros((len(mask), csr.shape[1]))
    X[:dept] = csr[:dept].toarray()
    Xd, xl, m = torch.from_numpy(X), torch.from_numpy(x_last), torch.from_numpy(mask)
    for which, kernel in RINGS:
        mesh = make_mesh(4, devices=["cpu"])
        if which == "panel":
            th = TiledHybrid.from_csr(csr[:dept], dtype=np.float64, pad_rows=len(mask))
            tv, tc, hv, hr, _, mm = sharded.shard_sparse_tiled_system(mesh, th, b_pad, mask)
            q, QA, _, _, minv = sharded._prepare_sparse_panel_local(
                kernel, mesh, tv, tc, hv, hr, xl, mm, HYPER["gamma"], HYPER["coef0"], COST,
                HYPER["degree"], ntiles=th.tell.ntiles, Lt=th.tell.Lt, panel_rows=64,
                backend=BackendType.torch, precond="jacobi")
        else:
            h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=len(mask))
            vals, cols, tr, tc, tv, _, mm = sharded.shard_sparse_system(mesh, h, b_pad, mask)
            if which == "linear":
                q, QA, _, _, minv = sharded._prepare_sparse_linear(mesh, vals, cols, tr, tc, tv,
                                                                   xl, mm, COST, "jacobi")
            else:
                q, QA, _, _, minv = sharded._prepare_sparse_gather_local(
                    kernel, mesh, vals, cols, tr, tc, tv, xl, mm, HYPER["gamma"],
                    HYPER["coef0"], COST, HYPER["degree"], "jacobi")
        want_q = gram_block(kernel, Xd, xl[None, :], **HYPER)[:, 0] * m
        _close(q, want_q, 1e-12)
        assert float(QA) == pytest.approx(float(kernel_scalar(kernel, xl, xl, **HYPER)) + 0.5,
                                          rel=1e-12)
        from plssvm_sparse_fp22_tpu_torch.ops.matvec import jacobi_minv

        _close(minv, jacobi_minv(kernel, Xd, want_q, m, QA, torch.tensor(0.5, dtype=Xd.dtype),
                                 HYPER["degree"], HYPER["gamma"], HYPER["coef0"]), 1e-12)


def test_blobs_in_sparse_form_take_the_same_routes_as_the_jax_package(monkeypatch):
    """The route, by kernel and budget, is the JAX package's."""
    X, y = make_blobs(600, 24, seed=7)
    csr = sp.csr_matrix(X)
    for kernel, budget in [(KernelType.linear, None), (KernelType.rbf, None),
                           (KernelType.rbf, "1000")]:
        if budget is None:
            monkeypatch.delenv("PLSSVM_K_CACHE_BYTES", raising=False)
        else:
            monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", budget)
        ours = _train(csr, y, kernel, devices=8, max_iter=20, epsilon=1e-6)
        theirs = _train(csr, y, kernel, pkg=jp, parsed=JParsed, max_iter=20, epsilon=1e-6)
        assert ours.last_cg_info["mode"] == theirs.last_cg_info["mode"]
        assert ours.last_cg_info["padded"] == theirs.last_cg_info["padded"]
