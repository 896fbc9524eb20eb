"""The precision tiers (K4) on the CPU: the operand arms, the plain K1, K2
and K3 at the ``bf16x3`` and ``bf16cast`` tiers, and the tier plan, against
the JAX package.

- ``split_bf16`` and the bf16 cast are compared bit for bit with the JAX
  package's ``_split_bf16`` and ``astype`` on values with rounding ties,
  subnormals and signed zeros.
- The plain versions at a tier against the JAX package's Pallas kernels in
  interpret mode at ``lax.Precision.HIGH`` (bf16x3) and ``DEFAULT``
  (bf16cast), ``bm=32``: both multiply the same bf16 operands exactly and
  sum in f32, so they differ only in the order of the sums; tolerance
  ``1e-5 * max|want|``.
- Each tier against the float64 numpy oracle within its budget of
  ``tests/test_solver.py:133-137``: 1e-3 (bf16x3), 3e-2 (bf16cast).
- The bf16 operands' feature axis is padded with zeros to a multiple of 64
  (what the card's TMA loads need): the plain K1, K2 and K3 on padded
  operands against the same on unpadded ones, within 1e-6 of the scale (a
  zero feature adds exact zeros; only the blocking of the sums may move).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax import lax

from plssvm_sparse_fp22_tpu.ops import matvec as jmv
from plssvm_sparse_fp22_tpu.ops.pallas_matvec import (_resolve_decomp, _split_bf16,
                                                      gram_matvec_pallas, make_sym_matvec,
                                                      pair_gram_contrib)
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu.utils import oracle
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.ops import matvec as tmv
from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.05, "coef0": 1.0}
#: tier -> (the JAX package's precision, budget against the oracle)
TIERS = {"bf16x3": (lax.Precision.HIGH, 1e-3), "bf16cast": (lax.Precision.DEFAULT, 3e-2)}
TOL = 1e-5


def _bits_f32(words) -> np.ndarray:
    return np.asarray(words, np.uint32).view(np.float32)


def _tricky_values() -> np.ndarray:
    """float32 values whose conversions round: random normals; low halves at
    and around the bf16 rounding tie (0x8000) and ties of the split's
    remainder (0x0101, 0x0180); subnormals; signed zeros."""
    rng = np.random.default_rng(0)
    normals = rng.normal(scale=3.0, size=512).astype(np.float32)
    tops = rng.integers(0x0080, 0x7F00, size=64, dtype=np.uint32) << 16
    lows = np.array([0x8000, 0x7FFF, 0x8001, 0x0101, 0x0180, 0xFFFF, 0x0001, 0x4000],
                    np.uint32)
    ties = (tops[:, None] | lows[None, :]).ravel()
    ties = np.concatenate([ties, ties | 0x80000000])
    sub = np.array([0x00000001, 0x00008000, 0x00018000, 0x007FFFFF, 0x00400000, 0x80000001,
                    0x80008000, 0x00000000, 0x80000000], np.uint32)
    return np.concatenate([normals, _bits_f32(ties), _bits_f32(sub)]).astype(np.float32)


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_split_and_cast_equal_the_jax_package_bitwise():
    x = _tricky_values()
    hi, lo = gm.split_bf16(torch.from_numpy(x))
    jhi, jlo = _split_bf16(jnp.asarray(x))
    np.testing.assert_array_equal(_u16(hi), np.asarray(jhi).view(np.uint16))
    np.testing.assert_array_equal(_u16(lo), np.asarray(jlo).view(np.uint16))
    (cast,) = gm.tier_operands("bf16cast", torch.from_numpy(x))
    np.testing.assert_array_equal(_u16(cast), np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
                                  .view(np.uint16))
    # the split is exact: hi + lo is x wherever lo needs no rounding
    back = hi.double() + lo.double()
    assert np.max(np.abs(back.numpy() - x) / np.maximum(np.abs(x), 1e-30)) <= 2.0 ** -16


def test_tier_names_follow_the_jax_package(monkeypatch):
    for name in ("highest", "high", "default"):
        want = _resolve_decomp(jmv.tier_precision(name), jnp.float32)[0]
        assert tmv.tier_precision(name) == want
        assert _resolve_decomp(jmv.tier_precision(name), jnp.float64)[0] == "exact"
        assert gm.resolve_tier(tmv.tier_precision(name), torch.float64) == "exact"
    with pytest.raises(PLSSVMError, match="unknown precision tier"):
        gm.resolve_tier("tf32", torch.float32)
    # the fixed tier: highest unless the variable names another
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION", raising=False)
    assert gm.pallas_tier() == "exact"
    for name, tier in [("high", "bf16x3"), ("default", "bf16cast"), ("fastest", "bf16cast"),
                       ("HIGHEST", "exact"), ("adaptive", "exact")]:
        monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", name)
        assert gm.pallas_tier() == tier
    assert tmv.fixed_tier(BackendType.torch) == "exact"


def test_resolve_mxu_plan_contract(monkeypatch):
    """``tests/test_adaptive.py:223-235`` with the ``cuda`` backend in the
    TPU's place; on the ``torch`` backend the plan equals the JAX package's
    off the TPU."""
    f32, f64 = torch.float32, torch.float64
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    for backend in (BackendType.torch, BackendType.cuda):
        assert tmv.resolve_mxu_plan("implicit", f32, backend) == ("default", "high")
        assert tmv.resolve_mxu_plan("linear", f32, backend) == ("default", "high")
        assert tmv.resolve_mxu_plan("cached", f32, backend) is None
        assert tmv.resolve_mxu_plan("implicit", f64, backend) is None
    assert jmv.resolve_mxu_plan("implicit", np.float32) == ("default", "high")
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "high")
    assert tmv.resolve_mxu_plan("implicit", f32, BackendType.cuda) is None
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION")
    # default: adaptive on the card only, as on the TPU only; the linear
    # mode's bf16 tiers gain nothing on the card, so it runs the fixed tier
    assert tmv.resolve_mxu_plan("implicit", f32, BackendType.cuda) == ("default", "high")
    assert tmv.resolve_mxu_plan("linear", f32, BackendType.cuda) is None
    assert tmv.resolve_mxu_plan("cached", f32, BackendType.cuda) is None
    assert tmv.resolve_mxu_plan("implicit", f64, BackendType.cuda) is None
    assert tmv.resolve_mxu_plan("implicit", f32, BackendType.torch) is None
    assert jmv.resolve_mxu_plan("implicit", np.float32) is None


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, err


def _data(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(96, 33), (70, 64)])
def test_k1_plain_tier_matches_pallas_interpret(kernel, tier, shape):
    rng = np.random.default_rng(11)
    X, v = _data(rng, *shape), _data(rng, shape[0])
    prec, budget = TIERS[tier]
    want = np.asarray(make_sym_matvec(JKernel(int(kernel)), jnp.asarray(X), bm=32,
                                      interpret=True, precision=prec, **HYPER)(jnp.asarray(v)))
    got = gm.gram_matvec_sym_plain(kernel, torch.from_numpy(X), torch.from_numpy(v), tier=tier,
                                   **HYPER)
    assert got.dtype == torch.float32
    _close(got, want, TOL)
    _close(got, oracle.kernel_matrix(JKernel(int(kernel)), X, X, **HYPER) @ v.astype(np.float64),
           budget)
    # the wrapper on a CPU tensor runs the same plain version
    wrapped = gm.make_sym_matvec(kernel, torch.from_numpy(X), tier=tier, **HYPER)(
        torch.from_numpy(v))
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(1, 24, 70), (40, 64, 96), (1, 65, 33), (33, 7, 1),
                                   (70, 100, 45)])
def test_k2_plain_tier_matches_pallas_interpret(kernel, tier, shape):
    """Shapes are (points, features, support vectors): one point, one
    support vector, rows of both sides that end inside a 32-row block and
    features that end inside a padded box among them."""
    D, f, N = shape
    rng = np.random.default_rng(12)
    P, Y, a = _data(rng, D, f), _data(rng, N, f), _data(rng, N)
    prec, budget = TIERS[tier]
    want = np.asarray(gram_matvec_pallas(JKernel(int(kernel)), jnp.asarray(P), jnp.asarray(a),
                                         Y=jnp.asarray(Y), bm=32, bn=32, interpret=True,
                                         precision=prec, **HYPER))
    got = gm.gram_matvec(kernel, torch.from_numpy(P), torch.from_numpy(a),
                         Y=torch.from_numpy(Y), tier=tier, **HYPER)
    _close(got, want, TOL)
    _close(got, oracle.kernel_matrix(JKernel(int(kernel)), P, Y, **HYPER) @ a.astype(np.float64),
           budget)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [(96, 40, 33), (64, 64, 64)])
def test_k3_plain_tier_matches_pallas_interpret(kernel, tier, shape):
    """Cross panels (both directions) and, at a square shape, the diagonal
    panel (``same=True``, whose two outputs sum to ``K v``)."""
    Di, Dj, f = shape
    rng = np.random.default_rng(13)
    Xi, Xj, vi, vj = _data(rng, Di, f), _data(rng, Dj, f), _data(rng, Di), _data(rng, Dj)
    prec, budget = TIERS[tier]
    jk = JKernel(int(kernel))
    wi, wj = pair_gram_contrib(jk, jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(vi),
                               jnp.asarray(vj), same=False, bm=32, interpret=True,
                               precision=prec, **HYPER)
    oi, oj = gm.pair_gram_contrib(kernel, torch.from_numpy(Xi), torch.from_numpy(Xj),
                                  torch.from_numpy(vi), torch.from_numpy(vj), same=False,
                                  tier=tier, **HYPER)
    _close(oi, wi, TOL)
    _close(oj, wj, TOL)
    K = oracle.kernel_matrix(jk, Xi, Xj, **HYPER)
    _close(oi, K @ vj.astype(np.float64), budget)
    _close(oj, K.T @ vi.astype(np.float64), budget)
    if Di == Dj:
        wi, wj = pair_gram_contrib(jk, jnp.asarray(Xi), jnp.asarray(Xi), jnp.asarray(vi),
                                   jnp.asarray(vi), same=True, bm=32, interpret=True,
                                   precision=prec, **HYPER)
        oi, oj = gm.pair_gram_contrib(kernel, torch.from_numpy(Xi), torch.from_numpy(Xi),
                                      torch.from_numpy(vi), torch.from_numpy(vi), same=True,
                                      tier=tier, **HYPER)
        _close(oi + oj, np.asarray(wi) + np.asarray(wj), TOL)


@pytest.mark.parametrize("tier", list(TIERS))
def test_linear_operator_tier_within_budget(tier):
    """``linear`` mode at a tier: plain products of bf16-rounded or split
    operands with f32 sums, within the tier's budget of the exact operator
    (the JAX package's CPU products ignore the tier, so the oracle is the
    exact operator)."""
    rng = np.random.default_rng(14)
    D, dept, f = 64, 60, 24
    X = np.zeros((D, f), np.float32)
    X[:dept] = _data(rng, dept, f)
    mask = torch.from_numpy((np.arange(D) < dept).astype(np.float32))
    q = torch.from_numpy(X @ X[-5]) * mask
    v = torch.from_numpy(_data(rng, D)) * mask
    ops = {t: tmv.build_operator(KernelType.linear, torch.from_numpy(X), q, mask, 2.0, 0.5,
                                 mode="linear", precision=t) for t in ("exact", tier)}
    want = ops["exact"].matvec(v)
    got = ops[tier].matvec(v)
    _close(got, want, TIERS[tier][1])
    assert not got[dept:].any()
    assert not torch.equal(got, want)  # the tier really rounds


# --- padded operands ------------------------------------------------------------

#: padded against unpadded operands: every added term is an exact zero, so
#: only the matrix product's blocking of its f32 sums can differ
PAD_TOL = 1e-6


@pytest.mark.parametrize("f", [1001, 256, 8, 1])
@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_operands_pad_the_feature_axis_with_zeros(tier, f):
    X = torch.from_numpy(_data(np.random.default_rng(21), 9, f))
    raw = gm.tier_operands(tier, X, pad=False)
    padded = gm.tier_operands(tier, X)
    fp = -(-f // 64) * 64
    assert len(padded) == len(raw) == (2 if tier == "bf16x3" else 1)
    for part, want in zip(padded, raw):
        assert part.shape == (9, fp) and part.dtype == torch.bfloat16 and part.is_contiguous()
        assert torch.equal(part[:, :f], want)
        assert not part[:, f:].any()  # exact zeros (no -0.0 either: the bits are 0)
        assert not part[:, f:].view(torch.int16).any()
    if fp == f:  # nothing to pad: no copy is made
        assert all(a.shape == b.shape for a, b in zip(padded, raw))
    # the exact tier and vectors are left as they are
    assert gm.tier_operands("exact", X)[0] is X
    assert gm.tier_operands(tier, X[0])[0].shape == (f,)


@pytest.mark.parametrize("f", [1, 63, 64, 65, 1001])
def test_split_operands_come_padded_with_special_values(f):
    """``tier_operands("bf16x3", X)`` on the CPU: padded contiguous buffers,
    zero bits in the pad columns, and in the data columns the JAX package's
    bits for rounding ties, subnormals and signed zeros, and the plain
    version's for infinities and NaNs (``inf`` splits into ``inf + NaN``)."""
    vals = np.concatenate([_tricky_values(),
                           _bits_f32([0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
                                      0x00800001, 0x80810001, 0x01000001])])
    rows = -(-len(vals) // f)
    x = np.resize(vals, (rows, f)).astype(np.float32)
    X = torch.from_numpy(x)
    hi, lo = gm.tier_operands("bf16x3", X)
    fp = -(-f // 64) * 64
    phi, plo = gm.split_bf16_plain(X)
    jhi, jlo = _split_bf16(jnp.asarray(x))
    finite = np.isfinite(x)
    for part, plain, jpart in ((hi, phi, jhi), (lo, plo, jlo)):
        assert part.shape == (rows, fp) and part.dtype == torch.bfloat16 and part.is_contiguous()
        assert not part[:, f:].view(torch.int16).any()
        np.testing.assert_array_equal(_u16(part[:, :f].contiguous()), _u16(plain))
        np.testing.assert_array_equal(_u16(plain)[finite],
                                      np.asarray(jpart).view(np.uint16)[finite])
        assert gm._pad_features(part) is part  # a caller that pads again copies nothing
    where = torch.from_numpy(x == np.inf)
    assert torch.isinf(hi[:, :f][where]).all() and torch.isnan(lo[:, :f][where]).all()
    assert gm.split_bf16(X)[0].shape == (rows, f)  # unpadded unless asked
    assert gm.launches["split_bf16"] == 0  # the kernel is the card's


@pytest.mark.parametrize("f", [1001, 256])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("which", ["k1", "k2", "k3"])
def test_plain_versions_on_padded_operands_equal_unpadded(which, tier, f):
    rng = np.random.default_rng(22)
    Xi, Xj = torch.from_numpy(_data(rng, 70, f)), torch.from_numpy(_data(rng, 45, f))
    vi, vj = torch.from_numpy(_data(rng, 70)), torch.from_numpy(_data(rng, 45))
    hyper = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
    for kernel in KERNELS:
        outs = []
        for pad in (True, False):
            Xio, Xjo = gm.tier_operands(tier, Xi, pad=pad), gm.tier_operands(tier, Xj, pad=pad)
            if which == "k1":
                out = gm.gram_matvec_sym_plain(kernel, Xi, vi, tier=tier, operands=Xio, **hyper)
            elif which == "k2":
                out = gm.gram_matvec_plain(kernel, Xi, vj, Y=Xj, tier=tier, operands=(Xio, Xjo),
                                           **hyper)
            else:
                out = torch.cat(gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, same=False,
                                                           tier=tier, operands=(Xio, Xjo),
                                                           **hyper))
            outs.append(out)
        _close(outs[0], outs[1], PAD_TOL)


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("tier", ["exact", *TIERS])
def test_pair_gram_contrib_with_operands_equals_the_call_without(tier, same):
    """``operands=`` hands over what the call would prepare itself: the same
    bits, so the same result, from the wrapper and from the plain version."""
    rng = np.random.default_rng(23)
    f = 100
    Xi = torch.from_numpy(_data(rng, 50, f))
    Xj = Xi if same else torch.from_numpy(_data(rng, 30, f))
    vi = torch.from_numpy(_data(rng, 50))
    vj = vi if same else torch.from_numpy(_data(rng, 30))
    kw = {"same": same, "tier": tier, **HYPER}
    Xio = gm.tier_operands(tier, Xi)
    Xjo = Xio if same else gm.tier_operands(tier, Xj)
    for fn in (gm.pair_gram_contrib, gm.pair_gram_contrib_plain):
        gm.reset_preparations()
        with_ops = fn(KernelType.rbf, Xi, Xj, vi, vj, operands=(Xio, Xjo), **kw)
        assert not any(gm.preparations.values())  # nothing is prepared again
        without = fn(KernelType.rbf, Xi, Xj, vi, vj, **kw)
        assert gm.preparations[tier] == (1 if same else 2)
        for a, b in zip(with_ops, without):
            assert torch.equal(a, b)
