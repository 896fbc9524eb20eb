"""The Gram kernels' scratch in strips, on the CPU: the strip planner of
``ops/gram_matvec.py`` and the plain twins of the kernels' strip schedules.

K1, K2 and K3 write per-tile-pair partial sums into a slab that a second
kernel sums; ``SCRATCH_BYTES`` bounds a launch's slab, and a call walks
strips of row blocks.  The CUDA side runs only on the card
(``chip_smoke.py`` phase 20, ``test_torch_cuda.py``); here:

- the planner keeps every strip's slab within the bound for D up to 2^21
  and takes one strip at every shape the smoke test runs (the kernels'
  results there are bitwise what they were with one slab);
- the plain schedules at D = 1000 (8 row blocks), under budgets that force
  1, 3 and 8 strips, equal the unstripped plain K1, K2 and K3 to 1e-6 of
  the result's scale, and the K1 schedule equals the JAX package's
  ``make_sym_matvec`` (interpret-mode Pallas at ``Precision.HIGHEST``) on
  the same seeded float64 inputs to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from jax import lax

from plssvm_sparse_fp22_tpu.ops.pallas_matvec import make_sym_matvec as jax_sym_matvec
from plssvm_sparse_fp22_tpu.types import KernelType as JKernel
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.types import KernelType

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
SLOT = gm.CUDA_TILE * 4
D, F, DY = 1000, 16, 700  # 8 row blocks of X, 6 of Y
#: K1 budgets (in slots) that give strips of 8, 3 and 1 row blocks over 8:
#: one strip takes nb² = 64; S = 3 takes at most 3 (16 - 3) = 39; S = 1 15
SYM_BUDGETS = {1: 64 * SLOT, 3: 40 * SLOT, 8: 20 * SLOT}
#: K2 (slab S x 6) and K3 (two of them) budgets for 1, 3 and 8 strips
RECT_BUDGETS = {1: 48 * SLOT, 3: 18 * SLOT, 8: 6 * SLOT}
PAIR_BUDGETS = {n: 2 * b for n, b in RECT_BUDGETS.items()}
#: every (rows, other rows) a kernel runs at in chip_smoke.py: K1 over the
#: smoke's phase 3 shapes, the dense main path and the sparse `dense` tier's
#: 16384 rows; K2 at the predicts, the 4-shard ring of 32768 rows and the
#: 768-row panel pairs; K3 at the panel tier's 4096-row and 512-row panels and
#: phase 5's ragged pair
SMOKE_SYM = [40, 96, 4096, 16384, 32768]
SMOKE_RECT = [(1, 32768), (4096, 32768), (3000, 1700), (8192, 8192), (16384, 16384),
              (768, 768), (4096, 16384)]
SMOKE_PAIR = [(4096, 4096), (3000, 1700), (512, 512)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _data(seed=5):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(D, F)))
    Y = torch.from_numpy(rng.normal(size=(DY, F)))
    return X, Y, torch.from_numpy(rng.normal(size=D)), torch.from_numpy(rng.normal(size=DY))


@pytest.mark.parametrize("D_", [2**k for k in range(10, 22)] + [1000, 131072 + 5, 524288,
                                                                 1_000_003])
def test_sym_planner_keeps_every_strip_within_the_bound(D_):
    nb = -(-D_ // gm.CUDA_TILE)
    S = gm.sym_strip_blocks(nb)
    slots = SLOT * gm.sym_strip_slots(nb, S)
    assert slots <= gm.SCRATCH_BYTES
    # every strip's slab, walked as the launch walks them
    worst = max((min(nb, i0 + S) - i0) * (i0 + min(nb, i0 + S)) for i0 in range(0, nb, S))
    assert worst == gm.sym_strip_slots(nb, S)
    # one strip exactly where the whole slab fits
    assert (S == nb) == (nb * nb * SLOT <= gm.SCRATCH_BYTES)


@pytest.mark.parametrize("D_", [2**k for k in (14, 17, 19, 21)])
def test_rect_and_pair_planners_keep_the_bound(D_):
    nb = -(-D_ // gm.CUDA_TILE)
    for nbi in (1, 32, nb):
        S2 = gm.rect_strip_blocks(nbi, nb)
        S3 = gm.rect_strip_blocks(nbi, nb, sides=2)
        assert S2 * nb * SLOT <= gm.SCRATCH_BYTES and S2 <= min(nbi, 65535)
        assert 2 * S3 * nb * SLOT <= gm.SCRATCH_BYTES and S3 <= min(nbi, 65535)


@pytest.mark.parametrize("rows", SMOKE_SYM)
def test_k1_takes_one_strip_at_every_smoke_shape(rows):
    nb = -(-rows // gm.CUDA_TILE)
    assert gm.sym_strip_blocks(nb) == nb


@pytest.mark.parametrize("rows,other", SMOKE_RECT + SMOKE_PAIR)
def test_k2_and_k3_take_one_strip_at_every_smoke_shape(rows, other):
    nbi, nbj = -(-rows // gm.CUDA_TILE), -(-other // gm.CUDA_TILE)
    assert gm.rect_strip_blocks(nbi, nbj) == nbi
    if (rows, other) in SMOKE_PAIR:
        assert gm.rect_strip_blocks(nbi, nbj, sides=2) == nbi


def test_the_budgets_force_the_strip_counts():
    for n, budget in SYM_BUDGETS.items():
        assert -(-8 // gm.sym_strip_blocks(8, budget)) == n
    for n, budget in RECT_BUDGETS.items():
        assert -(-8 // gm.rect_strip_blocks(8, 6, budget)) == n
        assert -(-8 // gm.rect_strip_blocks(8, 6, PAIR_BUDGETS[n], sides=2)) == n


def test_a_budget_below_one_block_row_raises():
    with pytest.raises(PLSSVMError, match="strip of one row block"):
        gm.sym_strip_blocks(8, 14 * SLOT)
    with pytest.raises(PLSSVMError, match="strip of one row block"):
        gm.rect_strip_blocks(8, 6, 5 * SLOT)


@pytest.mark.parametrize("strips", [1, 3, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k1_strip_schedule_equals_the_unstripped_plain_k1(kernel, strips):
    X, _, v, _ = _data()
    want = gm.gram_matvec_sym_plain(kernel, X, v, **HYPER)
    got = gm.gram_matvec_sym_strips_plain(kernel, X, v, scratch_bytes=SYM_BUDGETS[strips],
                                          **HYPER)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("strips", [1, 3, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k2_strip_schedule_equals_the_unstripped_plain_k2(kernel, strips):
    X, Y, _, w = _data()
    want = gm.gram_matvec_plain(kernel, X, w, Y=Y, **HYPER)
    got = gm.gram_matvec_strips_plain(kernel, X, w, Y=Y, scratch_bytes=RECT_BUDGETS[strips],
                                      **HYPER)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("strips", [1, 3, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k3_strip_schedule_equals_the_unstripped_plain_k3(kernel, strips):
    X, Y, v, w = _data()
    want_i, want_j = gm.pair_gram_contrib_plain(kernel, X, Y, v, w, same=False, **HYPER)
    got_i, got_j = gm.pair_gram_contrib_strips_plain(kernel, X, Y, v, w,
                                                     scratch_bytes=PAIR_BUDGETS[strips], **HYPER)
    assert _rel(got_i, want_i) <= 1e-6
    assert _rel(got_j, want_j) <= 1e-6


@pytest.mark.parametrize("strips", [1, 3, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_k1_strip_schedule_equals_the_jax_kernel_at_float64(kernel, strips):
    X, _, v, _ = _data(seed=9)
    want = np.asarray(jax_sym_matvec(JKernel(int(kernel)), jnp.asarray(X.numpy()),
                                     interpret=True, precision=lax.Precision.HIGHEST,
                                     **HYPER)(jnp.asarray(v.numpy())))
    got = gm.gram_matvec_sym_strips_plain(kernel, X, v, scratch_bytes=SYM_BUDGETS[strips],
                                          **HYPER)
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("tier", ["bf16x3", "bf16cast"])
def test_strip_schedule_at_the_bf16_tiers_equals_one_strip(tier):
    """The bf16 tiers' plain operands (float32 data) go through the same
    schedule: 8 strips against one."""
    X, Y, v, w = (t.float() for t in _data())
    for fn, args, budgets in (
            (gm.gram_matvec_sym_strips_plain, (X, v), SYM_BUDGETS),
            (lambda k, a, b, **kw: gm.gram_matvec_strips_plain(k, a, b, Y=Y, **kw), (X, w),
             RECT_BUDGETS)):
        one = fn(KernelType.rbf, *args, tier=tier, scratch_bytes=budgets[1], **HYPER)
        eight = fn(KernelType.rbf, *args, tier=tier, scratch_bytes=budgets[8], **HYPER)
        plain = gm.gram_matvec_plain(KernelType.rbf, X, args[1], Y=Y if args[1] is w else None,
                                     tier=tier, **HYPER)
        assert _rel(eight, one) <= 1e-6
        assert _rel(one, plain) <= 1e-5


def test_wrappers_take_the_budget_as_a_keyword_on_the_cpu():
    """On a CPU tensor the wrappers run their plain versions, which hold no
    slab, whatever the budget."""
    X, Y, v, w = _data()
    k = KernelType.rbf
    assert torch.equal(gm.make_sym_matvec(k, X, scratch_bytes=SYM_BUDGETS[8], **HYPER)(v),
                       gm.make_sym_matvec(k, X, **HYPER)(v))
    assert torch.equal(gm.gram_matvec(k, X, w, Y=Y, scratch_bytes=RECT_BUDGETS[8], **HYPER),
                       gm.gram_matvec(k, X, w, Y=Y, **HYPER))
    got = gm.pair_gram_contrib(k, X, Y, v, w, same=False, scratch_bytes=PAIR_BUDGETS[8], **HYPER)
    want = gm.pair_gram_contrib(k, X, Y, v, w, same=False, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
