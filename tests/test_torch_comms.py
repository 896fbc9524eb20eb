"""``scripts/comms_check.py`` of the port on the CPU: two gloo ranks of two
logical shards each run every learn that crosses processes, and the bytes
``parallel/distributed.py`` counted per CG iteration equal a count worked
by hand from the shard shapes.

Per A·v a rank receives (W = 2 ranks, p = 4 shards, m = D / p rows a
shard, float32):

- the rows of K v of the other rank's two shards (``sharded._gather``,
  one all-gather): 2 m floats, on every row-sharded mode;
- ``linear`` and the sparse linear ring: the other rank's two partial
  ``X^T v`` (f floats each, ``sharded._reduce``);
- the feature-sharded learns: the other rank's two partials of ``K v``
  (D floats each, linear) or of the Gram rows (D x D each, rbf);
- the rings: each remote block once for each of its local shards that
  reads it (``_Exchange``, point to point): 4 of the 6 hops of a rank's two
  shards cross ranks.  A dense block is the shard's rows and row norms; a
  panel-ring block its tiled values and columns, heavy rows and norms; a
  gather-ring block its ELL slab, COO tail and norms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.ops.sparse import HybridSparse, TiledHybrid
from plssvm_sparse_fp22_tpu_torch.parallel import distributed
from plssvm_sparse_fp22_tpu_torch.parallel.sharded import _feature_block_rows
from plssvm_sparse_fp22_tpu_torch.scripts import comms_check

D, F, DENSITY = 512, 64, 0.05
W, SHARDS = 2, 2
P = W * SHARDS
M = D // P


@pytest.fixture(scope="module")
def check():
    return comms_check.main(["--cpu", "--rows", str(D), "--features", str(F),
                             "--density", str(DENSITY)])


def _remote_blocks(rank: int = 0) -> int:
    """Ring hops of ``rank``'s shards whose block lies on the other rank."""
    owner = [i // SHARDS for i in range(P)]
    return sum(owner[(i - s) % P] != rank
               for i in range(P) if owner[i] == rank for s in range(1, P))


def _packings():
    _, csr, _ = comms_check.problem(D, F, DENSITY)
    h = HybridSparse.from_csr(csr, dtype=np.float32, pad_rows=D)
    th = TiledHybrid.from_csr(csr, dtype=np.float32, pad_rows=D)
    tail = np.bincount(h.coo_rows.numpy() // M, minlength=P).max() if h.coo_rows.numel() else 0
    heavy = np.bincount(np.asarray(th.heavy_idx) // M, minlength=P).max() \
        if len(th.heavy_idx) else 0
    return h, th, int(tail), int(heavy)


def _by_hand() -> dict:
    h, th, tail, heavy = _packings()
    rows = 4 * SHARDS * M  # the other rank's rows of K v
    S, L, fp = th.tell.ntiles * th.tell.Lt, h.ell.row_capacity, th.tell.padded_features
    hops = _remote_blocks()
    assert hops == 4
    feature_blocks = -(-D // _feature_block_rows(D, 4))
    return {
        "sharded_linear": 4 * SHARDS * F + rows,
        "sharded_cached": rows,
        "sharded_implicit_ring": hops * 4 * (M * F + M) + rows,
        "sharded_feature_linear": 4 * SHARDS * D,
        "sharded_feature_rbf": feature_blocks * 4 * SHARDS * (D // feature_blocks) * D,
        "sharded_sparse_linear": 4 * SHARDS * F + rows,
        "sharded_sparse_panel_ring": hops * (4 * M * S + 4 * M * S + 4 * heavy * fp + 4 * M)
        + rows,
        "sharded_sparse_gather_ring": hops * (8 * M * L + 12 * tail + 4 * M) + rows,
    }


@pytest.mark.parametrize("mode", sorted(comms_check.JAX_RATIOS))
def test_counted_bytes_equal_the_hand_count(check, mode):
    case = check["cases"][mode]
    counted = case["counted_per_iter"]
    assert case["measured_per_iter"] == _by_hand()[mode]
    # what a rank receives it also sends: the modes are symmetric
    assert counted["all_gather/sent"] == counted["all_gather/received"]
    assert counted["post/sent"] == counted["post/received"]
    # only the rings post point to point
    assert (counted["post/received"] > 0) == mode.endswith("_ring")


def test_the_packings_have_heavy_rows_and_a_tail(check):
    """The sparse blocks' optional parts travel too: the problem has heavy
    rows for the panel ring and a COO tail for the gather ring."""
    _, _, tail, heavy = _packings()
    assert tail > 0 and heavy > 0
    assert check["heavy_rows"] > 0 and check["coo_tail"] > 0


def test_model_and_ratios(check):
    assert check["transport"] == "gloo" and check["ranks"] == W
    assert check["shards_per_rank"] == SHARDS and (check["D"], check["f"]) == (D, F)
    for name, case in check["cases"].items():
        formula, value = comms_check.model(name, W, D, F, check["S"], check["L"])
        assert case["predicted"] == {"per_iter_bytes_formula": formula, "value": value}
        assert case["ratio_measured_over_predicted"] == case["measured_per_iter"] / value
        assert case["jax_ratio"] == comms_check.JAX_RATIOS[name]
    assert check["agreement_within_2x"] == all(
        0.5 <= c["ratio_measured_over_predicted"] <= 2.0 for c in check["cases"].values())


def test_the_feature_sharded_rbf_model_is_exact_at_two_ranks(check):
    """8 D² is the psum payload of the whole Gram per iteration; the port's
    all-gather of two ranks moves exactly that."""
    assert check["cases"]["sharded_feature_rbf"]["ratio_measured_over_predicted"] == 1.0


def test_reset_traffic_zeroes_every_counter():
    distributed.traffic["post/sent"] += 5
    distributed.reset_traffic()
    assert set(distributed.traffic.values()) == {0}
    assert set(distributed.traffic) == {"all_gather/sent", "all_gather/received", "post/sent",
                                        "post/received"}
