"""The roofline yardstick: counts from the inputs' own sizes, the kernels
told apart by their trace names, calls grouped from a device's events."""

import pytest

from lssvm_bench import roofline


def test_k1_counts_distinct_entries_at_the_data_width():
    flops, nbytes = roofline.k1_call(1000, 22, "bf16cast")
    assert flops == 1000 * 1001 / 2 * 2 * 22
    assert nbytes == 1000 * 22 * 2 + 3 * 1000 * 4
    assert roofline.k1_call(1000, 22, "bf16x3")[0] == 3 * flops
    assert roofline.k1_call(1000, 22, "exact")[0] == flops
    assert roofline.k1_call(1000, 22, "exact")[1] == 1000 * 22 * 4 + 3 * 1000 * 4


def test_k2_counts_rows_times_columns():
    flops, nbytes = roofline.k2_call(300, 500, 18, "exact")
    assert flops == 300 * 500 * 2 * 18
    assert nbytes == (300 + 500) * 18 * 4 + (300 + 2 * 500) * 4 + 300 * 4
    assert roofline.k2_call(300, 500, 18, "bf16x3")[0] == 3 * flops


def test_least_time_is_the_larger_bound():
    flops, nbytes = roofline.k1_call(49989, 22, "bf16cast")
    t = roofline.least_seconds(flops, nbytes, "bf16cast")
    assert t == pytest.approx(flops / 989e12)
    assert roofline.least_seconds(1.0, 3.35e12, "exact") == pytest.approx(1.0)


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::gram_wgmma_kernel<1, 0>(CUtensorMap, TileArgs)",
     ("K1", "bf16cast")),
    ("void (anonymous namespace)::gram_wgmma_kernel<3, 0>(CUtensorMap)", ("K1", "bf16x3")),
    ("void (anonymous namespace)::gram_wgmma_kernel<3, 2>(CUtensorMap)", ("K2", "bf16x3")),
    ("void (anonymous namespace)::gram_wgmma_kernel<1, 1>(CUtensorMap)", ("K3", "bf16cast")),
    ("_ZN12_GLOBAL__N_117gram_wgmma_kernelILi3ELi0EEEv14CUtensorMap_st", ("K1", "bf16x3")),
    ("void (anonymous namespace)::gram_wgmma_rows_kernel<1>(CUtensorMap)", ("K2", "bf16cast")),
    ("(anonymous namespace)::gram_matvec_sym_kernel(float const*, int)", ("K1", "exact")),
    ("(anonymous namespace)::gram_matvec_rect_kernel(float const*)", ("K2", "exact")),
    ("reduce_sym_strip_kernel(float const*, int, int, int, float*)", ("K1", "reduce")),
    ("reduce_slab_kernel(float const*, int, int, bool, float*)", (None, "reduce")),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
])
def test_classify(name, want):
    assert roofline.classify(name) == want


def test_calls_group_strips_and_reductions():
    ev = [
        ("gram_wgmma_kernel<1, 0>", 0.0, 1.0), ("reduce_sym_strip_kernel", 1.0, 1.5),
        ("gram_wgmma_kernel<1, 0>", 1.5, 2.5), ("reduce_sym_strip_kernel", 2.5, 3.0),
        ("vectorized_elementwise_kernel", 3.0, 3.1),
        ("gram_wgmma_kernel<3, 0>", 4.0, 7.0), ("reduce_sym_strip_kernel", 7.0, 7.5),
        ("gram_matvec_rect_kernel", 8.0, 9.0), ("reduce_slab_kernel", 9.0, 9.25),
    ]
    assert list(roofline.calls(ev, "K1")) == [("bf16cast", 3.0), ("bf16x3", 3.5)]
    assert list(roofline.calls(ev, "K2")) == [("exact", 1.25)]


def test_share_over_calls():
    n, f = 1000, 22
    fast = roofline.least_seconds(*roofline.k1_call(n, f, "bf16cast"), "bf16cast")
    acc = roofline.least_seconds(*roofline.k1_call(n, f, "bf16x3"), "bf16x3")
    ev = {0: [("gram_wgmma_kernel<1, 0>", 0.0, 10 * fast), ("axpy", 1.0, 1.1),
              ("gram_wgmma_kernel<3, 0>", 2.0, 2.0 + 4 * acc)]}
    got = roofline.share(ev, "K1", lambda tier: roofline.k1_call(n, f, tier))
    assert got == pytest.approx(100.0 * (fast + acc) / (10 * fast + 4 * acc))
    assert roofline.share(ev, "K2", lambda tier: (1.0, 1.0)) is None
