"""Each metric reader on a synthetic run: spans of the program's
``Timings``, its counters, and a profiler event list reduced in memory."""

import statistics

import pytest

torch = pytest.importorskip("torch")

from lssvm_bench import roofline, run, trace  # noqa: E402
from lssvm_bench.tests.conftest import REPO  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings  # noqa: E402


def reader(name):
    """The harness's own lookup: ``metrics/<name>.py``, else its stem's."""
    return run.reader(REPO / "lssvm_bench", name)


def learn_info(setup_parts, cg, iterations, executed):
    t = Timings()
    for ms in setup_parts:  # the sparse gram tier times several set-up spans
        t("setup", ms)
    t("setup/h2d", 1.0)
    t("cg", cg)
    info = {"iterations": iterations, "executed": executed}
    info.update({k: sum(v) for k, v in t.records.items()})
    return info


MS = 1_000_000  # ns


def events():
    """A 10 ms window: K1 at bf16cast (2 ms + its 0.5 ms reduction), an
    elementwise kernel, K1 at bf16x3 (3 ms), a memcpy; the host in
    ``aten::copy_`` during the first gap and in ``cudaGraphLaunch`` later."""
    cpu = [(trace.WINDOW, "cpu", -1, 7, 0, 10 * MS),
           ("aten::copy_", "cpu", -1, 7, 0, 1 * MS),
           ("cudaGraphLaunch", "cpu", -1, 7, 6 * MS, 6 * MS + 100),
           ("other thread op", "cpu", -1, 8, 0, 10 * MS)]
    dev = [("void (anonymous namespace)::gram_wgmma_kernel<1, 0>(x)", "cuda", 0, 0,
            1 * MS, 3 * MS),
           ("reduce_sym_strip_kernel(x)", "cuda", 0, 0, 3 * MS, 3 * MS + MS // 2),
           ("void at::native::elementwise_kernel", "cuda", 0, 0, 4 * MS, 4 * MS + MS // 2),
           ("void (anonymous namespace)::gram_wgmma_kernel<3, 0>(x)", "cuda", 0, 0,
            5 * MS, 8 * MS),
           ("Memcpy DtoH (Device -> Pinned)", "cuda", 0, 0, 8 * MS, 8 * MS + MS // 2)]
    return cpu + dev


def ctx(**kw):
    base = {"config": {}, "traffic": {}, "chips": 1, "window_s": 2.0, "call_s": [],
            "setup_s": 12.5, "points_per_call": 0, "learns": [], "trace": None,
            "rows": 1001, "features": 22}
    base.update(kw)
    return base


def test_host_clock_readers():
    times = [0.01 * (1 + i % 7) for i in range(100)]
    c = ctx(call_s=times, window_s=sum(times), points_per_call=91701)
    assert reader("setup_s")(c) == 12.5
    assert reader("learn_s")(c) == pytest.approx(sum(times) / 100)
    assert reader("learn_p90_s")(c) == statistics.quantiles(times, n=10)[-1]
    assert reader("predict_rate")(c) == pytest.approx(91701 * 100 / sum(times))
    assert reader("learn_s")(ctx()) is None and reader("predict_rate")(ctx()) is None


def test_span_and_counter_readers():
    learns = [learn_info([3.0, 1.0], 20.0, 22, 22), learn_info([6.0], 10.0, 8, 9)]
    c = ctx(learns=learns)
    assert reader("learn_setup_ms")(c) == pytest.approx(5.0)
    assert reader("cg_ms_per_iter")(c) == pytest.approx(30.0 / 31)
    assert reader("cg_iters")(c) == pytest.approx(15.0)
    for name in ("learn_setup_ms", "cg_ms_per_iter", "cg_iters"):
        assert reader(name)(ctx(learns=[{"iterations": None}])) is None


def test_trace_reduction_and_its_readers():
    tr = trace.reduce_events(events())
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s[0] == pytest.approx(0.0065)
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.0035)
    assert tr.device_ops[0][0].startswith("gram_wgmma_kernel<3, 0>")
    c = ctx(trace=tr)
    assert reader("device_idle.train")(c) == pytest.approx(35.0)
    assert reader("device_idle.predict")(c) == pytest.approx(35.0)
    least = sum(roofline.least_seconds(*roofline.k1_call(1000, 22, t), t)
                for t in ("bf16cast", "bf16x3"))
    assert reader("k1_roofline")(c) == pytest.approx(100 * least / 0.0055)
    assert reader("k2_roofline.predict")(c) is None  # no K2 in this trace


def test_k2_readers_count_their_calls():
    """Two cards, each one K2 call at bf16cast (a strip and its slab sum)
    and one at bf16x3; one reader serves both ``device_idle`` names."""
    def card(t0):
        return [("void (anonymous namespace)::gram_wgmma_rows_kernel<1>(x)", "cuda", 0, 0,
                 t0, t0 + 2 * MS), ("reduce_slab_kernel(x)", "cuda", 0, 0, t0 + 2 * MS, t0 + 3 * MS),
                ("void at::native::elementwise_kernel", "cuda", 0, 0, t0 + 3 * MS, t0 + 4 * MS),
                ("void (anonymous namespace)::gram_wgmma_rows_kernel<3>(x)", "cuda", 0, 0,
                 t0 + 4 * MS, t0 + 8 * MS)]
    evs = [(trace.WINDOW, "cpu", -1, 7, 0, 10 * MS)] + card(MS)
    evs += [(n, d, 1, t, a, b) for n, d, _, t, a, b in card(MS)]
    tr = trace.reduce_events(evs)
    rows = 91701
    least = sum(roofline.least_seconds(*roofline.k2_call(rows, 1001, 22, t), t)
                for t in ("bf16cast", "bf16x3"))
    assert reader("k2_roofline.predict")(ctx(trace=tr, points_per_call=rows)) == pytest.approx(
        100 * 2 * least / (2 * 0.007))
    assert reader("device_idle.train")(ctx(trace=tr, chips=2)) == pytest.approx(20.0)
    assert reader("device_idle.predict")(ctx(trace=tr, chips=2)) == pytest.approx(20.0)


def test_readers_of_an_untraced_run_find_nothing():
    for name in ("k1_roofline", "k2_roofline.predict", "device_idle.train",
                 "device_idle.predict"):
        assert reader(name)(ctx()) is None
