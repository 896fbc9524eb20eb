"""The readers of the program's spans and counters (``utils.timing.TRACED``
of ``plssvm_sparse_fp22_tpu_torch``): each on a hand-filled store and on
an empty one, and each cell's traced and untraced runs on the CPU."""

import json
import sys

import pytest

pytest.importorskip("torch")

from lssvm_bench import run  # noqa: E402
from lssvm_bench.tests.conftest import REPO, run_cell  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils import timing  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
#: the readers of the program's store, by the cells that report them
NEW = {"densify_ms": ["rcv1-rbf.grid"],
       "h2d_mb_per_learn": ["ijcnn1-rbf.grid", "rcv1-rbf.grid"],
       "captures_per_learn": ["ijcnn1-rbf.grid"],
       "alloc_segments_per_learn": ["ijcnn1-rbf.grid", "rcv1-rbf.grid"],
       "predict_host_ms": ["ijcnn1-rbf.predict"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def reader(name):
    return run.reader(REPO / "lssvm_bench", name)


@pytest.fixture
def traced(monkeypatch):
    t = Timings()
    monkeypatch.setattr(timing, "TRACED", t)
    return t


def test_entries_name_these_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, cells in NEW.items():
        assert entries[name]["workloads"] == cells
        assert (REPO / "lssvm_bench" / "metrics" / f"{name}.py").exists()


def test_readers_of_a_filled_store(traced):
    for ms in (5000.0, 6000.0):  # two learns of the gram tier
        traced("learn", ms)
        traced("setup", ms - 10.0)
        traced("setup/densify", ms - 1000.0)
        traced("cg", 5.0)
    traced.count("h2d_bytes", 2 * 3_870_007_824)
    traced.count("cg_captures", 1)
    traced.count("alloc_segments", 6)
    for ms, kernel in ((15.0, 11.0), (17.0, 11.0)):
        traced("predict", ms)
        traced("predict/kernel", kernel)
        traced("predict/stage", 3.0)
    assert reader("densify_ms")({}) == pytest.approx(4500.0)
    assert reader("h2d_mb_per_learn")({}) == pytest.approx(3870.007824)
    assert reader("captures_per_learn")({}) == pytest.approx(0.5)
    assert reader("alloc_segments_per_learn")({}) == pytest.approx(3.0)
    assert reader("predict_host_ms")({}) == pytest.approx(5.0)


def test_learns_without_captures_or_densify(traced):
    traced("learn", 40.0)
    traced.count("h2d_bytes", 4_599_076)
    traced.count("alloc_segments", 0)
    assert reader("captures_per_learn")({}) == 0.0
    assert reader("alloc_segments_per_learn")({}) == 0.0
    assert reader("h2d_mb_per_learn")({}) == pytest.approx(4.599076)
    assert reader("densify_ms")({}) is None
    assert reader("predict_host_ms")({}) is None


def test_readers_of_an_empty_store(traced):
    for name in NEW:
        assert reader(name)({}) is None


def test_readers_without_the_program(monkeypatch):
    """A run whose process never loaded the program (the control)."""
    monkeypatch.delitem(sys.modules, "plssvm_sparse_fp22_tpu_torch.utils.timing")
    for name in NEW:
        assert reader(name)({}) is None


@pytest.mark.parametrize("trace", [1, 0])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_prints_its_new_metrics_traced_only(bench_copy, cell, trace):
    rc, res, err = run_cell(bench_copy, cell, trace=trace, seconds=2.0)
    assert rc == 0, err[-3000:]
    printed = set(res["metrics"]) & set(NEW)
    assert printed == ({n for n, cells in NEW.items() if cell in cells} if trace else set())
    for name in printed:
        assert res["metrics"][name]["value"] >= 0.0
