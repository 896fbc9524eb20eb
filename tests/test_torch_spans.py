"""The port's spans and counters on the profiler's clock (``utils/timing.py``).

- Off (no sink, no profiler) a learn and a predict synchronise nothing,
  open no profiler range and record nothing; :func:`timing.count` is one
  attribute read.
- Under ``torch.profiler`` every span is a ``plssvm::<label>`` range and
  adds up in ``timing.TRACED``: the root spans ``learn`` and ``predict``,
  the gram tier's ``setup`` parts, the predict's parts, and the counters
  ``h2d_bytes``, ``densify_on_device``, ``gram_from_rows``,
  ``gram_heavy_cols``, ``gram_light_pairs``, ``q_on_device``,
  ``cg_captures`` and ``alloc_segments``.
- A sink without a profiler gets what it got before: the disjoint
  ``setup`` / ``cg`` spans, no root span; the gram tier's parts add up to
  no more than its ``setup``.
- The sharded learns take ``setup`` and ``cg`` spans too.
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch as tp
from lssvm_bench import trace
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg
from plssvm_sparse_fp22_tpu_torch.utils import timing
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

from utils import make_blobs

GRAM_PARTS = {"densify", "h2d", "gram", "q"}
PREDICT_PARTS = {"stage", "kernel", "d2h"}
F32 = 4


@pytest.fixture(autouse=True)
def _fresh():
    """A fresh ``TRACED`` and no kept layouts around each test."""
    tcg.clear_graphs()
    old = timing.TRACED
    timing.TRACED = Timings()
    yield
    timing.TRACED = old
    tcg.clear_graphs()


def _svm(X, y, **kw):
    kw.setdefault("kernel", tp.KernelType.rbf)
    kw.setdefault("devices", 1)
    kw.setdefault("dtype", np.float32)
    p = tp.Parameter(gamma=0.1, cost=1.0, epsilon=1e-6, max_iter=50, print_info=False, **kw)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    return tp.make_csvm(p)


def _dense(n=300, f=12):
    return make_blobs(n, f, seed=3)


def _sparse(n=200, f=400):
    X = sp.random(n, f, density=0.05, random_state=1, format="csr").toarray()
    y = np.where(np.arange(n) % 3 == 0, 1.0, -1.0)
    return X, y


def _labels(t: Timings) -> set:
    return set(t.records) | {f"{span}/{part}" for span, parts in t.parts.items()
                             for part in parts}


def _profiled(fn):
    """``fn()`` under the harness's profiler: the ``plssvm::`` ranges it saw."""
    prof = trace.profiler()
    prof.start()
    try:
        with trace.window():
            fn()
    finally:
        prof.stop()
    return {e[0][len("plssvm::"):] for e in trace._events(prof) if e[0].startswith("plssvm::")}


@pytest.fixture
def watched(monkeypatch):
    """Calls of the spans' synchronisation and of the profiler's ranges."""
    calls = {"sync": 0, "range": 0}

    def sync(device):
        calls["sync"] += 1

    def record_function(name, *args):
        calls["range"] += 1
        return contextlib.nullcontext()

    monkeypatch.setattr(timing, "_synchronize", sync)
    monkeypatch.setattr(timing.torch.profiler, "record_function", record_function)
    monkeypatch.setattr(timing.torch._C._profiler, "_RecordFunctionFast", record_function)
    return calls


@pytest.mark.parametrize("data", ["dense", "sparse gram"])
def test_off_learn_and_predict_sync_nothing_and_record_nothing(data, watched):
    X, y = _dense() if data == "dense" else _sparse()
    svm = _svm(X, y)
    svm.learn()
    svm.predict(X[:20])
    assert watched == {"sync": 0, "range": 0}
    assert not timing.TRACED.records and not timing.TRACED.parts
    assert not timing.TRACED.counters
    # the same learn with a sink synchronises around each span, as before
    svm.timings = Timings()
    svm.learn()
    assert watched["sync"] > 0 and watched["range"] == 0
    assert not timing.TRACED.records


def test_count_is_one_attribute_read(monkeypatch):
    reads = []

    class Flag:
        def __getattribute__(self, name):
            reads.append(name)
            return False

    monkeypatch.setattr(timing, "_profiler", Flag())
    reads.clear()
    timing.count("h2d_bytes", 4096)
    assert reads == ["_is_profiler_enabled"]
    assert timing.TRACED.counters == {}
    assert isinstance(timing.span(None, "learn"), contextlib.nullcontext)
    assert len(reads) == 2


def test_count_adds_up_while_a_profiler_records():
    timing.count("cg_captures")
    prof = trace.profiler()
    prof.start()
    timing.count("cg_captures")
    timing.count("h2d_bytes", 10)
    timing.count("h2d_bytes", 6)
    prof.stop()
    timing.count("cg_captures")
    assert timing.TRACED.counters == {"cg_captures": 1, "h2d_bytes": 16}


def test_profiled_calls_are_ranges_and_add_up_in_traced():
    Xd, yd = _dense()
    Xs, ys = _sparse()
    dense, gram = _svm(Xd, yd), _svm(Xs, ys)

    def calls():
        dense.learn()
        dense.predict(Xd[:50])
        gram.learn()
        gram.predict(Xs[:20])

    ranges = _profiled(calls)
    assert gram.last_cg_info["mode"] == "sparse_gram"
    want = ({"learn", "predict", "setup", "cg"} | {f"setup/{p}" for p in GRAM_PARTS}
            | {f"predict/{p}" for p in PREDICT_PARTS})
    assert want <= ranges
    traced = timing.TRACED
    # the same labels; the cg span's capture part is a range only where a
    # capture runs (on a card)
    assert ranges <= _labels(traced) and _labels(traced) - ranges <= {"cg/capture"}
    assert len(traced.records["learn"]) == 2 and len(traced.records["predict"]) == 2
    for part in PREDICT_PARTS:
        assert len(traced.parts["predict"][part]) == 2
    assert sum(traced.part_summary("predict").values()) <= traced.summary()["predict"]
    assert traced.summary()["setup"] + traced.summary()["cg"] <= traced.summary()["learn"]
    assert traced.counters["alloc_segments"] == 0  # no cudaMalloc on the CPU
    assert "cg_captures" not in traced.counters     # nor a chunk graph


def test_ranges_are_host_operations_not_annotations():
    """The profiler mirrors a ``user_annotation`` onto the device's timeline
    (where it would count as device work); a span's range is a host op."""
    X, y = _dense()
    svm = _svm(X, y)
    prof = trace.profiler()
    prof.start()
    svm.learn()
    prof.stop()
    kinds = {str(e.activity_type()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("plssvm::")}
    assert kinds == {"cpu_op"}


def test_a_sink_without_a_profiler_gets_what_it_got_before():
    X, y = _dense()
    svm = _svm(X, y)
    svm.timings = Timings()
    svm.learn()
    assert set(svm.timings.records) == {"setup", "cg"}
    svm.predict(X[:10])
    assert set(svm.timings.records) == {"setup", "cg"} and "predict" not in svm.timings.parts
    assert not timing.TRACED.records and not timing.TRACED.counters


@pytest.mark.parametrize("arm", ["device product", "host SpGEMM"])
def test_gram_tier_parts_add_up_to_no_more_than_its_setup(arm, monkeypatch):
    if arm == "host SpGEMM":
        monkeypatch.setattr("plssvm_sparse_fp22_tpu_torch.ops.sparse.device_gram_max_features",
                            lambda: 0)
    X, y = _sparse()
    svm = _svm(X, y)
    svm.timings = Timings()
    svm.learn()
    t = svm.timings
    assert svm.last_cg_info["mode"] == "sparse_gram"
    assert set(t.records) == {"setup", "cg"}
    parts = t.part_summary("setup")
    want = GRAM_PARTS if arm == "device product" else GRAM_PARTS - {"densify"}
    assert set(parts) == want
    assert all(ms >= 0.0 for ms in parts.values())
    assert sum(parts.values()) <= t.summary()["setup"]


@pytest.mark.parametrize("case", ["dense", "sparse gram", "sparse gram, host SpGEMM"])
def test_h2d_bytes_count_the_arrays_copied(case, monkeypatch):
    if case.endswith("SpGEMM"):
        monkeypatch.setattr("plssvm_sparse_fp22_tpu_torch.ops.sparse.device_gram_max_features",
                            lambda: 0)
    X, y = _dense() if case == "dense" else _sparse()
    n, f = X.shape
    svm = _svm(X, y)
    _profiled(svm.learn)
    dept, D = n - 1, svm.last_cg_info["padded"]
    if case == "dense":
        want = (dept * f + dept + f) * F32      # rows, b, x_last
    elif case == "sparse gram":
        # the Gram from the rows copies what the dense scatter copied
        assert timing.TRACED.counters["gram_from_rows"] == 1
        nnz = int(sp.csr_matrix(X).indptr[dept])  # the staged rows: counts, columns, values
        want = dept * 8 + nnz * (8 + F32) + (2 * D + f) * F32  # ..., b and mask, x_last
    else:
        want = (2 * D + f + D * D + D + D) * F32  # ..., padded Gram and its diagonal, q
    assert timing.TRACED.counters["h2d_bytes"] == want
    # a first dense predict: the alphas, the points and the support vectors
    timing.TRACED.clear()
    if case == "dense":
        _profiled(lambda: svm.predict(X[:40]))
        assert timing.TRACED.counters["h2d_bytes"] == (n + 40 * f + n * f) * F32


def _repeated(csr):
    """``csr`` with every stored value as two entries of one column, which
    ``toarray()`` adds back up: not in canonical form."""
    halves = csr.data * 0.5
    return sp.csr_matrix((np.repeat(halves, 2), np.repeat(csr.indices, 2), 2 * csr.indptr),
                         shape=csr.shape)


@pytest.mark.parametrize("form", ["canonical", "repeated entries"])
def test_densify_on_device_counts_the_gram_learns_that_scatter(form):
    X, y = _sparse()
    svm = _svm(X, y)
    if form == "repeated entries":
        svm.data.csr = _repeated(svm.data.csr)
        assert not svm.data.csr.has_canonical_format
    _profiled(svm.learn)
    _profiled(svm.learn)
    assert svm.last_cg_info["mode"] == "sparse_gram"
    assert len(timing.TRACED.records["learn"]) == 2
    assert len(timing.TRACED.parts["setup"]["densify"]) >= 2
    assert timing.TRACED.counters.get("densify_on_device", 0) == (2 if form == "canonical" else 0)


def test_gram_from_rows_counters_on_a_small_csr():
    """Each float32 gram-tier learn counts ``gram_from_rows`` once, the
    split's heavy columns under ``gram_heavy_cols`` and its light pairs
    under ``gram_light_pairs``: the staged rows' column counts split at
    :func:`~plssvm_sparse_fp22_tpu_torch.ops.sparse_gram.split_threshold`."""
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg
    from utils import zipf_csr

    X = zipf_csr(300, 2000, nnz_per_row=20, seed=2).toarray()
    y = np.where(np.arange(300) % 3 == 0, 1.0, -1.0)
    svm = _svm(X, y)
    _profiled(svm.learn)
    _profiled(svm.learn)
    assert svm.last_cg_info["mode"] == "sparse_gram"
    counts = np.bincount(sp.csr_matrix(X)[:-1].indices, minlength=X.shape[1]).astype(np.int64)
    T = sg.split_threshold(svm.last_cg_info["padded"])
    h, P = int((counts >= T).sum()), int((counts[counts < T] ** 2).sum())
    assert 0 < h < X.shape[1] and P > 0
    counters = timing.TRACED.counters
    assert counters["gram_from_rows"] == 2 and counters["densify_on_device"] == 2
    assert counters["gram_heavy_cols"] == 2 * h and counters["gram_light_pairs"] == 2 * P


@pytest.mark.parametrize("arm", ["rows", "Xd product", "host SpGEMM"])
def test_q_on_device_counts_the_gram_learns_whose_q_the_device_made(arm, monkeypatch):
    """``q_on_device`` counts one a gram-tier learn whose products with the
    last point ran on the device: the float32 rows path and the float64
    ``Xd @ Xd.T`` arm; none where the Gram and ``q`` come from the host's
    sparse products (``PLSSVM_DEVICE_GRAM_MAX_FEATURES=1``)."""
    if arm == "host SpGEMM":
        monkeypatch.setenv("PLSSVM_DEVICE_GRAM_MAX_FEATURES", "1")
    X, y = _sparse()
    svm = _svm(X, y, dtype=np.float64 if arm == "Xd product" else np.float32)
    _profiled(svm.learn)
    _profiled(svm.learn)
    assert svm.last_cg_info["mode"] == "sparse_gram"
    counters = timing.TRACED.counters
    assert len(timing.TRACED.records["learn"]) == 2
    assert counters.get("q_on_device", 0) == (0 if arm == "host SpGEMM" else 2)
    assert counters.get("gram_from_rows", 0) == (2 if arm == "rows" else 0)
    assert len(timing.TRACED.parts["setup"]["q"]) >= 2


def test_gram_tier_densify_and_gram_ranges_fall_within_setup():
    """Under the profiler every ``setup/densify``, ``setup/h2d`` and
    ``setup/gram`` range of a gram-tier learn lies inside a ``setup``
    range."""
    X, y = _sparse()
    svm = _svm(X, y)
    prof = trace.profiler()
    prof.start()
    try:
        svm.learn()
    finally:
        prof.stop()
    ranges = [(e[0][len("plssvm::"):], e[4], e[5]) for e in trace._events(prof)
              if e[0].startswith("plssvm::")]
    setups = [(a, b) for name, a, b in ranges if name == "setup"]
    parts = [(name, a, b) for name, a, b in ranges
             if name in ("setup/densify", "setup/h2d", "setup/gram")]
    assert {name for name, _, _ in parts} == {"setup/densify", "setup/h2d", "setup/gram"}
    for name, a, b in parts:
        assert any(s0 <= a and b <= s1 for s0, s1 in setups), name


class _StubGraph:
    """What :meth:`solver.cg._ChunkGraph.capture` calls on its graph, with
    nothing captured (the CPU has no CUDA graphs)."""

    def __init__(self):
        self.steps = {}

    _timed = _side_stream = staticmethod(contextlib.nullcontext)

    def _capture_step(self, matvec, dot, refresh):
        return None, {}

    def _build_chunk(self):
        pass


def test_cg_captures_follow_the_solvers_count():
    stub = _StubGraph()
    before = tcg.counts["captures"]
    tcg._ChunkGraph.capture(stub, None, None)  # not profiled: counted by the solver alone
    assert tcg.counts["captures"] == before + 1 and not timing.TRACED.counters

    def twice():
        tcg._ChunkGraph.capture(stub, None, None)
        tcg._ChunkGraph.capture(stub, None, None)

    _profiled(twice)
    assert tcg.counts["captures"] == before + 3
    assert timing.TRACED.counters == {"cg_captures": 2}


def test_capture_is_a_profiler_range(monkeypatch):
    monkeypatch.setattr(tcg.torch.cuda, "synchronize", lambda dev=None: None)
    stub = type("Stub", (), {})()
    stub.carry = type("Carry", (), {"b": torch.zeros(2)})()

    def captured():
        with tcg._ChunkGraph._timed(stub):
            torch.ones(4).sum()

    before = tcg.spent["capture_ms"]
    assert "cg/capture" in _profiled(captured)
    assert tcg.spent["capture_ms"] > before
    assert "capture" not in timing.TRACED.parts.get("cg", {})  # the learn's cg span records it


@pytest.mark.parametrize("axis", ["rows", "features"])
def test_sharded_learns_take_setup_and_cg_spans(axis, monkeypatch):
    monkeypatch.setenv("PLSSVM_SHARD_AXIS", axis)
    X, y = make_blobs(600, 8, seed=5)
    svm = _svm(X, y, devices=2)
    svm.timings = Timings()
    svm.learn()
    mode = svm.last_cg_info["mode"]
    assert mode.startswith("sharded_feature" if axis == "features" else "sharded_") and \
        mode.endswith("[2]")
    t = svm.timings
    assert set(t.records) == {"setup", "cg"}
    assert len(t.records["cg"]) == 1 and t.summary()["cg"] > 0.0
    assert svm.last_cg_loop["executed"] > 0  # cg_ms_per_iter's denominator
    # profiled, the same spans under the root span
    svm.timings = None
    ranges = _profiled(svm.learn)
    assert {"learn", "setup", "cg"} <= ranges
    assert timing.TRACED.summary()["cg"] <= timing.TRACED.summary()["learn"]
