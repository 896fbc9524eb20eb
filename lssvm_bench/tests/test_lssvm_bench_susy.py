"""The four-card SUSY cell (``susy-rbf.final-4gpu``) on the CPU: its learns
take the row ring over four logical shards, as the cell's learns do over
four cards; the TF32 control and the faults planted in the ring or in the
stopping rule come out not correct; the readers of ``k2_roofline.train``
and ``ring_mb_per_learn`` count what they say.

The cell runs here at :data:`SMALL` rows (its published width), under
:data:`SMALL_LIMITS`, which lie between the readings of 30 seeds on the
ring: ``bias`` sound <= 4.2e-6, TF32 >= 2.4e-6 on one seed and >= 1.5e-5
on the others (limit 6e-6); ``claim`` sound <= 0.025, TF32 >= 5.5e-4, so
only the faults are held to it; ``resid`` sound <= 29, the exchange left
out >= 1470, CG cut to 3 steps >= 153 (limit 100); ``stop``: cut to 3
steps >= 224, eps x 1000 >= 319."""

import json

import pytest

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch.parallel.sharded as sharded  # noqa: E402
from lssvm_bench import roofline, run, trace  # noqa: E402
from lssvm_bench.tests.conftest import REPO  # noqa: E402
from lssvm_bench.tests.test_lssvm_bench_faults import drive, stop_rule  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils import timing  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings  # noqa: E402

CELL = "susy-rbf.final-4gpu"
#: rows and features of the configuration at the test size
SMALL = {"rows": 1024, "features": 18}
SMALL_LIMITS = {"resid": 100.0, "stop": 3.0, "claim": 1.0, "bias": 6e-6}


@pytest.fixture
def susy_copy(bench_copy):
    """``bench_copy`` with the SUSY configuration cut to :data:`SMALL` and
    the cell's limits :data:`SMALL_LIMITS`."""
    path = bench_copy / "lssvm_bench" / "configs" / "susy-rbf.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **SMALL)))
    (bench_copy / "lssvm_bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps(SMALL_LIMITS))
    return bench_copy


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    """Two threads a worker; K not kept (``PLSSVM_K_CACHE_BYTES``), so the
    learns take the row ring at any size, as on the cards; the ring's hops
    counted."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    hops = []
    orig = sharded._Ring.hops

    def counted(self):
        for hop in orig(self):
            hops.append(hop)
            yield hop
    monkeypatch.setattr(sharded._Ring, "hops", counted)
    yield hops
    torch.set_num_threads(before)


def test_sound_run_takes_the_ring_and_is_correct(monkeypatch, capsys, susy_copy, ring):
    res = drive(monkeypatch, capsys, susy_copy, CELL)
    assert res["correct"] is True and res["device"]["count"] == 4
    assert ring and len(ring) % 16 == 0  # p² hops per A·v over four shards


@pytest.mark.parametrize("seed", [3000000041, 3000000042, 3000000043])
def test_control_is_not_correct(monkeypatch, capsys, susy_copy, seed):
    res = drive(monkeypatch, capsys, susy_copy, CELL, "--control", "tf32", seed=seed)
    assert res["correct"] is False


def own_block(self, i, j):
    """The exchange left out: a hop reads its own shard's block in place of
    shard ``j``'s."""
    return self.blocks[i]


@pytest.mark.parametrize("fault", ["exchange left out", "cut3", "loose"])
def test_planted_fault_is_not_correct(monkeypatch, capsys, susy_copy, fault):
    if fault == "exchange left out":
        monkeypatch.setattr(sharded._Ring, "fetch", own_block)
    else:
        orig = run.program_factory
        monkeypatch.setattr(run, "program_factory", lambda args, cfg, ds, chips, dev: orig(
            args, stop_rule(fault, cfg, ds.features), ds, chips, dev))
    assert drive(monkeypatch, capsys, susy_copy, CELL)["correct"] is False


def reader(name):
    return run.reader(REPO / "lssvm_bench", name)


@pytest.fixture
def traced(monkeypatch):
    t = Timings()
    monkeypatch.setattr(timing, "TRACED", t)
    return t


MS = 1_000_000  # ns
FAST = "void (anonymous namespace)::gram_wgmma_rows_kernel<1>(x)"
ACC = "void (anonymous namespace)::gram_wgmma_rows_kernel<3>(x)"
REDUCE = "reduce_slab_kernel(x)"


def hops_on_a_card(dev, between):
    """Three hops on one card: two at bf16cast, one at bf16x3, each of two
    strips (a launch and its slab sum, 2 + 1 ms); ``between`` hops: nothing,
    an elementwise add, or a card-to-card copy that starts between a
    strip and its slab sum."""
    evs, t = [], 0
    for name in (FAST, FAST, ACC):
        for strip in range(2):
            evs.append((name, "cuda", dev, 0, t, t + 2 * MS))
            if between == "copy" and strip == 0:
                evs.append(("Memcpy PtoP (Device -> Device)", "cuda", dev, 0, t + MS,
                            t + 5 * MS))
            evs.append((REDUCE, "cuda", dev, 0, t + 2 * MS, t + 3 * MS))
            t += 3 * MS
        if between == "add":
            evs.append(("void at::native::elementwise_kernel", "cuda", dev, 0, t, t + MS))
            t += MS
    return evs, t


@pytest.mark.parametrize("between", ["nothing", "add", "copy"])
def test_k2_roofline_train_counts_one_hop_per_hop(traced, between):
    cards = [hops_on_a_card(dev, between) for dev in (0, 1)]
    end = max(t for _, t in cards) + MS
    evs = [(trace.WINDOW, "cpu", -1, 7, 0, end)] + [e for card, _ in cards for e in card]
    tr = trace.reduce_events(evs)
    traced.count("ring_hops", 6)
    rows, chips, f = 1025, 2, 18
    m = (rows - 1) / chips
    least = sum(n * roofline.least_seconds(*roofline.k2_call(m, m, f, tier), tier)
                for n, tier in ((4, "bf16cast"), (2, "bf16x3")))
    busy = 6 * 2 * 0.003  # six hops of two strips, each 2 + 1 ms
    got = reader("k2_roofline.train")({"trace": tr, "rows": rows, "chips": chips,
                                       "features": f})
    assert got == pytest.approx(100.0 * least / busy)


def test_k2_roofline_train_needs_the_trace_and_the_hops(traced):
    evs, t = hops_on_a_card(0, "nothing")
    tr = trace.reduce_events([(trace.WINDOW, "cpu", -1, 7, 0, t)] + evs)
    ctx = {"trace": tr, "rows": 1025, "chips": 1, "features": 18}
    assert reader("k2_roofline.train")(ctx) is None  # the program counted no hops
    traced.count("ring_hops", 3)
    assert reader("k2_roofline.train")(dict(ctx, trace=None)) is None


def test_ring_mb_per_learn(traced):
    assert reader("ring_mb_per_learn")({}) is None  # no learn profiled
    for _ in range(4):
        traced("learn", 900.0)
    assert reader("ring_mb_per_learn")({}) is None  # a program without the counter
    block = 131072 * 64 * 2 + 131072 * 4   # bf16cast operands padded to 64 features, norms
    traced.count("ring_bytes", 4 * 12 * 20 * block)  # 4 learns of 20 A·v, 12 copies each
    assert reader("ring_mb_per_learn")({}) == pytest.approx(12 * 20 * block / 1e6)


def test_the_cell_lists_its_metrics():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 4 and cell["traffic"] == "final"
    mine = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert mine == {"learn_setup_ms", "cg_ms_per_iter", "cg_iters", "device_idle.train",
                    "h2d_mb_per_learn", "alloc_segments_per_learn", "k2_roofline.train",
                    "ring_mb_per_learn"}
