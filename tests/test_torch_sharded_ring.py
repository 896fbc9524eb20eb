"""The row ring of the dense sharded learn (``parallel/sharded.py``) at the
width of LIBSVM's SUSY (f = 18), as ``make_csvm`` runs it with
``devices=4``: four logical shards here, four cards on the chip.

- The learn (mode ``sharded_implicit[4]``) agrees with the float64
  reference of the benchmark (``lssvm_bench/reference/lssvm.py``), at the
  backend's fixed tier and under the adaptive plan; a solve cut to 3 steps
  does not.
- Profiled, it records ``learn``, ``setup`` and ``cg``, one
  ``plssvm::ring/step`` range per ring step, ``ring_hops`` = p² per A·v,
  ``ring_bytes`` = 0 where every shard lies on one device, and
  ``h2d_bytes`` = the sharded set-up's copies; its alphas and bias are the
  bits of the unprofiled learn.
- On two cards or more (marker ``cuda``): ``ring_bytes`` = p (p - 1) block
  copies per A·v.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch as tp  # noqa: E402
import plssvm_sparse_fp22_tpu_torch.parallel.sharded as sharded  # noqa: E402
from lssvm_bench import trace  # noqa: E402
from lssvm_bench.data import dense_classes  # noqa: E402
from lssvm_bench.reference.lssvm import System, norm  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.models.base import CSVM  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils import timing  # noqa: E402
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings  # noqa: E402

CONFIG = Path(__file__).resolve().parents[1] / "lssvm_bench" / "configs" / "susy-rbf.json"
ROWS, SEED, P = 1024, 3000000061, 4
F32 = 4
#: The port against the float64 reference, both CG from x = 1 to the cap of
#: 18 steps (eps 1e-6 is not met first).  The port's float32 products (the
#: plain float32 tier, or bf16cast then bf16x3 under the plan) and its sums
#: over the ring's blocks leave its true residual up to ~30 times the
#: reference CG's and its x ~1 % from the reference's (5 seeds, both tiers);
#: CG cut to 3 steps reads 177-1600 times and 60-88 %.
RESID_TOL, X_TOL = 50.0, 0.05


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """K not kept, so the learn takes the ring at this size (on a card it
    does at any f <= 320); a fresh ``TRACED``."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION", raising=False)
    monkeypatch.setattr(timing, "TRACED", Timings())


@pytest.fixture(scope="module")
def data():
    cfg = dict(json.loads(CONFIG.read_text()), rows=ROWS)
    return dense_classes.make(cfg, SEED, "cpu")


def learn(data, devices=P, max_iter=None, **kw):
    p = tp.Parameter(kernel=tp.KernelType.rbf, gamma=1.0 / data.features, cost=1.0,
                     epsilon=1e-6, print_info=False, dtype=np.float32, devices=devices,
                     max_iter=max_iter, **kw)
    p.data = ParsedData(csr=data.csr, values=data.y, _dense=data.dense)
    p.values = data.y
    svm = tp.make_csvm(p)
    svm.learn()
    return svm


def against_reference(svm, data):
    """``(resid, dx)``: the port's true residual over the reference CG's,
    and its x's distance from the reference's, relative."""
    system = System(torch.as_tensor(data.dense), data.y, kernel="rbf",
                    gamma=1.0 / data.features)
    x = system.vector(svm.alphas[:-1])
    r0 = norm(system.residual(torch.ones_like(x), 1.0))
    x_ref = system.solve(1.0, 1e-6, data.features)[0]
    rho, rho_ref = (norm(system.residual(v, 1.0)) / r0 for v in (x, x_ref))
    return rho / max(rho_ref, 1e-6), norm(x - x_ref) / norm(x_ref)


@pytest.mark.parametrize("precision", ["fixed tier", "adaptive"])
def test_ring_learn_matches_the_float64_reference(data, precision, monkeypatch):
    if precision == "adaptive":
        monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    svm = learn(data)
    assert svm.last_cg_info["mode"] == f"sharded_implicit[{P}]"
    resid, dx = against_reference(svm, data)
    assert resid <= RESID_TOL and dx <= X_TOL


@pytest.mark.parametrize("precision", ["fixed tier", "adaptive"])
def test_a_solve_cut_to_three_steps_fails_the_comparison(data, precision, monkeypatch):
    if precision == "adaptive":
        monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    svm = learn(data, max_iter=3)
    assert svm.last_cg_info["iterations"] == 3
    resid, dx = against_reference(svm, data)
    assert resid > RESID_TOL and dx > X_TOL


def counted_matvecs(monkeypatch):
    """The ring operators' A·v calls, counted."""
    calls = []
    build = sharded._build_local_matvec

    def counting(*args, **kw):
        matvec = build(*args, **kw)

        def counted(v):
            calls.append(1)
            return matvec(v)
        return counted
    monkeypatch.setattr(sharded, "_build_local_matvec", counting)
    return calls


def profiled(fn):
    """``fn()`` under the harness's profiler: the ``plssvm::`` ranges, each
    with the number of times it was opened."""
    prof = trace.profiler()
    prof.start()
    try:
        with trace.window():
            fn()
    finally:
        prof.stop()
    names = [e[0][len("plssvm::"):] for e in trace._events(prof) if e[0].startswith("plssvm::")]
    return {name: names.count(name) for name in set(names)}


@pytest.mark.parametrize("precision", ["fixed tier", "adaptive"])
def test_profiled_ring_learn_counts_its_hops_and_steps(data, precision, monkeypatch):
    if precision == "adaptive":
        monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    plain = learn(data)
    calls = counted_matvecs(monkeypatch)
    svms = []
    ranges = profiled(lambda: svms.append(learn(data)))
    svm, traced = svms[0], timing.TRACED
    assert {"learn", "setup", "cg", "ring/step"} <= set(ranges)
    assert ranges["ring/step"] == P * len(calls)
    assert traced.counters["ring_hops"] == P * P * len(calls) > 0
    assert traced.counters.get("ring_bytes", 0) == 0  # one device: no block is copied
    assert len(traced.records["learn"]) == 1
    # the math is the unprofiled learn's
    assert svm.alphas.tobytes() == plain.alphas.tobytes() and svm.bias_ == plain.bias_


def test_h2d_bytes_count_the_sharded_setup(data):
    svms = []
    profiled(lambda: svms.append(learn(data)))
    D, f = svms[0].last_cg_info["padded"], data.features
    assert D % P == 0 and D >= ROWS - 1
    # the row blocks of the padded rows, b and mask whole, x_last
    assert timing.TRACED.counters["h2d_bytes"] == (D * f + 2 * D + f) * F32


def test_alloc_segments_sum_over_the_cards(monkeypatch):
    stats = {0: 3, 1: 5, 2: 0, 3: 7}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "segment.all.allocated": stats[torch.device(d).index]})
    cards = [torch.device("cuda", i) for i in range(4)]
    assert CSVM._allocated_segments(cards) == 15
    assert CSVM._allocated_segments(cards[1:2]) == 5
    assert CSVM._allocated_segments([]) == 0  # the CPU


@pytest.mark.cuda
def test_ring_bytes_are_the_block_copies_across_cards(data, monkeypatch):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two CUDA devices or more")
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "highest")  # one tier: X's float32 rows travel
    calls = counted_matvecs(monkeypatch)
    svms = []
    profiled(lambda: svms.append(learn(data, devices=cards, backend=tp.BackendType.cuda,
                                       target=tp.TargetPlatform.gpu_nvidia)))
    svm = svms[0]
    assert svm.last_cg_info["mode"] == f"sharded_implicit[{cards}]"
    m = svm.last_cg_info["padded"] // cards
    block = (m * data.features + m) * F32  # the rows and their norms
    assert timing.TRACED.counters["ring_hops"] == cards * cards * len(calls)
    assert timing.TRACED.counters["ring_bytes"] == cards * (cards - 1) * block * len(calls)
    assert against_reference(svm, data)[0] <= RESID_TOL
