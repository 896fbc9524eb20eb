"""CG's loop state on the device (``solver/cg.py``), on the CPU.

The port's loop keeps ``k``, ``delta``, the stagnation counters and an
``active`` flag on the device, masks every update with ``active``, and on
the card replays chunk graphs of up to ``c`` slots (a WHILE node), each an
iteration behind IF nodes that the device sets from ``active`` and ``k``
(the refresh chosen there), the host's read one chunk behind.  Here the
same slots run with the host standing in for the WHILE and IF nodes
(``_fixed_chunk``).  Results must not
depend on ``c``: for every ``c`` the solvers return bitwise the eager
loop's result (one read per step), through convergence, an exhausted
``imax`` (mid-chunk), the stagnation exit, both legs of an escalation,
``eps = 0``, Jacobi ``minv``, a residual that reaches exactly 0 (the steps
issued after it compute ``0/0``), and a ``cg_run`` resumed at 37 and at 48,
so that a chunk straddles the refreshes at 49 and 99.  A run of ``n``
iterations on the chunks reads the host ``max(1, ceil(n / c))`` times; the
slots after the stop change nothing; a replay counts the launches of the
steps that ran and of the refreshes among them.  Against the JAX package's
solvers (x64, as ``tests/test_torch_cg.py`` and
``tests/test_torch_adaptive.py`` run them): equal iteration counts, ``x``
within those files' tolerances (1e-10 relative on the linspace-spectrum
system, 1e-8 of the scale on the noisy ones; the stagnation exit, as
there, by its count alone).  The learns' ``setup`` /
``cg`` spans feed a ``Timings`` sink.

The ``cuda`` tests (skipped without a card) hold the chunk-graph solve bit
for bit to the eager masked loop at rbf 4096 x 256 on each tier (pinned,
to eps 1e-6, and resumed at 37), with one capture for the loop, and a
failed capture to a raised ``PLSSVMError``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cg_device_loop.py
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu_torch.exceptions import PLSSVMError
from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData as TParsed
from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
from plssvm_sparse_fp22_tpu_torch.solver import cg as tcg
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

CHUNKS = [1, 2, 3, 7, 16, 64]


def _jax():
    """``(jax.numpy, the JAX package's solver)``, imported where used: the
    ``cuda`` tests run on a machine without JAX."""
    import jax.numpy as jnp

    from plssvm_sparse_fp22_tpu.solver import cg as jcg

    return jnp, jcg


def _spd(D=400, dept=390, cond=100.0, seed=0):
    """SPD on the first ``dept`` entries, eigenvalues spread evenly over
    [1, cond] (``tests/test_torch_cg.py``): ~76 steps to eps = 1e-8, and
    the two packages stay at the rounding level along the way."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(dept, dept)))
    A = np.zeros((D, D))
    A[:dept, :dept] = (Q * np.linspace(1.0, cond, dept)) @ Q.T
    b = np.zeros(D)
    b[:dept] = rng.normal(size=dept)
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return A, b, mask


def _noisy_system(n=48, seed=0):
    """``tests/test_torch_adaptive.py``'s system, for a noisy fast tier."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return M @ M.T / n + np.eye(n) * 2.0, rng.normal(size=n), np.ones(n)


def _matvecs(pkg, A, mask, level=0.0):
    """``(exact, noisy)`` A·v of one package (``tests/test_adaptive.py:32-42``)."""
    n = A.shape[0]
    if pkg == "jax":
        jnp, _ = _jax()
        M, m, norm, sin, at = jnp.asarray(A), jnp.asarray(mask), jnp.linalg.norm, jnp.sin, jnp.dot
    else:
        M, m, norm, sin = torch.from_numpy(A), torch.from_numpy(mask), torch.linalg.norm, torch.sin
        at = torch.matmul

    def exact(v):
        return at(M, v) * m

    def noisy(v):
        Av = at(M, v)
        return (Av + level * norm(Av) * sin(v * 7919.0) / n ** 0.5) * m

    return exact, noisy


def _case(name, pkg):
    """Run one solver case in ``pkg`` (``jax`` or ``torch``): ``(x, delta,
    iterations, fast_iterations or None)`` as numpy / Python values."""
    if pkg == "jax":
        jnp, cg = _jax()
        arr = jnp.asarray
    else:
        cg, arr = tcg, torch.from_numpy
    fast = None
    if name in ("converge", "exhaust", "jacobi", "resume", "resume48"):
        A, b, mask = _spd(seed={"converge": 1, "exhaust": 2, "jacobi": 3, "resume": 4,
                                "resume48": 8}[name])
        mv, _ = _matvecs(pkg, A, mask)
        bt, mt = arr(b), arr(mask)
        if name == "converge":
            res = cg.cg_solve(mv, bt, mt, 1e-8, 500)
        elif name == "exhaust":
            res = cg.cg_solve(mv, bt, mt, 1e-12, 60)
        elif name == "jacobi":
            minv = mask / np.where(mask > 0, np.diag(A), 1.0)
            res = cg.cg_solve(mv, bt, mt, 1e-8, 500, minv=arr(minv))
        else:  # stop at 37 (no multiple of any c > 1) or 48, resume across 49 and 99
            stop = 37 if name == "resume" else 48
            state = cg.cg_run(mv, bt, mt, 0.0, stop, cg.cg_init(mv, bt, mt))
            state = cg.cg_run(mv, bt, mt, 0.0, 120, state)
            return np.asarray(state.x), float(state.delta), int(state.k), None
    elif name == "zero_residual":  # A = 2 I: r = 0 exactly after one step
        D = 64
        b = np.random.default_rng(5).normal(size=D)
        M = arr(2.0 * np.eye(D))
        res = cg.cg_solve(lambda v: M @ v, arr(b), arr(np.ones(D)), 0.0, 50)
    else:
        A, b, mask = _noisy_system(seed={"stagnation": 7, "escalation": 0, "pinned": 5}[name])
        exact, noisy = _matvecs(pkg, A, mask, 1e-2 if name == "stagnation" else 1e-3)
        bt, mt = arr(b), arr(mask)
        if name == "stagnation":
            s = cg.cg_run_stagnation(noisy, bt, mt, 1e-8, 500, cg.cg_init(noisy, bt, mt),
                                     patience=6, refresh_interval=1)
            return np.asarray(s.x), float(s.delta), int(s.k), None
        res = cg.cg_solve_adaptive(noisy, exact, bt, mt, 1e-5 if name == "escalation" else 0.0,
                                   200 if name == "escalation" else 120)
        fast = int(res.fast_iterations)
    return np.asarray(res.x), float(res.delta), int(res.iterations), fast


CASES = ["converge", "exhaust", "stagnation", "escalation", "pinned", "jacobi", "resume",
         "resume48", "zero_residual"]


def _torch_case(name, c):
    """The torch case on chunks of ``c`` slots, or eagerly for ``None``."""
    if c is None:
        return _case(name, "torch")
    with tcg._fixed_chunk(c):
        return _case(name, "torch")


@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("name", CASES)
def test_results_do_not_depend_on_the_chunk(name, c):
    """Bitwise ``x`` and ``delta``, equal ``iterations`` (and
    ``fast_iterations``) for every chunk size against the eager loop."""
    x, delta, iters, fast = _torch_case(name, c)
    x1, delta1, iters1, fast1 = _torch_case(name, None)
    np.testing.assert_array_equal(x, x1)
    assert delta == delta1 and iters == iters1 and fast == fast1
    assert np.all(np.isfinite(x))


def test_the_cases_reach_their_exits():
    """Each case exits the way its name says (at c = 1)."""
    _, delta, iters, _ = _torch_case("converge", 1)
    assert iters < 500
    assert _torch_case("exhaust", 1)[2] == 60
    _, delta, iters, _ = _torch_case("stagnation", 1)
    assert iters < 500 and delta > 0.0
    _, _, iters, fast = _torch_case("escalation", 1)
    assert iters > fast > 0
    assert _torch_case("pinned", 1)[2:] == (120, 120)
    assert _torch_case("resume", 1)[2] == _torch_case("resume48", 1)[2] == 120
    x, delta, iters, _ = _torch_case("zero_residual", 1)
    assert (iters, delta) == (1, 0.0)


@pytest.mark.parametrize("c", [1, 7])
@pytest.mark.parametrize("name", CASES)
def test_cases_match_the_jax_package(name, c):
    """Equal iteration counts (and fast-tier counts) with the JAX package's
    ``lax.while_loop``, ``x`` within the parity files' tolerances."""
    xj, _, iters_j, fast_j = _case(name, "jax")
    xt, _, iters_t, fast_t = _torch_case(name, c)
    assert iters_t == iters_j and fast_t == fast_j
    if name == "stagnation":
        # noise 1e-2 through sin(7919 v), refreshed every step, turns the
        # packages' rounding apart into 3e-3 of x: the counts are the check
        # (``test_torch_adaptive.py::test_stagnation_exit_fires``)
        return
    noisy = name in ("escalation", "pinned")
    scale = np.abs(xj).max()
    np.testing.assert_allclose(xt, xj, rtol=0 if noisy else 1e-10,
                               atol=(1e-8 if noisy else 1e-10) * scale)


def _pinned_120(adaptive: bool):
    A, b, mask = _spd(seed=6)
    mv, _ = _matvecs("torch", A, mask)
    bt, mt = torch.from_numpy(b), torch.from_numpy(mask)
    if adaptive:
        return tcg.cg_solve_adaptive(mv, mv, bt, mt, 0.0, 120).iterations
    return tcg.cg_solve(mv, bt, mt, 0.0, 120).iterations


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("c", CHUNKS)
def test_host_reads_once_per_chunk(c, adaptive):
    """A 120-iteration pinned solve on chunks of ``c`` reads the host
    ``ceil(120 / c)`` times (the adaptive solve once more, for ``armed``),
    one chunk behind: it issues one chunk more than it reads, so the slots
    issued are ``c (ceil(120 / c) + 1)``, of which 120 ran."""
    tcg.reset_counts()
    with tcg._fixed_chunk(c):
        assert _pinned_120(adaptive) == 120
    chunks = math.ceil(120 / c)
    assert tcg.counts["host_reads"] == chunks + adaptive
    assert tcg.counts["steps"] == c * (chunks + 1)
    assert tcg.counts["executed"] == 120
    assert tcg.last_run == {"chunk": c, "graph": False}


def test_cpu_solves_read_once_per_step():
    """Without a chunk set, the CPU's loop reads once per step (c = 1)."""
    tcg.reset_counts()
    assert _pinned_120(False) == 120
    assert tcg.counts["host_reads"] == tcg.counts["steps"] == tcg.counts["executed"] == 120
    assert tcg.last_run == {"chunk": 1, "graph": False}


def test_masked_steps_after_the_stop_are_no_ops():
    """With c = 64 a converged solve issues slots past its iteration count,
    in its last chunk and the chunk queued behind it (which runs one
    skipped slot); the state is the eager loop's, bit for bit."""
    tcg.reset_counts()
    x, delta, iters, _ = _torch_case("converge", 64)
    chunks = math.ceil(iters / 64)
    assert tcg.counts["steps"] == 64 * (chunks + 1) > iters + 64
    assert tcg.counts["host_reads"] == chunks and tcg.counts["executed"] == iters
    x1, delta1, iters1, _ = _torch_case("converge", None)
    np.testing.assert_array_equal(x, x1)
    assert (delta, iters) == (delta1, iters1)


@pytest.mark.parametrize("stagnation", [False, True])
@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("stop", ["imax", "zero_residual"])
def test_a_step_after_the_stop_changes_nothing(stop, refresh, stagnation):
    """The masked step that a slot behind a stopped loop would run (the IF
    nodes skip it; the eager loop and the warm-up may issue it) leaves the
    carry bitwise as it was, also where its ``0/0`` is NaN."""
    D = 64
    b = torch.from_numpy(np.random.default_rng(5).normal(size=D))
    M = 2.0 * torch.eye(D, dtype=torch.float64)
    state = tcg.cg_init(lambda v: M @ v, b, torch.ones(D))
    if stop == "zero_residual":  # A = 2 I: r = 0 exactly after one step
        state = tcg.cg_run(lambda v: M @ v, b, torch.ones(D), 0.0, 50, state)
        assert float(state.delta) == 0.0
    carry = tcg._Carry(b, None, stagnation)
    carry.load(b, None, state, torch.tensor(0.0, dtype=torch.float64),
               state.k if stop == "imax" else 50, 8 if stagnation else None)
    assert not bool(carry.active)
    names = ["x", "r", "d", "delta", "best", "since", "status"]
    before = {n: getattr(carry, n).clone() for n in names}
    tcg._step(carry, lambda v: M @ v, tcg._dot, refresh)
    for n in names:
        assert torch.equal(getattr(carry, n), before[n]), n


@pytest.mark.parametrize("c", [1, 3, 16, 64])
@pytest.mark.parametrize("name", ["converge", "exhaust", "stagnation", "escalation", "jacobi",
                                  "zero_residual"])
def test_lagged_reads_follow_the_rule(name, c, monkeypatch):
    """Every run on the chunks reads ``max(1, ceil(n / c))`` times for its
    ``n`` iterations and issues one chunk more than it reads; the adaptive
    solve adds one read for ``armed`` and, where armed and short of
    ``imax``, one for the escalation."""
    runs = []
    real_run = tcg._run

    def counting_run(*args, **kw):
        before = dict(tcg.counts)
        out = real_run(*args, **kw)
        runs.append({k: tcg.counts[k] - before[k] for k in before})
        return out

    monkeypatch.setattr(tcg, "_run", counting_run)
    tcg.reset_counts()
    _, _, iters, fast = _torch_case(name, c)
    for run in runs:
        assert run["host_reads"] == max(1, math.ceil(run["executed"] / c))
        assert run["steps"] == c * (run["host_reads"] + 1)
    assert sum(run["executed"] for run in runs) == iters
    extra = 0 if name != "escalation" else 1 + (fast < 200)
    assert tcg.counts["host_reads"] == sum(run["host_reads"] for run in runs) + extra


@pytest.mark.parametrize("k,active,want", [
    (0, True, (True, False)), (48, True, (True, False)), (49, True, (False, True)),
    (50, True, (True, False)), (99, True, (False, True)), (49, False, (False, False)),
    (7, False, (False, False))])
def test_slot_predicates(k, active, want):
    """The slot kernel's predicates: the plain step where active and
    ``k % 50 != 49``, the refresh step where active and ``k % 50 == 49``."""
    carry = tcg._Carry(torch.zeros(4), None, False)
    carry.k.fill_(k)
    carry.active.fill_(active)
    assert tcg._slot_predicates(carry, 50) == want


@pytest.mark.parametrize("k_from,k_to,interval,want", [
    (0, 0, 50, 0), (0, 49, 50, 0), (0, 50, 50, 1), (49, 50, 50, 1), (50, 99, 50, 0),
    (37, 101, 50, 2), (48, 120, 50, 2), (0, 7, 1, 7), (3, 3, 1, 0)])
def test_refreshes_in_a_range(k_from, k_to, interval, want):
    """Refresh indices ``k % R == R - 1`` in ``[k_from, k_to)``, by count."""
    assert tcg._refreshes(k_from, k_to, interval) == want
    assert want == sum(k % interval == interval - 1 for k in range(k_from, k_to))


def test_replays_add_the_captured_counts():
    """The launch accounting of a replay: what each step's capture counted
    (and took back: a capture launches nothing), added once per plain step
    and once per refresh step that ran, read from ``k`` before and after
    the chunk: K1 once per step, once more per refresh."""
    gm.reset_launches()
    gm.reset_preparations()
    before = gm.counts_snapshot()
    gm.launches["gram_matvec_sym/exact"] += 2
    gm.preparations["bf16cast"] += 1
    added = gm.counts_since(before)
    assert added == ({"gram_matvec_sym/exact": 2}, {"bf16cast": 1})
    gm.add_counts(added, -1)
    assert gm.counts_since(before) == ({}, {})
    chunk = object.__new__(tcg._ChunkGraph)  # its accounting alone: no card here
    chunk.interval = 50
    chunk.steps = {False: (None, ({"gram_matvec_sym/exact": 1}, {})),
                   True: (None, ({"gram_matvec_sym/exact": 2}, {"bf16cast": 1}))}
    chunk.account(37, 101)  # 64 steps, the refreshes at 49 and 99
    assert gm.launches["gram_matvec_sym/exact"] == 64 + 2
    assert gm.preparations["bf16cast"] == 2
    chunk.account(101, 101)  # a chunk of skipped slots
    assert gm.launches["gram_matvec_sym/exact"] == 66


@pytest.mark.parametrize("c", [1, 3, 16, 64])
def test_accounting_matches_the_calls_the_eager_loop_makes(c):
    """Counted from ``k`` as a replay counts (one A·v per step, one more
    per refresh), a resumed run's A·v are the calls the eager loop makes
    for the same run, across the refreshes at 49 and 99; the chunked run
    is bitwise the eager one."""
    A, b, mask = _spd(seed=4)
    M, m = torch.from_numpy(A), torch.from_numpy(mask)
    calls = [0]

    def mv(v):
        calls[0] += 1
        return (M @ v) * m

    bt = torch.from_numpy(b)
    state = tcg.cg_run(mv, bt, m, 0.0, 37, tcg.cg_init(mv, bt, m))
    calls[0] = 0
    eager = tcg.cg_run(mv, bt, m, 0.0, 120, state)
    assert calls[0] == (eager.k - 37) + tcg._refreshes(37, eager.k, 50) == 83 + 2
    with tcg._fixed_chunk(c):
        chunked = tcg.cg_run(mv, bt, m, 0.0, 120, state)
    assert chunked.k == eager.k == 120
    torch.testing.assert_close(chunked.x, eager.x, rtol=0, atol=0)


def test_across_devices_marks_and_still_solves():
    """A marked A·v runs the same loop (no graph anywhere on the CPU)."""
    A, b, mask = _spd(seed=1)
    mv, _ = _matvecs("torch", A, mask)
    marked = tcg.across_devices(mv)
    assert tcg.across_devices(marked) is marked
    bt, mt = torch.from_numpy(b), torch.from_numpy(mask)
    got, want = tcg.cg_solve(marked, bt, mt, 1e-8, 500), tcg.cg_solve(mv, bt, mt, 1e-8, 500)
    assert got.iterations == want.iterations
    torch.testing.assert_close(got.x, want.x, rtol=0, atol=0)


# --- the learns' set-up / CG split -------------------------------------------------

def _svm(X, y, kernel, **kw):
    csr = sp.csr_matrix(X)
    p = tp.Parameter(kernel=kernel, gamma=0.1, coef0=1.0, epsilon=1e-6, print_info=False,
                     dtype=np.float64, devices=1, **kw)
    p.data = TParsed(csr=csr, values=y) if kw.get("sparse_threshold") else \
        TParsed(csr=csr, values=y, _dense=X)
    p.values = y
    svm = tp.make_csvm(p)
    svm.timings = Timings()
    return svm


@pytest.mark.parametrize("route,kernel,env,mode", [
    ("dense", "rbf", {}, "cached"),
    ("dense", "rbf", {"PLSSVM_K_CACHE_BYTES": "1000"}, "implicit"),
    ("dense", "linear", {}, "linear"),
    ("dense", "rbf", {"PLSSVM_MATMUL_PRECISION": "adaptive",
                      "PLSSVM_K_CACHE_BYTES": "1000"}, "implicit"),
    ("sparse", "linear", {}, "sparse_linear"),
    ("sparse", "rbf", {"PLSSVM_SPARSE_MODE": "gram"}, "sparse_gram"),
    ("sparse", "rbf", {"PLSSVM_SPARSE_MODE": "dense"}, "sparse_dense_implicit"),
    ("sparse", "rbf", {"PLSSVM_SPARSE_MODE": "implicit"}, "sparse_implicit"),
    ("sparse", "rbf", {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_SPARSE_STREAM": "gather"},
     "sparse_implicit"),
])
def test_one_shot_learns_split_setup_and_cg(route, kernel, env, mode, monkeypatch):
    """The one-shot dense learn and every sparse tier feed ``setup`` and
    ``cg`` spans into a ``Timings`` sink; ``last_cg_loop`` reports the
    steps, reads and chunk of the device loop."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 12))
    if route == "sparse":
        X = X * (rng.random(X.shape) < 0.2)
        X[np.arange(80), rng.integers(12, size=80)] = 1.0
    y = np.where(X[:, 0] + 0.3 * rng.normal(size=80) > 0, 1.0, -1.0)
    kw = {"sparse_threshold": 1.0} if route == "sparse" else {}
    svm = _svm(X, y, tp.KernelType[kernel], **kw)
    svm.learn()
    assert svm.last_cg_info["mode"] == mode
    spans = svm.timings.records
    assert set(spans) == {"setup", "cg"} and len(spans["cg"]) == 1
    assert all(ms >= 0.0 for v in spans.values() for ms in v)
    loop = svm.last_cg_loop
    assert loop["steps"] >= loop["executed"] == svm.last_cg_info["iterations"] > 0
    assert loop["host_reads"] >= loop["steps"] and loop["chunk"] == 1 and not loop["graph"]


# --- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rbf_operator(dev, tier, D=4096, f=256):
    from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator

    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    xl = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev)
    mask = torch.ones(D, device=dev)
    q = gram_block(tp.KernelType.rbf, X, xl[None, :], gamma=1.0 / f)[:, 0]
    ci = torch.tensor(1.0, device=dev)
    QA = kernel_scalar(tp.KernelType.rbf, xl, xl, gamma=1.0 / f) + ci
    op = build_operator(tp.KernelType.rbf, X, q, mask, QA, ci, gamma=1.0 / f, mode="implicit",
                        backend=tp.BackendType.cuda, precision=tier)
    b = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
    return op, b, mask


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["exact", "bf16x3", "bf16cast"])
def test_graph_solve_is_bitwise_the_eager_loop(cuda_dev, tier):
    """rbf 4096 x 256 on the card: the chunk-graph solve (pinned across the
    refresh at 49, to eps 1e-6, and resumed at 37 to 120) against the eager
    masked loop, bit for bit; K1 counted once per step that ran, once for
    the initial residual and once per refresh; one capture for the loop;
    reads one chunk behind."""
    op, b, mask = _rbf_operator(cuda_dev, tier)
    name = f"gram_matvec_sym/{tier}"
    start = tcg.cg_init(op.matvec, b, mask)
    with tcg.eager_loop():
        at37 = tcg.cg_run(op.matvec, b, mask, 0.0, 37, start)
    tcg.reset_counts()
    for eps, imax, state in ((0.0, 60, None), (1e-6, 500, None), (0.0, 120, at37)):
        k0 = 0 if state is None else state.k
        before = dict(tcg.counts)
        gm.reset_launches()
        if state is None:
            graph = tcg.cg_solve(op.matvec, b, mask, eps, imax)
        else:
            graph = tcg.cg_run(op.matvec, b, mask, eps, imax, state)
        assert tcg.last_run["graph"] and tcg.counts["replays"] > before["replays"]
        ran = tcg.counts["executed"] - before["executed"]
        reads = tcg.counts["host_reads"] - before["host_reads"]
        k = graph.iterations if state is None else graph.k
        assert ran == k - k0 and reads <= math.ceil(ran / tcg.last_run["chunk"]) + 2
        assert gm.launches[name] == ran + (state is None) + tcg._refreshes(k0, k, 50)
        k1 = gm.launches[name]
        gm.reset_launches()
        with tcg.eager_loop():
            if state is None:
                eager = tcg.cg_solve(op.matvec, b, mask, eps, imax)
            else:
                eager = tcg.cg_run(op.matvec, b, mask, eps, imax, state)
        assert not tcg.last_run["graph"] and gm.launches[name] == k1
        if state is None:
            assert graph.iterations == eager.iterations
        else:
            assert graph.k == eager.k == imax
        assert torch.equal(graph.x, eager.x) and torch.equal(graph.delta, eager.delta)
    assert tcg.counts["captures"] == 1  # cg_run's loop, one chunk graph


@pytest.mark.cuda
def test_failed_capture_raises(cuda_dev):
    """A host read inside the A·v breaks the capture of the chunk's plain
    step: the solve raises ``PLSSVMError`` naming the operator, it does not
    run eagerly, and no chunk graph is kept."""
    w = torch.linspace(1.0, 2.0, 256, device=cuda_dev)

    def reads_the_host(v):
        return w * v * float(v.abs().max())

    # a diagonal of distinct entries: the loop runs past its eager first
    # step to the capture
    b = torch.ones(256, device=cuda_dev)
    tcg.reset_counts()
    with pytest.raises(PLSSVMError, match="plain CG step of operator .*reads_the_host"):
        tcg.cg_solve(reads_the_host, b, torch.ones_like(b), 0.0, 10)
    assert tcg.counts["captures"] == tcg.counts["replays"] == 0
