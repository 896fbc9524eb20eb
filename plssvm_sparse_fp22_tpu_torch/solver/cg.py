"""Conjugate gradients with a data-dependent iteration count.

Port of the JAX package's ``solver/cg.py`` (``cg_init``, ``cg_run``,
``cg_solve``, and the adaptive two-tier solve ``cg_run_stagnation`` /
``cg_solve_adaptive``), itself the equivalent of ``gpu_csvm::solver_CG``
(``src/plssvm/backends/gpu_csvm.cpp:186-324``) and
``openmp::csvm::solver_CG`` (``OpenMP/csvm.cpp:82-170``), with the same
semantics:

- start vector ``x = 1`` on the valid entries (``x0 = mask``),
- stop when ``delta <= eps^2 * delta0`` (``gpu_csvm.cpp:293``) or after
  ``imax`` iterations,
- full residual recompute ``r = b - A x`` when ``k % 50 == 49``
  (``OpenMP/csvm.cpp:130-139``),
- ``beta = delta_new / delta_old``, ``d = beta * d + r``; diagonal PCG
  through ``minv``.

The loop is the JAX package's ``lax.while_loop`` (``cg.py:175, 269``) in
PyTorch terms: its carry stays on the device.  ``k``, ``delta``, the
stagnation detector's ``best`` and ``since``, and an ``active`` flag (the
loop's condition: ``k < imax``, ``delta > target``, and not ``armed and
since >= patience``) are device tensors.  A step applies its update through
``torch.where(active, new, old)`` and adds ``active`` to ``k``, so a step
issued after the loop has stopped is an exact no-op.  The host chooses the
residual refresh from the issued step's index (while the loop is active,
``k`` is the start ``k`` plus the steps issued, so the refresh falls where
the reference's does, after a resume from any ``k`` too), issues steps in
chunks of ``c`` and reads ``(active, k)`` once per chunk: one small
device-to-host copy per chunk, not one per iteration.  Results and
iteration counts do not depend on ``c``; ``k`` is read once more when a
run ends and returned as a Python int.

On the card a one-device solve replays its step as a CUDA graph: two
one-step graphs per operator and loop (the plain step and the refresh
step; :func:`cg_run`'s loop, or the stagnation loop's, which also carries
``best`` and ``since``), captured on static buffers in a private memory pool, each at its first
use once the operator's first step has run eagerly (the warm-up capture
needs).  An A·v that carries a :class:`Layout` (``matvec.layout``, a weak
reference, as the learns' operators do: the layout holds the operators, so
a strong one would make a cycle that only the garbage collector frees, at
any moment, a capture's included) keeps its graphs in that layout, so every solve of
the layout, in later learns too, replays them: the counterpart of the JAX
package's compiled-program cache (``_learn_jit``).  The layout holds the
buffers the captured launches read, and its owner writes each learn's
values into them; its key holds everything a capture bakes in (the shape,
the kernel and its constants ``gamma``, ``coef0`` and ``degree``, the
tiers), so another ``gamma`` captures anew, while ``cost`` and ``eps``
reach the step as device tensors and capture nothing again (a solve that
reaches a loop the layout has not run yet, the adaptive escalation or the
refresh step past iteration 49, captures that loop once).  One layout is kept
per device, the last one asked for (:func:`layout`), the one it replaces
freed with its graphs; :func:`clear_graphs` frees them all.  Any other A·v
keeps its graphs for its own life (a chunked learn's chunks reuse them).
A graph's replay
adds the kernel launches its capture counted to
``ops/gram_matvec.launches``.  A failed capture raises
:class:`~..exceptions.PLSSVMError` naming the operator; nothing falls back.
There ``c = 1 + floor(t_turn / t_step)``, at most 16: ``t_step`` is one
replay's device time (CUDA events) and ``t_turn`` the host's turnaround
for one read and relaunch, each the least of two single-step chunks
measured once per operator.  The masked steps issued after convergence
then cost at most about one turnaround.

The same masked step runs eagerly, one read per step (``c = 1``), on the
CPU, for an A·v marked :func:`across_devices` (the sharded learns: their
hops copy between devices and processes, so every rank issues the same
steps), and everywhere under :func:`eager_loop`, the plain version the
graphs are held against.  :data:`counts` counts the steps issued, the host
reads, the captures and the replays.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import weakref
from typing import Callable, NamedTuple

import torch

from ..constants import RESIDUAL_REFRESH_INTERVAL
from ..exceptions import PLSSVMError
from ..ops import gram_matvec as gm
from ..utils.assertions import plssvm_assert


class CGResult(NamedTuple):
    x: torch.Tensor  # solution on the padded system (padding entries zero)
    iterations: int  # CG iterations executed
    delta: torch.Tensor  # final squared residual norm (0-d)
    delta0: torch.Tensor  # initial squared residual norm (0-d)


class CGState(NamedTuple):
    """Complete CG state between iterations."""

    k: int  # iteration counter
    x: torch.Tensor
    r: torch.Tensor
    d: torch.Tensor
    delta: torch.Tensor
    delta0: torch.Tensor


class AdaptiveCGResult(NamedTuple):
    """:class:`CGResult` plus the fast-tier iteration count of the adaptive
    two-tier solve (``fast_iterations == iterations`` means the accurate
    tier was never entered)."""

    x: torch.Tensor
    iterations: int
    delta: torch.Tensor
    delta0: torch.Tensor
    fast_iterations: int


#: since the last :func:`reset_counts`: CG steps issued (masked no-ops
#: included), host reads of the device's state, CUDA-graph captures and
#: replays
counts = {"steps": 0, "host_reads": 0, "captures": 0, "replays": 0}
#: the last run's chunk size ``c`` and whether it replayed graphs
last_run = {"chunk": 1, "graph": False}
#: since the last :func:`reset_counts`: host milliseconds of the graph
#: path's eager warm-up steps and captures, the device synchronised around
#: each (a learn reports them as the ``cg/capture`` part of its ``cg`` span)
spent = {"capture_ms": 0.0}

#: the largest chunk the graph path derives
MAX_CHUNK = 16
#: ``eager``: :func:`eager_loop` is on; ``chunk``: a fixed ``c`` for tests
_mode = {"eager": False, "chunk": None}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0
    spent["capture_ms"] = 0.0


@contextlib.contextmanager
def eager_loop():
    """Run every solve's masked loop eagerly, on the card too: the plain
    version that the CUDA graphs are held against, bit for bit."""
    old = _mode["eager"]
    _mode["eager"] = True
    try:
        yield
    finally:
        _mode["eager"] = old


@contextlib.contextmanager
def _fixed_chunk(c: int):
    """Issue ``c`` steps per host read on every path (tests: results do
    not depend on ``c``)."""
    old = _mode["chunk"]
    _mode["chunk"] = int(c)
    try:
        yield
    finally:
        _mode["chunk"] = old


class _AcrossDevices:
    """An A·v that spans several devices or processes: never captured."""

    __slots__ = ("matvec",)

    def __init__(self, matvec: Callable):
        self.matvec = matvec

    def __call__(self, v):
        return self.matvec(v)


def across_devices(matvec: Callable) -> Callable:
    """Mark ``matvec`` as spanning several devices or processes (the
    sharded learns): the solver runs its masked step eagerly, one host read
    per step, so every rank issues the same steps."""
    return matvec if isinstance(matvec, _AcrossDevices) else _AcrossDevices(matvec)


def _dot(a, b):
    return torch.dot(a, b)


def _read(t: torch.Tensor) -> list:
    """One host read of the device's state."""
    counts["host_reads"] += 1
    return t.tolist()


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGResult:
    """Solve ``A x = b`` on the padded system.

    ``b`` and ``mask`` are (D,) with zero padding; ``matvec`` must preserve
    zero padding.  ``minv`` enables diagonal-preconditioned CG; the stopping
    criterion stays on the unpreconditioned residual.  ``dot`` customizes
    the inner product (the JAX package's multi-device learns pass a reduced
    dot)."""
    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    plssvm_assert(minv is None or minv.shape == b.shape,
                  "preconditioner diagonal shape {} != system shape {}",
                  None if minv is None else minv.shape, b.shape)
    state = cg_init(matvec, b, mask, minv, dot)
    state = cg_run(matvec, b, mask, eps, imax, state, refresh_interval, minv, dot)
    return CGResult(x=state.x, iterations=state.k, delta=state.delta, delta0=state.delta0)


def cg_init(matvec: Callable, b: torch.Tensor, mask: torch.Tensor,
            minv: torch.Tensor | None = None, dot: Callable = _dot) -> CGState:
    """Initial CG state: x = 1 on valid entries, r = b - A x
    (``gpu_csvm.cpp:192-223``).  With ``minv``: d0 = M^-1 r0 (PCG)."""
    x0 = mask.to(b.dtype)
    r0 = b - matvec(x0)
    delta0 = dot(r0, r0)
    d0 = r0 if minv is None else minv * r0
    return CGState(k=0, x=x0, r=r0, d=d0, delta=delta0, delta0=delta0)


class _Carry:
    """A run's inputs (``b``, ``minv``, ``target``, ``imax``, the stagnation
    window) and its carry (``x``, ``r``, ``d``, ``delta``, ``best``,
    ``since``, ``k``, ``active``) as tensors on the system's device.
    ``status`` holds ``(active, k)``, the one thing the host reads.  Without
    ``stagnation`` (:func:`cg_run`'s loop) ``best`` and ``since`` are not
    kept, as the JAX ``cg_run`` carries neither."""

    def __init__(self, b: torch.Tensor, minv: torch.Tensor | None, stagnation: bool):
        dev, dtype = b.device, b.dtype
        self.stagnation = stagnation

        def scalar(dt):
            return torch.zeros((), dtype=dt, device=dev)

        self.b = torch.empty_like(b)
        self.minv = None if minv is None else torch.empty_like(minv)
        self.x, self.r, self.d = (torch.empty_like(b) for _ in range(3))
        self.delta, self.best, self.target = (scalar(dtype) for _ in range(3))
        self.since, self.imax, self.window = (scalar(torch.int64) for _ in range(3))
        self.active = scalar(torch.bool)
        self.status = torch.zeros(2, dtype=torch.int64, device=dev)
        self.k = self.status[1]

    def load(self, b, minv, state: CGState, target, imax: int, patience: int | None):
        """Start a run from ``state``; the stagnation exit (``patience``,
        given with ``stagnation``) is armed where ``target > 0``."""
        self.b.copy_(b)
        if minv is not None:
            self.minv.copy_(minv)
        for dst, src in ((self.x, state.x), (self.r, state.r), (self.d, state.d),
                         (self.delta, state.delta), (self.best, state.delta),
                         (self.target, target)):
            dst.copy_(src)
        self.since.zero_()
        self.k.fill_(int(state.k))
        self.imax.fill_(imax)
        if self.stagnation:
            self.window.fill_(torch.iinfo(torch.int64).max)
            self.window.masked_fill_(self.target > 0, patience)
        self.update_active()

    def update_active(self) -> None:
        """The loop's condition on the device (the JAX ``cond``)."""
        torch.logical_and(self.k < self.imax, self.delta > self.target, out=self.active)
        if self.stagnation:
            self.active.logical_and_(self.since < self.window)
        self.status[0].copy_(self.active)


def _step(c: _Carry, matvec: Callable, dot: Callable, refresh: bool) -> None:
    """One masked CG iteration on the carry, in place: every update goes
    through ``torch.where(active, new, old)``, so an inactive step changes
    nothing (its ``0/0`` never reaches the state)."""
    Ad = matvec(c.d)
    # PCG step scalars come from r.z; recomputing r.z from the stored r
    # keeps the state identical for both paths
    rz = c.delta if c.minv is None else dot(c.r, c.minv * c.r)
    alpha = rz / dot(c.d, Ad)
    x = c.x + alpha * c.d
    r = c.b - matvec(x) if refresh else c.r - alpha * Ad
    delta = dot(r, r)
    if c.minv is None:
        d = (delta / c.delta) * c.d + r
    else:
        z = c.minv * r
        d = (dot(r, z) / rz) * c.d + z
    updates = [(x, c.x), (r, c.r), (d, c.d), (delta, c.delta)]
    if c.stagnation:
        since = torch.where(delta < 0.9 * c.best, 0, c.since + 1)
        updates += [(torch.minimum(c.best, delta), c.best), (since, c.since)]
    for new, old in updates:
        torch.where(c.active, new, old, out=old)
    c.k.add_(c.active)
    c.update_active()


def _name(matvec: Callable) -> str:
    return getattr(matvec, "__qualname__", None) or type(matvec).__name__


_SIDE_STREAMS: dict = {}


def _side_stream(dev: torch.device):
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


class Layout:
    """The buffers and CG step graphs of one system layout, kept across
    solves and learns (see the module's docstring).  ``key`` is its owner's
    description of everything a capture bakes in; ``buffers`` is the
    owner's object holding the tensors the captured launches read (``None``
    until the owner sets it); ``graphs`` maps a solve's loop (the A·v's
    name and tier, the system's size and dtype, ``minv`` present, the dot,
    the stagnation exit) to its step graphs."""

    def __init__(self, key):
        self.key = key
        self.buffers = None
        self.graphs: dict = {}


#: per device, the layout last asked for (:func:`layout`)
_LAYOUTS: dict = {}


def layout(key, device) -> Layout:
    """The kept :class:`Layout` of ``key`` on ``device``, or a new empty one
    that replaces the device's kept layout (which is freed, with its
    graphs, once nothing else holds it)."""
    device = torch.device(device)
    kept = _LAYOUTS.get(device)
    if kept is None or kept.key != key:
        kept = _LAYOUTS[device] = Layout(key)
    return kept


def clear_graphs() -> None:
    """Free every kept layout and every A·v's step graphs: the next solve
    of any operator warms up and captures anew."""
    _LAYOUTS.clear()
    _GRAPHS.clear()


class _StepGraphs:
    """One operator's CG step as two CUDA graphs (plain, refresh), each
    captured at its first use on a static :class:`_Carry`, sharing one
    private memory pool, with the chunk size measured for it."""

    def __init__(self, name: str, b: torch.Tensor, minv: torch.Tensor | None,
                 stagnation: bool):
        self.name = name
        self.carry = _Carry(b, minv, stagnation)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}  # refresh -> (CUDAGraph, counter increments per replay)
        self.warm = False
        self.chunk: int | None = None

    def issue(self, matvec: Callable, dot: Callable, refresh: bool) -> None:
        """One step: the operator's first runs eagerly (the warm-up: the
        libraries loaded and their workspaces allocated outside the graphs),
        each later one replays its kind's graph, captured at its first use
        (a solve of under 50 iterations never captures the refresh step)."""
        if not self.warm:
            with self._timed(), self._side_stream():
                _step(self.carry, matvec, dot, refresh)
            self.warm = True
            return
        if refresh not in self.graphs:
            with self._timed(), self._side_stream():
                self.graphs[refresh] = self._capture(matvec, dot, refresh)
        graph, added = self.graphs[refresh]
        graph.replay()
        gm.add_counts(added)
        counts["replays"] += 1

    @contextlib.contextmanager
    def _timed(self):
        """Add the block's milliseconds to ``spent["capture_ms"]``, the
        device synchronised before and after (a capture needs the first)."""
        dev = self.carry.b.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(dev)
        spent["capture_ms"] += (time.perf_counter() - t0) * 1e3

    @contextlib.contextmanager
    def _side_stream(self):
        """Warm-up and capture run on a side stream, ordered after the
        current stream's work and before its next."""
        dev = self.carry.b.device
        side, cur = _side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    def _capture(self, matvec, dot, refresh: bool):
        graph = torch.cuda.CUDAGraph()
        before = gm.counts_snapshot()
        failure = None
        graph.capture_begin(pool=self.pool)
        try:
            _step(self.carry, matvec, dot, refresh)
        except Exception as err:  # the capture must end before anything else runs
            failure = err
        try:
            graph.capture_end()
        except RuntimeError as err:
            failure = failure or err
        added = gm.counts_since(before)
        gm.add_counts(added, -1)  # a capture launches nothing; each replay counts it
        if failure is not None:
            kind = "refresh" if refresh else "plain"
            raise PLSSVMError(
                f"capturing the {kind} CG step of operator '{self.name}' (D = "
                f"{self.carry.b.shape[0]}, {self.carry.b.dtype}) as a CUDA graph failed: "
                f"{failure}") from failure
        counts["captures"] += 1
        return graph, added


#: per A·v callable without a layout, its step graphs
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _graph_store(matvec, b, minv, dot, stagnation: bool) -> tuple[dict, tuple]:
    """Where a solve's step graphs are kept, and their key there: the
    A·v's :class:`Layout` (``matvec.layout``, a weak reference) under the
    loop's description, else (no layout, or one already freed) a dict of
    the callable's own, for its life."""
    key = (_name(matvec), b.shape[0], b.dtype, minv is None, dot, stagnation)
    ref = getattr(matvec, "layout", None)
    kept = None if ref is None else ref()
    if kept is not None:
        return kept.graphs, key
    try:
        return _GRAPHS.setdefault(matvec, {}), key
    except TypeError:  # not weakly referenceable: graphs for this run only
        return {}, key


def _graphs_for(matvec, b, minv, dot, stagnation: bool) -> _StepGraphs | None:
    """The step graphs of a one-device solve on the card, else ``None``
    (the eager loop)."""
    if _mode["eager"] or not b.is_cuda or isinstance(matvec, _AcrossDevices):
        return None
    store, key = _graph_store(matvec, b, minv, dot, stagnation)
    if key not in store:
        store[key] = _StepGraphs(_name(matvec), b, minv, stagnation)
    return store[key]


def _derive_chunk(samples: list) -> int:
    """``1 + floor(t_turn / t_step)``, at most :data:`MAX_CHUNK`, from
    ``(host ms, device ms)`` of single-step chunks."""
    t_step = min(dev_ms for _, dev_ms in samples)
    t_turn = min(max(0.0, host_ms - dev_ms) for host_ms, dev_ms in samples)
    if t_step <= 0.0:
        return MAX_CHUNK
    return max(1, min(MAX_CHUNK, 1 + math.floor(t_turn / t_step)))


def _run(matvec, b, minv, dot, state: CGState, target, imax, patience,
         refresh_interval: int) -> CGState:
    """Continue CG from ``state`` to ``imax`` total iterations (or the
    stopping rule), in chunks of steps between host reads."""
    imax, k0 = int(imax), int(state.k)
    if k0 >= imax:
        return CGState(k=k0, x=state.x, r=state.r, d=state.d, delta=state.delta,
                       delta0=state.delta0)
    stagnation = patience is not None
    graphs = _graphs_for(matvec, b, minv, dot, stagnation)
    carry = _Carry(b, minv, stagnation) if graphs is None else graphs.carry
    carry.load(b, minv, state, target, imax, patience)
    if graphs is None:
        def issue(refresh):
            _step(carry, matvec, dot, refresh)
    else:
        def issue(refresh):
            graphs.issue(matvec, dot, refresh)

    # a set chunk (tests), else the operator's measured one, else 1; the
    # graph path measures c on its operator's chunks 2 and 3 (chunk 1 warms
    # up), one step each, and the least of the two leaves out a capture
    measure = graphs is not None and graphs.chunk is None and not _mode["chunk"]
    c = _mode["chunk"] or (graphs.chunk if graphs is not None and graphs.chunk else 1)
    samples, k_host, chunk_no = [], k0, 0
    while True:
        n = min(c, imax - k_host)
        timed = measure and chunk_no > 0
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            events[0].record()
        for _ in range(n):
            issue(k_host % refresh_interval == refresh_interval - 1)
            k_host += 1
        if timed:
            events[1].record()
        counts["steps"] += n
        active, k = _read(carry.status)
        if timed:
            samples.append(((time.perf_counter() - t0) * 1e3,
                            events[0].elapsed_time(events[1])))
            if len(samples) == 2:
                c = graphs.chunk = _derive_chunk(samples)
                measure = False
        chunk_no += 1
        if not active:
            break
    last_run.update(chunk=c, graph=graphs is not None)
    x, r, d, delta = carry.x, carry.r, carry.d, carry.delta
    if graphs is not None:  # the static buffers serve the operator's next run
        x, r, d, delta = x.clone(), r.clone(), d.clone(), delta.clone()
    return CGState(k=k, x=x, r=r, d=d, delta=delta, delta0=state.delta0)


def cg_run(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    state: CGState,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGState:
    """Continue CG from ``state`` until convergence or ``imax`` total
    iterations.  ``state.delta`` always holds the plain residual ``r.r``."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps * eps * state.delta0
    return _run(matvec, b, minv, dot, state, target, imax, None, refresh_interval)


#: iterations without a >= 10 % residual improvement before the adaptive
#: solve declares the fast tier stagnated
STAGNATION_PATIENCE: int = 8


def _default_patience() -> int:
    """``PLSSVM_CG_STAG_PATIENCE``, else :data:`STAGNATION_PATIENCE` (also
    when the value is not an integer), read when called."""
    try:
        return int(os.environ.get("PLSSVM_CG_STAG_PATIENCE", STAGNATION_PATIENCE))
    except ValueError:
        return STAGNATION_PATIENCE


def cg_run_stagnation(
    matvec: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    state: CGState,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> CGState:
    """:func:`cg_run` with a stagnation exit (``cg.py:194-270`` of the JAX
    package): the loop also stops when the residual norm has not improved
    on its best-seen value by at least 10 % for ``patience`` consecutive
    iterations, the signature of a matvec whose error floor (a bf16 tier)
    sits above the requested tolerance.  The detector is armed only when the
    target is positive (decided on the device); ``eps = 0``
    (pinned-iteration mode) runs exactly like :func:`cg_run`.

    The caller tells the exits apart from the returned state:
    ``delta <= eps^2 * delta0`` converged, ``k >= imax`` exhausted, anything
    else stagnated."""
    if patience is None:
        patience = _default_patience()
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps * eps * state.delta0
    return _run(matvec, b, minv, dot, state, target, imax, int(patience), refresh_interval)


def cg_solve_adaptive(
    matvec_fast: Callable,
    matvec_acc: Callable,
    b: torch.Tensor,
    mask: torch.Tensor,
    eps,
    imax: int,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: torch.Tensor | None = None,
    dot: Callable = _dot,
) -> AdaptiveCGResult:
    """Two-tier adaptive solve (``cg.py:273-336`` of the JAX package): CG on
    the cheap ``matvec_fast`` (one bf16 product) until it converges,
    stagnates or exhausts ``imax``; then the residual is verified with
    ``matvec_acc`` (bf16x3, f32-grade) and, if the target is not met, CG
    continues from the current iterate on the accurate tier, within the
    same ``imax``.  The verify step replaces r and d with the accurate
    residual, so a returned ``delta <= eps^2 * delta0`` is always an
    accurate-tier residual.  The verify and the escalation are decided once
    each, as the two ``lax.cond`` (``cg.py:326, 335``): one host read each.

    ``eps = 0`` pins the iteration count on the fast tier: stagnation,
    verification and escalation all disarm, as in :func:`cg_solve`."""
    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    state = cg_init(matvec_fast, b, mask, minv, dot)
    state = cg_run_stagnation(matvec_fast, b, mask, eps, imax, state, patience=patience,
                              refresh_interval=refresh_interval, minv=minv, dot=dot)
    k_fast = state.k
    eps_t = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    target = eps_t * eps_t * state.delta0
    if _read(target > 0):
        # accurate-tier residual at the fast iterate: one matvec
        r = b - matvec_acc(state.x)
        d = r if minv is None else minv * r
        state = CGState(k=state.k, x=state.x, r=r, d=d, delta=dot(r, r), delta0=state.delta0)
        if state.k < imax and _read(state.delta > target):
            state = cg_run(matvec_acc, b, mask, eps, imax, state, refresh_interval, minv, dot)
    return AdaptiveCGResult(x=state.x, iterations=state.k, delta=state.delta,
                            delta0=state.delta0, fast_iterations=k_fast)
