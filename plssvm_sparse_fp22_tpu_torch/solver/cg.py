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
issued after the loop has stopped is an exact no-op.

On the card a one-device solve runs as replays of one chunk graph per loop
(:func:`cg_run`'s, or the stagnation loop's, which also carries ``best``
and ``since``): a WHILE node that runs up to :data:`CHUNK` slots while the
loop is active, each slot one iteration with the residual refresh chosen
on the device, as the reference's ``lax.cond`` chooses it (``cg.py:161-162,
247-248``).  A slot is a one-thread kernel that reads ``active``, ``k`` and
the chunk's slot counter and sets three conditional handles (go: ``active``
and fewer than ``c`` slots run; plain: go and ``k % R != R - 1``; refresh:
go and ``k % R == R - 1``, with ``R`` the refresh interval, 50), then an
IF node on each of the last two, whose bodies are the plain and the
refresh step captured by PyTorch (``csrc/cg_chunk.cu``; conditional nodes
need CUDA 12.4).  A chunk launched after the stop runs one skipped slot
and changes nothing, so the host's read can trail the launches: the host
replays chunk j + 1 before it waits on chunk j's ``(active, k)`` (copied
into one of two page-locked buffers, used in turn), and stops at the first
read that shows the loop inactive, once the chunk queued behind it has
ended.  A run of ``n`` iterations on the chunks reads the host ``max(1,
ceil(n / c))`` times.

The chunk graph is built once per operator and loop, once the operator's
first step has run eagerly (the warm-up capture needs), on static buffers
in a private memory pool.  An A·v that carries a :class:`Layout`
(``matvec.layout``, a weak reference, as the learns' operators do: the
layout holds the operators, so a strong one would make a cycle that only
the garbage collector frees, at any moment, a capture's included) keeps
its graphs in that layout, so every solve of the layout, in later learns
too, replays them: the counterpart of the JAX package's compiled-program
cache (``_learn_jit``).  The layout holds the buffers the captured launches
read, and its owner writes each learn's values into them; its key holds
everything a capture bakes in (the shape, the kernel and its constants
``gamma``, ``coef0`` and ``degree``, the tiers), so another ``gamma``
captures anew, while ``cost`` and ``eps`` reach the step as device tensors
and capture nothing again (a solve that reaches a loop the layout has not
run yet, the adaptive escalation, captures that loop once).  One layout is
kept per device, the last one asked for (:func:`layout`), the one it
replaces freed with its graphs; :func:`clear_graphs` frees them all.  Any
other A·v keeps its graphs for its own life (a chunked learn's chunks reuse
them).  A replay counts the kernel launches of the steps that ran (read
from ``k``: the plain step's per iteration, the refresh step's per refresh
index) into ``ops/gram_matvec.launches``.  A failed capture or chunk build
raises :class:`~..exceptions.PLSSVMError` naming the operator; nothing
falls back.

The same masked step runs eagerly, one read per step (``c = 1``), on the
CPU, for an A·v marked :func:`across_devices` (the sharded learns: their
hops copy between devices and processes, so every rank issues the same
steps), and everywhere under :func:`eager_loop`: the plain version the
graphs are held against, which chooses the refresh from the issued step's
index (while the loop is active, ``k`` is the start ``k`` plus the steps
issued).  Under :func:`_fixed_chunk` the CPU runs the chunk's slots with
the host standing in for the WHILE and IF nodes, and the same lagged reads
(tests).  :data:`counts` counts the slots issued (``c`` per chunk launched,
one per eager step), the steps that ran, the host reads, the captures and
the replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import time
import weakref
from typing import Callable, NamedTuple

import torch

from ..constants import RESIDUAL_REFRESH_INTERVAL
from ..exceptions import PLSSVMError
from ..ops import _build
from ..ops import gram_matvec as gm
from ..utils import timing
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


#: since the last :func:`reset_counts`: CG steps issued (slots of the
#: chunks and eager steps, masked no-ops included), steps that ran, host
#: reads of the device's state, chunk graphs captured and replays
counts = {"steps": 0, "executed": 0, "host_reads": 0, "captures": 0, "replays": 0}
#: the last run's chunk size ``c`` and whether it replayed graphs
last_run = {"chunk": 1, "graph": False}
#: since the last :func:`reset_counts`: host milliseconds of the graph
#: path's eager warm-up steps and captures, the device synchronised around
#: each (a learn reports them as the ``cg/capture`` part of its ``cg`` span)
spent = {"capture_ms": 0.0}

#: iterations one chunk graph runs at most, between two host reads.  A
#: chunk launched after the stop costs one skipped slot whatever ``c`` is:
#: 15.8-18.8 us of device time on an NVIDIA H100 80GB HBM3 at 700 W
#: (``chip_smoke.py`` phase 23, ``scripts/profile_cg.stopped_chunk_us``),
#: 2 % of a 10-iteration solve at rbf 4096 x 256 on bf16cast (0.080 ms per
#: iteration there), so ``c`` only sets the reads: one for a solve of up
#: to 64 iterations
CHUNK = 64
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
    """Chunks of ``c`` slots: the card's chunk graphs, and on the CPU the
    same slots with the host standing in for the IF nodes, read one chunk
    behind as on the card (tests: results do not depend on ``c``)."""
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
    """The buffers and CG chunk graphs of one system layout, kept across
    solves and learns (see the module's docstring).  ``key`` is its owner's
    description of everything a capture bakes in; ``buffers`` is the
    owner's object holding the tensors the captured launches read (``None``
    until the owner sets it); ``graphs`` maps a solve's loop (the key of
    :func:`_graphs_for`) to its chunk graph."""

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
    """Free every kept layout and every A·v's chunk graphs: the next solve
    of any operator warms up and captures anew."""
    _LAYOUTS.clear()
    _GRAPHS.clear()


class _Lag:
    """Two host copies of a run's ``status``, used in turn: chunk j's copy
    goes to ``bufs[j % 2]`` (page-locked on the card, with an event), so
    the copy of chunk j + 1 never overwrites the one the host reads."""

    def __init__(self, dev: torch.device):
        on_card = dev.type == "cuda"
        self.bufs = [torch.zeros(2, dtype=torch.int64, pin_memory=on_card) for _ in range(2)]
        self.events = [torch.cuda.Event() if on_card else None for _ in range(2)]

    def post(self, j: int, status: torch.Tensor) -> None:
        self.bufs[j % 2].copy_(status, non_blocking=True)
        if self.events[j % 2] is not None:
            self.events[j % 2].record()

    def wait(self, j: int) -> None:
        if self.events[j % 2] is not None:
            self.events[j % 2].synchronize()

    def read(self, j: int) -> list:
        self.wait(j)
        return _read(self.bufs[j % 2])


def _lagged(status: torch.Tensor, replay: Callable, lag: _Lag, c: int, k0: int,
            account: Callable) -> int:
    """Replay chunks of ``c`` slots until a read shows the loop inactive,
    reading chunk j's ``status`` only once chunk j + 1 is queued; the last
    chunk (launched after the stop) has ended when this returns.  ``account(k
    before, k after)`` sees each chunk that was read.  Returns the final
    ``k``."""
    k_prev, j = k0, 0
    while True:
        replay()
        counts["steps"] += c
        lag.post(j, status)
        if j > 0:
            active, k = lag.read(j - 1)
            account(k_prev, k)
            k_prev = k
            if not active:
                lag.wait(j)
                return k
        j += 1


def _slot_predicates(c: _Carry, interval: int) -> tuple[bool, bool]:
    """The slot kernel of ``csrc/cg_chunk.cu`` on the host: whether the
    slot about to run takes the plain step and whether the refresh step."""
    active, k = bool(c.active), int(c.k)
    due = k % interval == interval - 1
    return active and not due, active and due


def _host_chunk(c: _Carry, matvec: Callable, dot: Callable, slots: int, interval: int) -> None:
    """One chunk graph run on the host (the CPU's stand-in for its WHILE
    and IF nodes, under :func:`_fixed_chunk`): up to ``slots`` slots, each
    reading both predicates before either step, as the slot kernel sets
    both handles, until the first slot that runs no step."""
    for _ in range(slots):
        plain, refresh = _slot_predicates(c, interval)
        if not (plain or refresh):
            break
        if plain:
            _step(c, matvec, dot, False)
        if refresh:
            _step(c, matvec, dot, True)


def _refreshes(k_from: int, k_to: int, interval: int) -> int:
    """Refresh indices ``k % interval == interval - 1`` in ``[k_from, k_to)``."""
    return k_to // interval - k_from // interval


class _ChunkGraph:
    """One operator's loop as a chunk graph (see the module's docstring):
    its static :class:`_Carry`, the plain and the refresh step captured in
    one private memory pool (kept: the pool holds their temporaries), the
    chunk built over them, and the two host buffers of the lagged reads."""

    def __init__(self, name: str, b: torch.Tensor, minv: torch.Tensor | None,
                 stagnation: bool, slots: int, interval: int):
        self.name = name
        self.carry = _Carry(b, minv, stagnation)
        self.slots, self.interval = slots, interval
        self.pool = torch.cuda.graph_pool_handle()
        self.warm = False
        self.steps: dict = {}  # refresh -> (CUDAGraph, counter increments per step)
        self.handles = None  # (cudaGraph_t, cudaGraphExec_t) of the chunk
        self.lag = _Lag(b.device)
        self.slot = torch.zeros((), dtype=torch.int64, device=b.device)  # slots run

    def __del__(self):
        handles = getattr(self, "handles", None)
        if handles is not None and not sys.is_finalizing():  # an exiting process frees all
            _build.load().cg_chunk_destroy(*handles)

    def warm_up(self, matvec: Callable, dot: Callable, refresh: bool) -> None:
        """The operator's first step, eagerly: the libraries loaded and
        their workspaces allocated outside the captures."""
        with self._timed(), self._side_stream():
            _step(self.carry, matvec, dot, refresh)
        self.warm = True

    def capture(self, matvec: Callable, dot: Callable) -> None:
        with self._timed(), self._side_stream():
            for refresh in (False, True):
                self.steps[refresh] = self._capture_step(matvec, dot, refresh)
            self._build_chunk()
        counts["captures"] += 1
        timing.count("cg_captures")

    def replay(self) -> None:
        dev = self.carry.b.device
        with torch.cuda.device(dev):
            rc = _build.load().cg_chunk_launch(self.handles[1],
                                               torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise PLSSVMError(f"replaying the CG chunk graph of operator '{self.name}' failed: "
                              f"{_cuda_error(rc)}")
        counts["replays"] += 1

    def account(self, k_from: int, k_to: int) -> None:
        """Count the launches of the steps ``[k_from, k_to)`` ran."""
        refreshes = _refreshes(k_from, k_to, self.interval)
        gm.add_counts(self.steps[False][1], k_to - k_from - refreshes)
        gm.add_counts(self.steps[True][1], refreshes)

    @contextlib.contextmanager
    def _timed(self):
        """Add the block's milliseconds to ``spent["capture_ms"]``, the
        device synchronised before and after (a capture needs the first);
        while a profiler records, the block is its range
        ``plssvm::cg/capture`` (the learn's ``cg`` span records the time)."""
        dev = self.carry.b.device
        with timing.annotate("cg/capture"):
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

    def _fail(self, what: str, failure) -> PLSSVMError:
        return PLSSVMError(
            f"capturing {what} of operator '{self.name}' (D = {self.carry.b.shape[0]}, "
            f"{self.carry.b.dtype}) as a CUDA graph failed: {failure}")

    def _capture_step(self, matvec, dot, refresh: bool):
        what = f"the {'refresh' if refresh else 'plain'} CG step"
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as err:  # a PyTorch that cannot hand the graph over
            raise self._fail(what, f"torch {torch.__version__} keeps no captured "
                                   f"cudaGraph_t ({err})") from err
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
        gm.add_counts(added, -1)  # a capture launches nothing; the replays count
        if failure is not None:
            raise self._fail(what, failure) from failure
        return graph, added

    def _build_chunk(self) -> None:
        lib = _build.load()
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.carry.b.device):
            rc = lib.cg_chunk_build(self.steps[False][0].raw_cuda_graph(),
                                    self.steps[True][0].raw_cuda_graph(),
                                    self.carry.active.data_ptr(), self.carry.k.data_ptr(),
                                    self.slot.data_ptr(), self.interval, self.slots,
                                    ctypes.byref(graph), ctypes.byref(exe))
        if rc != 0:
            raise self._fail(f"the CG chunk graph ({self.slots} slots of IF nodes)",
                             _cuda_error(rc))
        self.handles = (graph, exe)


def _cuda_error(rc: int) -> str:
    name = _build.load().cg_error_name(rc)
    return f"CUDA error {rc} ({name.decode() if name else 'unknown'})"


#: per A·v callable without a layout, its chunk graphs
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _store_of(matvec) -> dict:
    """Where the chunk graphs of ``matvec``'s solves are kept: its
    :class:`Layout` (``matvec.layout``, a weak reference), else (no layout,
    or one already freed) a dict of the callable's own, for its life."""
    ref = getattr(matvec, "layout", None)
    kept = None if ref is None else ref()
    if kept is not None:
        return kept.graphs
    try:
        return _GRAPHS.setdefault(matvec, {})
    except TypeError:  # not weakly referenceable: graphs for this run only
        return {}


def _graph_store(matvec, b, minv, dot, stagnation: bool, slots: int = CHUNK,
                 interval: int = RESIDUAL_REFRESH_INTERVAL) -> tuple[dict, tuple]:
    """:func:`_store_of` ``matvec`` and the key of a solve's loop there:
    the A·v's name and tier, the system's size and dtype, ``minv`` present,
    the dot, the stagnation exit, the slots and the refresh interval."""
    key = (_name(matvec), b.shape[0], b.dtype, minv is None, dot, stagnation, slots, interval)
    return _store_of(matvec), key


def _graphs_for(matvec, b, minv, dot, stagnation: bool, slots: int,
                interval: int) -> _ChunkGraph:
    """The chunk graph of a one-device solve's loop on the card."""
    store, key = _graph_store(matvec, b, minv, dot, stagnation, slots, interval)
    if key not in store:
        store[key] = _ChunkGraph(_name(matvec), b, minv, stagnation, slots, interval)
    return store[key]


def _run(matvec, b, minv, dot, state: CGState, target, imax, patience,
         interval: int) -> CGState:
    """Continue CG from ``state`` to ``imax`` total iterations (or the
    stopping rule): eagerly with a read per step, or in chunks read one
    behind (the card's chunk graphs, the CPU's stand-in under
    :func:`_fixed_chunk`)."""
    imax, k0 = int(imax), int(state.k)
    if k0 >= imax:
        return CGState(k=k0, x=state.x, r=state.r, d=state.d, delta=state.delta,
                       delta0=state.delta0)
    stagnation = patience is not None
    eager = _mode["eager"] or isinstance(matvec, _AcrossDevices) or (
        not b.is_cuda and _mode["chunk"] is None)
    graphs = None
    if eager:
        c, carry = 1, _Carry(b, minv, stagnation)
        carry.load(b, minv, state, target, imax, patience)
        k_host = k0
        while True:
            _step(carry, matvec, dot, k_host % interval == interval - 1)
            k_host += 1
            counts["steps"] += 1
            active, k = _read(carry.status)
            if not active:
                break
    elif not b.is_cuda:
        c, carry = _mode["chunk"], _Carry(b, minv, stagnation)
        carry.load(b, minv, state, target, imax, patience)
        k = _lagged(carry.status, lambda: _host_chunk(carry, matvec, dot, c, interval),
                    _Lag(b.device), c, k0, lambda k_from, k_to: None)
    else:
        c = _mode["chunk"] or CHUNK
        graphs = _graphs_for(matvec, b, minv, dot, stagnation, c, interval)
        carry = graphs.carry
        carry.load(b, minv, state, target, imax, patience)
        warm_step = not graphs.warm
        if warm_step:  # the solve's first step, eagerly; its launches count themselves
            graphs.warm_up(matvec, dot, k0 % interval == interval - 1)
            counts["steps"] += 1
        if graphs.handles is None:
            graphs.capture(matvec, dot)

        def account(k_from, k_to):
            nonlocal warm_step
            if warm_step and k_to > k_from:
                k_from += 1
            warm_step = False
            graphs.account(k_from, k_to)

        k = _lagged(carry.status, graphs.replay, graphs.lag, c, k0, account)
    counts["executed"] += k - k0
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
