"""Scoped timers and profiler integration.

Equivalent of the reference's inline ``std::chrono`` spans (SURVEY.md §5:
parse time ``parameter.cpp:168-175``, setup ``csvm.cpp:247-250``,
per-CG-iteration ``gpu_csvm.cpp:234-241``, predict ``gpu_csvm.cpp:121-124``,
model write ``csvm.cpp:197-203``) and of the JAX package's
``utils/timing.py``.

CUDA launches are asynchronous: a span that only reads the host's clock
times the enqueue.  :func:`scoped_timer` therefore takes the device whose
work it spans and synchronises it before each reading of the clock.

The program's spans (:func:`span`) and counters (:func:`count`) are off
unless a sink is given or a ``torch.profiler`` records.  While one
records, each span is also a ``plssvm::<label>`` range on the profiler's
clock, and spans and counters add up in :data:`TRACED`: a profiled call
(``with torch.profiler.profile(): svm.learn()``) leaves its breakdown
there.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler


def _synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a ``torch.device``, a string,
    or a list of them); nothing to wait for on the CPU or on ``None``."""
    if device is None:
        return
    if isinstance(device, (list, tuple)):
        for d in device:
            _synchronize(d)
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def scoped_timer(label: str, print_info: bool = True, sink=None, device=None):
    """Print ``{label} in {ms}ms.`` on exit (the reference's timing UX).

    ``device`` names the device (or devices) whose queued work belongs to
    the span: it is synchronised before the clock is read on entry and on
    exit.  ``sink(label, elapsed_ms)`` receives the span as well."""
    _synchronize(device)
    start = time.perf_counter()
    yield
    _synchronize(device)
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    if sink is not None:
        sink(label, elapsed_ms)
    if print_info:
        print(f"{label} in {elapsed_ms:.0f}ms.")


def slope_rate(run, lo: int, hi: int, trials: int = 5,
               grow_to_seconds: float | None = None,
               max_hi: int = 4096) -> float:
    """Iterations/s via a two-point slope: the one timing estimator of the
    package's benchmarks.

    ``run(seed, n_iters) -> elapsed_seconds`` must execute the same solve
    at two iteration caps with fresh inputs (and synchronise the device
    before it stops its clock); the rate is ``(hi - lo) / (t_hi - t_lo)``.
    This cancels constant set-up, transfer and first-launch overhead.  The
    median over ``trials`` is robust against outliers of the host's launch
    latency in either direction (a min would keep noise-deflated samples).

    With ``grow_to_seconds``, the (lo, hi) span is widened (hi *= 4, capped
    at ``max_hi``) until the measured difference dwarfs launch noise.

    ``run`` may also return ``(elapsed_seconds, executed_iters)``: the
    slope then uses the *executed* counts, which keeps the estimate correct
    when an eps=0 CG stops before the cap (a small system's f32 residual
    can underflow to exactly 0.0, ending the loop early).
    """
    def call(seed, n):
        out = run(seed, n)
        return out if isinstance(out, tuple) else (out, n)

    call(0, lo)  # warm-up: library load, allocator, first launches
    if grow_to_seconds is not None:
        while hi < max_hi:
            t_hi, k_hi = call(1, hi)
            t_lo, _ = call(2, lo)
            if t_hi - t_lo >= grow_to_seconds or k_hi < hi:
                break  # span large enough, or the solve converges early
            lo, hi = hi, hi * 4
            call(0, hi)  # warm the new cap
    samples = []
    for trial in range(trials):
        # alternate the call order: a monotone drift of the host's latency
        # then biases half the trials each way and the median stays honest
        if trial % 2:
            t_hi, k_hi = call(200 + trial, hi)
            t_lo, k_lo = call(100 + trial, lo)
        else:
            t_lo, k_lo = call(100 + trial, lo)
            t_hi, k_hi = call(200 + trial, hi)
        if t_hi > t_lo and k_hi > k_lo:
            samples.append((t_hi - t_lo) / (k_hi - k_lo))
    if not samples:
        t, k = call(300, hi)
        return k / t
    samples.sort()
    return 1.0 / samples[len(samples) // 2]


def profiling() -> bool:
    """Whether a ``torch.profiler`` records (one attribute read)."""
    return _profiler._is_profiler_enabled


def annotate(label: str):
    """The profiler range ``plssvm::<label>`` while a profiler records,
    else nothing.  The range is a host operation, as an ATen call is: the
    profiler mirrors a ``record_function`` annotation onto the device's
    timeline as if it were device work (an NVIDIA H100 trace showed it),
    and this range, PyTorch's own fast one, it does not."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(f"plssvm::{label}")
    return contextlib.nullcontext()


def span(sink, label: str, device=None):
    """A timed span, on where ``sink`` is given or a profiler records, else
    nothing at all (no synchronisation, no profiler call).  On, it is the
    profiler range ``plssvm::<label>`` (:func:`annotate`), synchronises
    ``device`` on entry and on exit, as :func:`scoped_timer` does, and
    records its milliseconds into ``sink`` where given and into
    :data:`TRACED` where the profiler recorded at its entry."""
    traced = _profiler._is_profiler_enabled
    if sink is None and not traced:
        return contextlib.nullcontext()
    return _on_span(sink, label, device, traced)


def no_span(label: str):
    """The ``span`` of a learn given none: nothing."""
    return contextlib.nullcontext()


@contextlib.contextmanager
def _on_span(sink, label: str, device, traced: bool):
    with annotate(label):
        _synchronize(device)
        start = time.perf_counter()
        yield
        _synchronize(device)
    record(sink, label, (time.perf_counter() - start) * 1000.0, traced)


def record(sink, label: str, elapsed_ms: float, traced: bool) -> None:
    """``elapsed_ms`` of ``label`` into ``sink`` where given, and into
    :data:`TRACED` where ``traced``."""
    if sink is not None:
        sink(label, elapsed_ms)
    if traced:
        TRACED(label, elapsed_ms)


def count(label: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``label`` of :data:`TRACED` while a profiler
    records; else nothing beyond one attribute read."""
    if _profiler._is_profiler_enabled:
        TRACED.count(label, n)


class Timings:
    """Accumulating sink: label -> [durations_ms] (observability hook).

    A label ``"<span>/<part>"`` is a named part of the span ``<span>``, timed
    inside it: it goes to :attr:`parts` (span -> part -> [durations_ms]),
    not to :attr:`records`, so a span's parts add up to no more than the
    span itself.  A learn's sink (``CSVM.timings``) gets its ``setup`` and
    ``cg`` spans, which do not overlap; :data:`TRACED` also gets the root
    spans ``learn`` and ``predict``, which contain them.  :attr:`counters`
    holds the counters (label -> total, :meth:`count`)."""

    def __init__(self) -> None:
        self.records: dict[str, list[float]] = {}
        self.parts: dict[str, dict[str, list[float]]] = {}
        self.counters: dict[str, int] = {}

    def __call__(self, label: str, elapsed_ms: float) -> None:
        name, sep, part = label.partition("/")
        if sep:
            self.parts.setdefault(name, {}).setdefault(part, []).append(elapsed_ms)
        else:
            self.records.setdefault(label, []).append(elapsed_ms)

    def count(self, label: str, n: int = 1) -> None:
        self.counters[label] = self.counters.get(label, 0) + n

    def clear(self) -> None:
        self.__init__()

    def summary(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self.records.items()}

    def part_summary(self, name: str) -> dict[str, float]:
        """The parts of span ``name``, each summed (empty where none was
        timed)."""
        return {k: sum(v) for k, v in self.parts.get(name, {}).items()}


#: the spans and counters of every call made while a ``torch.profiler``
#: recorded, since the process started or the last ``TRACED.clear()``
TRACED = Timings()
