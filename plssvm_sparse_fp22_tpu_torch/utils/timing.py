"""Scoped timers and profiler integration.

Equivalent of the reference's inline ``std::chrono`` spans (SURVEY.md §5:
parse time ``parameter.cpp:168-175``, setup ``csvm.cpp:247-250``,
per-CG-iteration ``gpu_csvm.cpp:234-241``, predict ``gpu_csvm.cpp:121-124``,
model write ``csvm.cpp:197-203``) and of the JAX package's
``utils/timing.py``, plus a ``torch.profiler`` trace capture.

CUDA launches are asynchronous: a span that only reads the host's clock
times the enqueue.  :func:`scoped_timer` therefore takes the device whose
work it spans and synchronises it before each reading of the clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the block (host and, where a
    CUDA device is visible, device activity) and write it as a Chrome trace
    ``trace.json`` into ``log_dir`` (open in ``chrome://tracing`` or
    Perfetto); no-op when ``log_dir`` is ``None``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


def span(sink, label: str, device=None):
    """A :func:`scoped_timer` into ``sink`` that prints nothing, or nothing
    at all (no synchronisation either) where ``sink`` is ``None``."""
    if sink is None:
        return contextlib.nullcontext()
    return scoped_timer(label, print_info=False, sink=sink, device=device)


class Timings:
    """Accumulating sink: label -> [durations_ms] (observability hook).

    A label ``"<span>/<part>"`` is a named part of the span ``<span>``, timed
    inside it: it goes to :attr:`parts` (span -> part -> [durations_ms]),
    not to :attr:`records`, so a span's parts add up to no more than the
    span itself and the spans in :attr:`records` do not overlap."""

    def __init__(self) -> None:
        self.records: dict[str, list[float]] = {}
        self.parts: dict[str, dict[str, list[float]]] = {}

    def __call__(self, label: str, elapsed_ms: float) -> None:
        name, sep, part = label.partition("/")
        if sep:
            self.parts.setdefault(name, {}).setdefault(part, []).append(elapsed_ms)
        else:
            self.records.setdefault(label, []).append(elapsed_ms)

    def summary(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self.records.items()}

    def part_summary(self, name: str) -> dict[str, float]:
        """The parts of span ``name``, each summed (empty where none was
        timed)."""
        return {k: sum(v) for k, v in self.parts.get(name, {}).items()}
