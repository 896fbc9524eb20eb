"""The traced run's reduction: from ``torch.profiler``'s events, held in
memory, to the device's busy time, its idle gaps named by what the host was
doing, the device operations that took most time, and each device's
time-ordered kernels for the roofline readers.  Nothing is written to
disk."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "lssvm_bench.window"
#: idle gaps shorter than this are counted in the idle share but not named
NAMED_GAP_S = 5e-6


@dataclass
class Trace:
    """What the readers take from a traced window: its length, each
    device's busy seconds, kernels ``(name, start_s, end_s)`` in time
    order, and the breakdown."""

    window_s: float
    busy_s: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@contextlib.contextmanager
def window():
    """The measured window as a host annotation the reduction finds."""
    with torch.profiler.record_function(WINDOW):
        yield


def _events(prof):
    """``(name, device_type, device_index, thread, start_ns, end_ns)`` of
    every event, from the profiler's raw results (no event tree built).
    Annotations mirrored onto the device's timeline are no device work and
    are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if "CUDA" in str(e.device_type()) else "cpu"
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if dev == "cuda" and (e.name() == WINDOW or "annotation" in str(kind)):
            continue
        out.append((e.name(), dev, e.device_index(), e.start_thread_id(), e.start_ns(),
                    e.end_ns()))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:120]


def reduce_events(events) -> Trace:
    """The :class:`Trace` of raw events (see :func:`_events`)."""
    win = [e for e in events if e[0] == WINDOW and e[1] == "cpu"]
    if not win:
        raise RuntimeError("the traced window's annotation is not in the trace")
    w0, w1, wthread = win[0][4], win[0][5], win[0][3]
    host = sorted((e for e in events if e[1] == "cpu" and e[3] == wthread and e[0] != WINDOW
                   and w0 <= e[4] <= w1), key=lambda e: e[4])
    starts = [e[4] for e in host]
    trace = Trace(window_s=(w1 - w0) / 1e9)
    totals: dict = {}
    gaps: dict = {}
    by_device: dict = {}
    for e in events:
        if e[1] == "cuda" and e[5] > w0 and e[4] < w1:
            by_device.setdefault(e[2], []).append(e)
    for dev, evs in sorted(by_device.items()):
        evs.sort(key=lambda e: e[4])
        trace.kernels[dev] = [(e[0], e[4] / 1e9, e[5] / 1e9) for e in evs]
        for e in evs:
            name = _short(e[0])
            totals[name] = totals.get(name, 0.0) + (e[5] - e[4]) / 1e9
        busy = _union((max(e[4], w0), min(e[5], w1)) for e in evs)
        trace.busy_s[dev] = sum(e - s for s, e in busy) / 1e9
        edges = [w0] + [t for iv in busy for t in iv] + [w1]
        for s, e in zip(edges[0::2], edges[1::2]):
            if (e - s) / 1e9 < NAMED_GAP_S:
                continue
            name = _host_op(host, starts, (s + e) // 2)
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e9 / len(by_device)
    trace.device_ops = sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:10]
    trace.idle_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]
    return trace


def _host_op(host, starts, t) -> str:
    """The innermost host operation of the window's thread running at
    ``t``: the latest-starting one that has not ended (ops nest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 2000), -1):
        if host[j][5] >= t:
            return _short(host[j][0])
    return "host (no traced op)"


def reduce(prof) -> Trace:
    return reduce_events(_events(prof))
