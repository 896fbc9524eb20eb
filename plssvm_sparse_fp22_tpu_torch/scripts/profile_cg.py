"""Where does a CG iteration of the port spend its time on the card?

The twin of the JAX repository's ``scripts/profile_cg.py``.  For each
shape (``--sizes``, default 4096 x 256 and 32768 x 256, rbf implicit,
float32) and each precision tier it times:

1. K1 alone per kernel function (rbf, linear, polynomial): CUDA events over
   ``--reps`` calls, each fed the last one's normalised output;
2. the implicit operator with its rank-1 and diagonal corrections;
3. one CG iteration, by the two-point slope (``utils/timing.slope_rate``)
   of the eps = 0 solve between two iteration caps, so set-up cancels;
4. the CG skeleton with a trivial matvec (a fixed diagonal of condition
   1e6, so that CG at eps = 0 does not converge within the caps): the
   floor of ``solver/cg.py``'s loop itself, its masked step (the chunk
   graph's slots on the card) and the host reads one chunk behind;
5. the device's idle share over one pinned solve under ``torch.profiler``:
   1 - (device time of every kernel) / (the solve's wall time), and the
   loop's chunk size ``c``, host reads, slots issued and steps executed in
   that solve; on the card also the device µs of a chunk launched after
   the loop's stop (one skipped slot; CUDA events);
6. the time to a trained model: the median wall ms of ``learn()`` to
   eps 1e-6 on two blobs of ``D + 1`` points (``--learns`` runs after a
   warm-up), each tier pinned and with the default plan.

Steps 1-4 and 6 use only interfaces that predate the device loop, so the
script also measures an older checkout of the package (copied into it);
the loop's counts are then null.

On the CPU (``--cpu``) the same steps run the plain versions, a harness
check: the profiler sees no device there and the idle share is null.
Prints a line per measurement and the JSON summary last::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.profile_cg [--cpu] [--sizes 4096x256]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import make_csvm
from ..ops.gram_matvec import make_sym_matvec
from ..ops.kernel_functions import gram_block, kernel_scalar
from ..ops.matvec import build_operator
from ..solver import cg as cg_loop
from ..solver.cg import cg_solve
from ..types import KernelType
from ..utils.timing import slope_rate
from . import _common

TIERS = ("exact", "bf16x3", "bf16cast")
#: ``PLSSVM_MATMUL_PRECISION`` that pins each tier
PINS = {"exact": "highest", "bf16x3": "high", "bf16cast": "default"}


def _sizes(text: str) -> list[tuple[int, int]]:
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",") if s]


def system(dev, D: int, f: int, seed: int = 0):
    """A random rbf system of ``D`` rows, all real (mask 1), gamma 1/f:
    ``(X, q, mask, QA_cost, cost_inv)`` on ``dev``."""
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
    xl = torch.tensor(rng.normal(size=f), dtype=torch.float32, device=dev)
    mask = torch.ones(D, device=dev)
    q = gram_block(KernelType.rbf, X, xl[None, :], gamma=1.0 / f)[:, 0]
    cost_inv = torch.tensor(1.0, device=dev)
    return X, q, mask, kernel_scalar(KernelType.rbf, xl, xl, gamma=1.0 / f) + cost_inv, cost_inv


def per_call_ms(dev, fn, v0, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` chained calls (each on the previous
    output, normalised, as the JAX script chains them), after one warm-up;
    device time by CUDA events on the card."""
    def chain():
        out = v0
        for _ in range(reps):
            out = fn(out)
            out = out / torch.linalg.vector_norm(out)
        return out

    chain()
    if dev.type != "cuda":
        return _common.wall(dev, chain) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _common.sync(dev)
    start.record()
    chain()
    end.record()
    _common.sync(dev)
    return start.elapsed_time(end) / reps


def cg_rate(dev, matvec, mask, D: int, lo: int, hi: int, trials: int) -> float:
    """CG iterations/s of ``matvec`` at eps = 0 by the two-point slope;
    every solve must run its cap (a solve that converges first would time
    its set-up, not its iterations)."""
    def run(seed, iters):
        b = torch.tensor(np.random.default_rng(seed).normal(size=D), dtype=torch.float32,
                         device=dev)
        _common.sync(dev)
        t0 = time.perf_counter()
        res = cg_solve(matvec, b, mask, 0.0, iters)
        _common.sync(dev)
        if res.iterations != iters:
            raise RuntimeError(f"CG at eps = 0 stopped after {res.iterations} of {iters} "
                               "iterations: no per-iteration time can be taken")
        return time.perf_counter() - t0, iters

    return slope_rate(run, lo, hi, trials=trials)


def loop_counts() -> dict | None:
    """A copy of ``solver.cg.counts`` (None where the solver keeps none)."""
    counts = getattr(cg_loop, "counts", None)
    return None if counts is None else dict(counts)


def loop_stats(before: dict | None, iters: int) -> dict:
    """Since ``before`` (of :func:`loop_counts`), over ``iters`` iterations:
    the loop's host reads (also per iteration), slots issued and steps
    executed, its chunk size and whether it replayed CUDA graphs; null
    where the solver keeps no counts (an older checkout)."""
    keys = ("host_reads_per_iteration", "host_reads", "slots_issued", "steps_executed",
            "chunk", "graph")
    if before is None:
        return dict.fromkeys(keys)
    now = cg_loop.counts
    reads = now["host_reads"] - before["host_reads"]
    executed = now["executed"] - before["executed"] if "executed" in before else None
    return dict(zip(keys, (reads / iters, reads, now["steps"] - before["steps"], executed,
                           cg_loop.last_run["chunk"], cg_loop.last_run["graph"])))


#: GPU clock cycles ``torch.cuda._sleep`` holds the stream for (about 25 ms
#: on an H100) while the host queues the replays to be timed behind it
_HOLD_CYCLES = 50_000_000


def stopped_chunk_us(dev, matvec, reps: int = 20) -> float | None:
    """Device µs of one chunk launched after the loop's stop, what a solve
    wastes behind its last read: the chunk graph of ``matvec``'s last loop
    (``solver.cg``) replayed ``reps`` times with ``active`` false (each
    replay zeroes its counter and runs one skipped slot: the slot kernel
    and two empty IF nodes), queued behind a device-side sleep so that the
    CUDA events time the device, not the host's launches; null on the CPU
    or where the solver builds no chunk graphs."""
    store = getattr(cg_loop, "_store_of", None)
    if dev.type != "cuda" or store is None:
        return None
    chunks = list(store(matvec).values())
    if not chunks:
        return None
    chunk = chunks[-1]
    chunk.carry.active.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    chunk.replay()  # warm
    torch.cuda._sleep(_HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        chunk.replay()
    end.record()
    _common.sync(dev)
    return start.elapsed_time(end) * 1e3 / reps


def learn_ms(dev, D: int, f: int, precision: str, learns: int) -> dict:
    """Median wall ms of ``learn()`` to eps 1e-6 on two blobs of ``D + 1``
    points (``D`` CG unknowns), rbf, gamma 1/f, float32, with
    ``PLSSVM_MATMUL_PRECISION=precision`` (empty: the default plan), after
    one warm-up learn, which captures the layout's step graphs that the
    timed learns replay (``solver.cg.layout``); and its iteration count."""
    X, y = _common.two_blobs(D + 1, f)
    svm = make_csvm(_common.parameter(X, y, kernel=KernelType.rbf, gamma=1.0 / f,
                                      epsilon=1e-6, max_iter=1000, dtype=np.float32,
                                      backend=_common.backend_of(dev)))
    with _common.environ(PLSSVM_MATMUL_PRECISION=precision or None):
        svm.learn()
        times = sorted(_common.wall(dev, svm.learn) for _ in range(learns))
    return {"learn_ms": times[len(times) // 2] * 1e3,
            "learn_iterations": svm.last_cg_info["iterations"]}


def idle_share(dev, matvec, mask, D: int, iters: int) -> dict:
    """One eps = 0 solve of ``iters`` iterations under ``torch.profiler``:
    its wall ms, the device ms of every kernel it ran, the idle share
    ``1 - device / wall`` (null where the profiler saw no device time), and
    the loop's :func:`loop_stats`, then :func:`stopped_chunk_us`."""
    from torch.profiler import ProfilerActivity, profile

    b = torch.ones(D, device=dev)
    cg_solve(matvec, b, mask, 0.0, iters)  # warm-up
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _common.sync(dev)
    before = loop_counts()
    with profile(activities=activities) as prof:
        secs = _common.wall(dev, lambda: cg_solve(matvec, b, mask, 0.0, iters))
    stats = loop_stats(before, iters)
    busy_us = 0.0
    if dev.type == "cuda":
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            busy_us += getattr(ev, "self_cuda_time_total", 0) if us is None else us
    wall_ms = secs * 1e3
    busy_ms = busy_us / 1e3
    return {"cg_wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_us else None,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_us else None, **stats,
            "stopped_chunk_us": stopped_chunk_us(dev, matvec)}


def _num(x, spec: str) -> str:
    return "n/a" if x is None else format(x, spec)


def profile_shape(dev, D: int, f: int, reps: int, lo: int, hi: int, trials: int,
                  learns: int) -> dict:
    backend = _common.backend_of(dev)
    X, q, mask, QA, cost_inv = system(dev, D, f)
    v0 = torch.tensor(np.random.default_rng(1).normal(size=D), dtype=torch.float32, device=dev)
    out = {"rows": D, "features": f, "tiers": {}}
    # condition 1e6: CG at eps = 0 keeps going far past the caps
    diag = torch.logspace(0, 6, D, dtype=torch.float32, device=dev)
    before = loop_counts()
    skeleton = cg_rate(dev, lambda v: diag * v, mask, D, lo, hi, trials)
    out["skeleton_it_per_s"] = skeleton
    # the rate's solves: the warm-up at lo, then per trial one at lo and one at hi
    stats = loop_stats(before, lo + trials * (lo + hi))
    out.update({f"skeleton_{k}": v for k, v in stats.items()})
    print(f"[{D} x {f}] CG skeleton (trivial matvec): {1e6 / skeleton:9.1f} us per iteration, "
          f"{_num(stats['host_reads_per_iteration'], '.3f')} host reads per iteration, chunk "
          f"{stats['chunk']}, graph {stats['graph']}", flush=True)
    for tier in TIERS:
        rec = {}
        for kernel in (KernelType.rbf, KernelType.linear, KernelType.polynomial):
            mv = make_sym_matvec(kernel, X, degree=3, gamma=1.0 / f, coef0=0.0, tier=tier)
            rec[f"k1_{kernel.name}_ms"] = per_call_ms(dev, mv, v0, reps)
        op = build_operator(KernelType.rbf, X, q, mask, QA, cost_inv, gamma=1.0 / f,
                            mode="implicit", backend=backend, precision=tier)
        rec["operator_ms"] = per_call_ms(dev, op.matvec, v0, reps)
        rec["cg_it_per_s"] = cg_rate(dev, op.matvec, mask, D, lo, hi, trials)
        rec["cg_iteration_ms"] = 1e3 / rec["cg_it_per_s"]
        rec.update(idle_share(dev, op.matvec, mask, D, hi))
        rec.update(learn_ms(dev, D, f, PINS[tier], learns))
        out["tiers"][tier] = rec
        idle = rec["idle_share"]
        print(f"[{D} x {f} {tier:8s}] K1 rbf {rec['k1_rbf_ms']:.4f} / linear "
              f"{rec['k1_linear_ms']:.4f} / poly {rec['k1_polynomial_ms']:.4f} ms, operator "
              f"{rec['operator_ms']:.4f} ms, CG iteration {rec['cg_iteration_ms']:.4f} ms "
              f"({rec['cg_it_per_s']:.1f} it/s), idle share "
              f"{_num(idle, '.3f')}; pinned {hi}-iteration solve: chunk {rec['chunk']}, "
              f"{rec['host_reads']} host reads, {rec['slots_issued']} slots issued, "
              f"{rec['steps_executed']} steps executed, graph {rec['graph']}, a chunk "
              f"after the stop {_num(rec['stopped_chunk_us'], '.3f')} us; learn() to "
              f"1e-6 {rec['learn_ms']:.2f} ms ({rec['learn_iterations']} iterations)",
              flush=True)
    plan = learn_ms(dev, D, f, "", learns)
    out.update({f"plan_{k}": v for k, v in plan.items()})
    print(f"[{D} x {f}] learn() to 1e-6 with the default plan: {plan['learn_ms']:.2f} ms "
          f"({plan['learn_iterations']} iterations)", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="plain versions on the CPU")
    parser.add_argument("--sizes", default="4096x256,32768x256",
                        help="comma-separated DxF shapes (default: 4096x256,32768x256)")
    parser.add_argument("--reps", type=int, default=64, help="calls per kernel timing")
    parser.add_argument("--caps", default="32,128", help="the slope's two iteration caps")
    parser.add_argument("--trials", type=int, default=3, help="slope samples (median)")
    parser.add_argument("--learns", type=int, default=3, help="timed learns (median)")
    args = parser.parse_args(argv)
    dev = _common.device(args.cpu)
    lo, hi = (int(c) for c in args.caps.split(","))
    shapes = [profile_shape(dev, D, f, args.reps, lo, hi, args.trials, args.learns)
              for D, f in _sizes(args.sizes)]
    return _common.emit({"metric": "cg_profile", "platform": dev.type,
                         "card": _common.card(dev), "caps": [lo, hi], "shapes": shapes})


if __name__ == "__main__":
    main()
