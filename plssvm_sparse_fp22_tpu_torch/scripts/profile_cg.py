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
   floor that the BLAS-1 and the per-iteration host synchronisation of
   ``solver/cg.py`` set;
5. the device's idle share over one pinned solve under ``torch.profiler``:
   1 - (device time of every kernel) / (the solve's wall time).

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

from ..ops.gram_matvec import make_sym_matvec
from ..ops.kernel_functions import gram_block, kernel_scalar
from ..ops.matvec import build_operator
from ..solver.cg import cg_solve
from ..types import KernelType
from ..utils.timing import slope_rate
from . import _common

TIERS = ("exact", "bf16x3", "bf16cast")


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


def idle_share(dev, matvec, mask, D: int, iters: int) -> dict:
    """One eps = 0 solve of ``iters`` iterations under ``torch.profiler``:
    its wall ms, the device ms of every kernel it ran, and the idle share
    ``1 - device / wall`` (null where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    b = torch.ones(D, device=dev)
    cg_solve(matvec, b, mask, 0.0, iters)  # warm-up
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _common.sync(dev)
    with profile(activities=activities) as prof:
        secs = _common.wall(dev, lambda: cg_solve(matvec, b, mask, 0.0, iters))
    busy_us = 0.0
    if dev.type == "cuda":
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            busy_us += getattr(ev, "self_cuda_time_total", 0) if us is None else us
    wall_ms = secs * 1e3
    busy_ms = busy_us / 1e3
    return {"cg_wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_us else None,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_us else None}


def profile_shape(dev, D: int, f: int, reps: int, lo: int, hi: int, trials: int) -> dict:
    backend = _common.backend_of(dev)
    X, q, mask, QA, cost_inv = system(dev, D, f)
    v0 = torch.tensor(np.random.default_rng(1).normal(size=D), dtype=torch.float32, device=dev)
    out = {"rows": D, "features": f, "tiers": {}}
    # condition 1e6: CG at eps = 0 keeps going far past the caps
    diag = torch.logspace(0, 6, D, dtype=torch.float32, device=dev)
    skeleton = cg_rate(dev, lambda v: diag * v, mask, D, lo, hi, trials)
    out["skeleton_it_per_s"] = skeleton
    print(f"[{D} x {f}] CG skeleton (trivial matvec): {1e6 / skeleton:9.1f} us per iteration",
          flush=True)
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
        out["tiers"][tier] = rec
        idle = rec["idle_share"]
        print(f"[{D} x {f} {tier:8s}] K1 rbf {rec['k1_rbf_ms']:.4f} / linear "
              f"{rec['k1_linear_ms']:.4f} / poly {rec['k1_polynomial_ms']:.4f} ms, operator "
              f"{rec['operator_ms']:.4f} ms, CG iteration {rec['cg_iteration_ms']:.4f} ms "
              f"({rec['cg_it_per_s']:.1f} it/s), idle share "
              f"{'n/a' if idle is None else f'{idle:.3f}'}", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="plain versions on the CPU")
    parser.add_argument("--sizes", default="4096x256,32768x256",
                        help="comma-separated DxF shapes (default: 4096x256,32768x256)")
    parser.add_argument("--reps", type=int, default=64, help="calls per kernel timing")
    parser.add_argument("--caps", default="32,128", help="the slope's two iteration caps")
    parser.add_argument("--trials", type=int, default=3, help="slope samples (median)")
    args = parser.parse_args(argv)
    dev = _common.device(args.cpu)
    lo, hi = (int(c) for c in args.caps.split(","))
    shapes = [profile_shape(dev, D, f, args.reps, lo, hi, args.trials)
              for D, f in _sizes(args.sizes)]
    return _common.emit({"metric": "cg_profile", "platform": dev.type,
                         "card": _common.card(dev), "caps": [lo, hi], "shapes": shapes})


if __name__ == "__main__":
    main()
