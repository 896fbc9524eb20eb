"""Precision and throughput of the port's tiers, learn by learn.

The twin of the JAX repository's ``scripts/precision_study.py``.  For each
fixed tier (``PLSSVM_MATMUL_PRECISION`` = ``highest`` exact, ``high``
bf16x3, ``default`` bf16cast) and for the default adaptive plan (the
variable unset on the card; ``adaptive`` on the CPU, where the plan is off
by default), and for each kernel (rbf, polynomial, linear), one learn
through ``make_csvm`` on the JAX study's two-blob data (n x f, seed 11,
gamma 1/f, coef0 1, C 1, eps 1e-6) records:

- CG iterations to eps, whether the residual met the target, training
  accuracy, bias, and ``|bias - bias(highest)|`` and
  ``max|alpha - alpha(highest)|``;
- ``learn()`` seconds (after a warm-up learn);
- CG iterations/s by the two-point slope of eps = 0 learns between two
  iteration caps (``utils/timing.slope_rate``);
- on the plan's rows, the fast-tier and total iterations and whether the
  learn escalated.

The port reads the variable per call, so every cell runs in this one
process (the JAX study starts a child process per cell).  On the card the
``linear`` kernel's default is the fixed ``highest`` tier, not the plan
(``ops/matvec.resolve_mxu_plan``), so its plan row is that tier's learn::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.precision_study [--cpu] [--n 4096] [--f 256]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import make_csvm
from ..types import KernelType
from ..utils.timing import slope_rate
from . import _common

#: the plan's row, beside the fixed tiers' (the JAX package's precision
#: names: ``highest``, ``high``, ``default``)
PLAN = "plan"


def _learn(dev, X, y, kernel, precision, dtype, **kw):
    """One learn at ``precision`` (a fixed tier's name, or ``plan``)."""
    env = {"PLSSVM_MATMUL_PRECISION": precision}
    if precision == PLAN:
        # the default plan on the card; forced where the backend runs none
        env["PLSSVM_MATMUL_PRECISION"] = None if dev.type == "cuda" else "adaptive"
    f = X.shape[1]
    params = {"kernel": kernel, "gamma": 1.0 / f, "coef0": 1.0, "cost": 1.0,
              "epsilon": 1e-6, "dtype": dtype, "backend": _common.backend_of(dev), **kw}
    with _common.environ(**env):
        svm = make_csvm(_common.parameter(X, y, **params))
        secs = _common.wall(dev, svm.learn)
    return svm, secs


def cell(dev, X, y, kernel, precision, dtype, caps, trials, max_iter=None) -> dict:
    kw = {} if max_iter is None else {"max_iter": max_iter}
    _learn(dev, X, y, kernel, precision, dtype, **kw)  # warm-up: build, load, first launches
    svm, learn_s = _learn(dev, X, y, kernel, precision, dtype, **kw)
    info = svm.last_cg_info

    def run(seed, iters):
        s, secs = _learn(dev, X, y, kernel, precision, dtype, epsilon=0.0, max_iter=iters)
        return secs, s.last_cg_info["iterations"]

    rec = {"tier": precision, "kernel": kernel.name, "mode": info["mode"],
           "iterations": info["iterations"],
           "converged": bool(info["delta"] <= 1e-12 * info["delta0"]),
           "accuracy_pct": 100.0 * svm.accuracy(), "bias": svm.bias_,
           "alphas": svm.alphas, "learn_s": learn_s,
           "iters_per_s": slope_rate(run, *caps, trials=trials)}
    if precision == PLAN:
        rec.update(fast_iterations=info["fast_iterations"], escalated=info["escalated"])
    return rec


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="plain versions on the CPU")
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--f", type=int, default=256)
    parser.add_argument("--kernels", default="rbf,polynomial,linear")
    parser.add_argument("--tiers", default="highest,high,default,plan")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--max_iter", type=int, default=None,
                        help="CG's cap (default: the feature count, as the train CLI's)")
    parser.add_argument("--caps", default="32,128", help="the slope's two iteration caps")
    parser.add_argument("--trials", type=int, default=3)
    args = parser.parse_args(argv)
    dev = _common.device(args.cpu)
    X, y = _common.two_blobs(args.n, args.f)
    caps = tuple(int(c) for c in args.caps.split(","))
    dtype = np.dtype(args.dtype).type
    tiers = args.tiers.split(",")
    if "highest" in tiers:  # the reference row first
        tiers = ["highest"] + [t for t in tiers if t != "highest"]
    results = []
    for tier in tiers:
        for name in args.kernels.split(","):
            rec = cell(dev, X, y, KernelType.from_string(name), tier, dtype, caps, args.trials,
                       args.max_iter)
            results.append(rec)
            extra = (f" fast={rec['fast_iterations']} escalated={rec['escalated']}"
                     if tier == PLAN else "")
            print(f"{tier:8s} {name:11s} iters={rec['iterations']:4d} "
                  f"acc={rec['accuracy_pct']:7.3f}% rate={rec['iters_per_s']:10.2f}/s "
                  f"learn={rec['learn_s']:.4f}s bias={rec['bias']:+.6e}{extra}", flush=True)
    base = {r["kernel"]: r for r in results if r["tier"] == "highest"}
    for r in results:
        b = base.get(r["kernel"])
        if b is not None:
            r["bias_delta_vs_highest"] = abs(r["bias"] - b["bias"])
            r["alpha_max_delta_vs_highest"] = float(np.max(np.abs(r["alphas"] - b["alphas"])))
    for r in results:
        r["alphas_head"] = [float(a) for a in r.pop("alphas")[:4]]
    return _common.emit({"metric": "precision_frontier", "platform": dev.type,
                         "card": _common.card(dev), "n": args.n, "f": args.f,
                         "dtype": args.dtype, "caps": list(caps), "results": results})


if __name__ == "__main__":
    main()
