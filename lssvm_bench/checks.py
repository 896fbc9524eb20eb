"""The comparison that decides ``correct``: the program's sampled outputs
judged by the float64 reference, worked out again from the benchmark's own
inputs.

Learns (per sampled learn, the worst over the sample):

- ``resid``: the true residual ``|b - A x| / |b - A 1|`` of the program's
  solution, over the larger of eps and the residual that reference CG
  reaches by the same rule (start, eps, max_iter);
- ``stop``: a learn that stopped before the cap (``max_iter``) has to have
  met eps: its true residual over eps where the iterations it reports fall
  short of the cap, else 0 (a solve cut short, or stopped at a looser eps);
- ``claim``: how far the residual the program reports (its ``delta``, the
  residuum the CLI prints) lies from the true residual of its solution;
- ``bias``: the program's bias and last alpha against the ones its own
  solution gives (``csvm.cpp:257-258``).

Predictions: ``dv``, the widest gap between the program's decision values
and the reference's for the same model, over the largest reference value."""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.lssvm import System, decision_values, dense_rows, norm


def worse(a: float, b: float) -> float:
    """The larger reading, a NaN counting as infinitely far off."""
    b = float(b)
    return math.inf if math.isnan(b) else max(a, b)


def learns(samples, dataset, config, device, spread=None) -> dict:
    """``samples``: dicts of ``cost``, ``gamma``, ``alphas``, ``bias``,
    ``delta`` (the program's outputs of one learn); ``spread``: devices
    that share the reference's kernel rows where K is not kept whole.
    Returns the worst reading of each number and, under ``details``, each
    sample's readings."""
    eps = float(config["epsilon"])
    imax = config.get("max_iter") or dataset.features
    out = {"resid": 0.0, "claim": 0.0, "bias": 0.0, "stop": 0.0}
    details = out.setdefault("details", [])
    X = dense_rows(dataset.csr, dataset.dense, device)
    for gamma in sorted({s["gamma"] for s in samples}):
        system = System(X, dataset.y, kernel=config["kernel"], gamma=gamma, device=device,
                        spread=spread)
        for s in (s for s in samples if s["gamma"] == gamma):
            C = s["cost"]
            alphas = np.asarray(s["alphas"], np.float64)
            x = system.vector(alphas[:-1])
            r0 = norm(system.residual(torch.ones_like(x), C))
            r = norm(system.residual(x, C))
            x_ref, k_ref = system.solve(C, eps, imax)[:2]
            r_ref = norm(system.residual(x_ref, C))
            resid = (r / r0) / max(r_ref / r0, eps)
            claimed = math.sqrt(s["delta"]) if s["delta"] >= 0 else math.nan
            bias = system.bias(x, C)
            gap = worse(abs(s["bias"] - bias), abs(alphas[-1] + float(torch.sum(x))))
            its = s.get("iterations")
            stop = math.inf if its is None else (r / r0) / eps if its < imax else 0.0
            row = {"cost": C, "gamma": gamma, "iterations": its,
                   "iterations_ref": k_ref, "rho": r / r0, "rho_ref": r_ref / r0,
                   "resid": resid, "claim": abs(claimed - r) / r,
                   "bias": gap / max(1.0, abs(bias)), "stop": stop}
            details.append(row)
            for k in ("resid", "claim", "bias", "stop"):
                out[k] = worse(out[k], row[k])
        del system
    return out


def predictions(samples, model, dataset, config, device) -> dict:
    """``samples``: ``(test set index, decision values)``; ``model``: the
    program's ``(alphas, bias, gamma)`` they were predicted with."""
    alphas, bias, gamma = model
    X = dense_rows(dataset.csr, dataset.dense, "cpu")
    worst = 0.0
    for k, dv in samples:
        ref = decision_values(X, alphas, bias, dataset.tests[k], kernel=config["kernel"],
                              gamma=gamma, device=device)
        worst = worse(worst, np.max(np.abs(np.asarray(dv) - ref)) / np.max(np.abs(ref)))
    return {"dv": worst}
