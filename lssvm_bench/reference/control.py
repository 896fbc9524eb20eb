"""The control: the reference put in the program's place and computed in
the nearest precision below the configuration's (float32 products with
inputs rounded to TF32, the rest in float32).  It answers the calls the
timed loop makes of the program (``learn``, ``predict``) with the outputs
the checks judge, so a run of the control goes through the same window and
the same comparison as a run of the program, and has to come out not
correct."""

from __future__ import annotations

import numpy as np
import torch

from .lssvm import System, decision_values, dense_rows


class ControlSVM:
    """Stands in for one ``CSVM`` of the program: the same hyper-parameters,
    the same data, the same outputs."""

    def __init__(self, dataset, *, kernel: str, gamma: float, cost: float, epsilon: float,
                 max_iter: int | None, device, precision: str, spread=None):
        self.ds, self.kernel, self.gamma, self.cost = dataset, kernel, gamma, cost
        self.epsilon, self.device, self.precision = epsilon, device, precision
        self.spread = spread
        self.imax = max_iter if max_iter is not None else dataset.features
        self.alphas, self.bias_, self.last_cg_info, self.timings = None, 0.0, {}, None
        self.last_cg_loop = {}

    def learn(self) -> None:
        X = dense_rows(self.ds.csr, self.ds.dense, self.device)
        system = System(X, self.ds.y, kernel=self.kernel, gamma=self.gamma,
                        device=self.device, precision=self.precision, spread=self.spread)
        x, k, delta, delta0 = system.solve(self.cost, self.epsilon, self.imax)
        self.bias_ = system.bias(x, self.cost)
        xs = x.double().cpu().numpy()
        self.alphas = np.concatenate([xs, [-xs.sum()]])
        self.last_cg_info = {"iterations": k, "delta": delta, "delta0": delta0}
        self.last_cg_loop = {"executed": k}
        del system, X
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def predict(self, points) -> np.ndarray:
        X = dense_rows(self.ds.csr, self.ds.dense, "cpu")
        return decision_values(X, self.alphas, self.bias_, np.asarray(points, np.float64),
                               kernel=self.kernel, gamma=self.gamma, device=self.device,
                               precision=self.precision)
