"""The one general traffic generator: it reads a traffic mix (a JSON file
of parameters under ``traffic/``) and drives the program through its public
API, a closed loop of fresh ``CSVM.learn()`` calls over a (C, gamma) grid
or of ``CSVM.predict()`` calls over whole test sets.  Each call is timed on
the host's clock; every call ends in a read of its result on the host."""

from __future__ import annotations

import random
import time

import numpy as np


class Sampler:
    """One answer per key, drawn uniformly from the seed among the calls of
    that key (reservoir sampling): what the reference judges."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, key, make):
        self.seen[key] = self.seen.get(key, 0) + 1
        if self.rng.randrange(self.seen[key]) == 0:
            self.kept[key] = make()


class Traffic:
    """Base of the two kinds; ``program`` builds an estimator from a
    ``(cost, gamma)`` pair (the program's ``make_csvm`` or the control)."""

    def __init__(self, mix: dict, config: dict, dataset, program, seed: int):
        self.mix, self.config, self.ds, self.program = mix, config, dataset, program
        self.base = 1.0 / dataset.features if config.get("gamma_per_feature") else 1.0
        self.sampler = Sampler(seed)
        self.learn_infos: list = []

    def learn_one(self, cost: float, gamma: float, timings=None):
        svm = self.program(cost, gamma)
        svm.timings = timings
        t = time.perf_counter()
        svm.learn()
        dt = time.perf_counter() - t
        info = {"iterations": svm.last_cg_info.get("iterations"),
                "executed": svm.last_cg_loop.get("executed")}
        if timings is not None:
            info.update({k: sum(v) for k, v in timings.records.items()})
        return svm, dt, info

    @staticmethod
    def outputs(svm, cost, gamma) -> dict:
        return {"cost": cost, "gamma": gamma, "alphas": np.array(svm.alphas, np.float64),
                "bias": float(svm.bias_), "delta": float(svm.last_cg_info["delta"]),
                "iterations": svm.last_cg_info.get("iterations")}


class Learns(Traffic):
    """``kind: learn``: the grid's points, gamma outer and C inner (one
    gamma's learns in a row, as a grid search runs them)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.points = [(float(c), float(g) * self.base)
                       for g in self.mix["gamma"] for c in self.mix["cost"]]

    def warm(self) -> None:
        """Every shape the window uses: one learn per gamma at the largest C
        (the most iterations, the tier plan's escalation), or the
        configuration's ``warm_learns`` where no shape depends on gamma."""
        cmax = max(c for c, _ in self.points)
        gammas = sorted({g for _, g in self.points})
        for g in gammas[: int(self.config.get("warm_learns", len(gammas)))]:
            self.learn_one(cmax, g)

    def call(self, i: int, timings=None) -> float:
        cost, gamma = self.points[i % len(self.points)]
        svm, dt, info = self.learn_one(cost, gamma, timings)
        self.learn_infos.append(info)
        self.sampler.offer((cost, gamma), lambda: self.outputs(svm, cost, gamma))
        return dt

    def answers(self) -> list:
        return list(self.sampler.kept.values())


class Predicts(Traffic):
    """``kind: predict``: one model trained in set-up; each call predicts a
    whole test set, the sets cycled."""

    def warm(self) -> None:
        cost, gamma = float(self.mix["cost"]), float(self.mix["gamma"]) * self.base
        self.svm, _, info = self.learn_one(cost, gamma)
        self.trained = self.outputs(self.svm, cost, gamma)
        for test in self.ds.tests:
            self.svm.predict(test)

    def call(self, i: int, timings=None) -> float:
        k = i % len(self.ds.tests)
        t = time.perf_counter()
        dv = self.svm.predict(self.ds.tests[k])
        dt = time.perf_counter() - t
        self.sampler.offer(k, lambda: np.array(dv, np.float64))
        return dt

    def answers(self) -> list:
        return sorted(self.sampler.kept.items())

    def release(self) -> None:
        self.svm = None


KINDS = {"learn": Learns, "predict": Predicts}


def window(traffic: Traffic, seconds: float, trace_timings=None, first: int = 0):
    """The measured window: calls until ``seconds`` have passed, the call
    in flight then finished and counted, the first one the mix's call
    ``first``.  Returns ``(window_s, call_s, failed)``."""
    call_s, failed, i = [], 0, first
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        try:
            call_s.append(traffic.call(i, trace_timings() if trace_timings else None))
        except Exception:  # a failed call counts against those attempted
            import traceback

            traceback.print_exc()
            failed += 1
            call_s.append(None)
        i += 1
        if time.perf_counter() >= deadline:
            break
    return time.perf_counter() - start, call_s, failed
