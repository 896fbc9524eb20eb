"""Helpers of the harness's CPU tests: a copy of the benchmark, with its
configurations cut to sizes a test run holds, that ``python -m
lssvm_bench.run --cpu`` runs on the program's ``torch`` backend."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
#: per configuration: rows, features, test rows (and sparse nonzeros a row)
SMALL = {"ijcnn1-rbf": (600, 22, 700, None), "rcv1-rbf": (400, 3000, 0, 20)}


#: limits at those sizes, between the readings of sound runs and of the
#: control or the planted faults on the CPU over ten to fifteen seeds (sound
#: / control or fault): ijcnn1 bias <= 8.0e-6 / TF32 >= 8.7e-5, stop <= 0.99
#: / half the cap >= 475; its predict dv <= 2.3e-6 / TF32 >= 2.4e-4, stop <=
#: 0.89 / half the cap >= 24; rcv1 bias <= 7.7e-6 / TF32 >= 1.4e-5; resid
#: reads up to 15 in sound runs at these sizes (float32's floor on a small
#: system), so only the faults are held to it
SMALL_LIMITS = {
    "ijcnn1-rbf.grid": {"resid": 100.0, "stop": 3.0, "claim": 1.0, "bias": 2.5e-5},
    "ijcnn1-rbf.predict": {"resid": 100.0, "stop": 3.0, "claim": 1.0, "bias": 2.5e-5,
                           "dv": 1.5e-5},
    "rcv1-rbf.grid": {"resid": 100.0, "stop": 3.0, "claim": 1.0, "bias": 1.2e-5},
}


def small_config(cfg: dict) -> dict:
    rows, feats, test, nnz = SMALL[cfg["name"]]
    cfg = dict(cfg, rows=rows, features=feats, test_rows=test)
    if nnz is not None:
        cfg["data"] = dict(cfg["data"], nnz_per_row=nnz)
    return cfg


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``lssvm_bench/`` in ``tmp_path``,
    its configurations cut by :data:`SMALL`."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "lssvm_bench", tmp_path / "lssvm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    for path in (tmp_path / "lssvm_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if cfg["name"] in SMALL:
            path.write_text(json.dumps(small_config(cfg)))
    for cell, limits in SMALL_LIMITS.items():
        (tmp_path / "lssvm_bench" / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    return tmp_path


def run_cell(root: Path, workload: str, *extra, seed: int = 3000000019,
             seconds: float = 1.0, trace: int = 0, timeout: float = 300):
    """``python -m lssvm_bench.run --cpu`` from ``root``: ``(rc, last
    stdout line as JSON or None, stderr)``."""
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}", PYTHONWARNINGS="ignore",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", "lssvm_bench.run", "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
                        "--cpu", *extra], cwd=root, env=env, capture_output=True, text=True,
                       timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
