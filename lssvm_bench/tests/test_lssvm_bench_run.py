"""The harness end to end on the CPU: each cell at a cut-down copy of its
configuration on the program's ``torch`` backend, the result line, a cell
added by new files alone, and the modules a run may load."""

import json
import hashlib
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from lssvm_bench.tests.conftest import REPO, run_cell  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def metric_names(cell, trace):
    kind = "per_layer" if trace else "end_to_end"
    return {m["name"] for m in BENCH[kind]
            if m.get("workloads") is None or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_at_a_small_size(bench_copy, cell, trace):
    rc, res, err = run_cell(bench_copy, cell, trace=trace, seconds=3.0)
    assert rc == 0, err[-3000:]
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, check in res["checks"].items():
        assert check["value"] <= check["limit"], name
        assert f"check {name} " in err
    want = metric_names(cell, trace)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and "breakdown" in res
        # a CPU run has no device trace: only the program's spans and counters
        want = {n for n in want if not ("roofline" in n or n.startswith("device_idle"))}
    assert want <= set(res["metrics"]), (want, res["metrics"])
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_no_chip_no_result(bench_copy):
    env = dict(os.environ, PYTHONPATH=f"{bench_copy}{os.pathsep}{REPO}", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "lssvm_bench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=bench_copy,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "lssvm_bench", tmp_path / "lssvm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = subprocess.run([sys.executable, "-m", "lssvm_bench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(bench_copy):
    """A configuration, a traffic mix, a metric and the cell's limits added as
    new files, with new entries in BENCHMARK.json: no existing file edited."""
    before = digest(bench_copy / "lssvm_bench")
    pkg = bench_copy / "lssvm_bench"
    cfg = json.loads((pkg / "configs" / "ijcnn1-rbf.json").read_text())
    cfg.update(name="toy-rbf", rows=300, features=9, test_rows=0)
    cfg["data"] = dict(cfg["data"], one_hot=3)
    (pkg / "configs" / "toy-rbf.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "pair.json").write_text(json.dumps(
        {"kind": "learn", "cost": [0.5, 2.0], "gamma": [1.0], "warm": "one_per_gamma"}))
    (pkg / "metrics" / "learns_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx['call_s']))\n")
    (pkg / "limits" / "toy-rbf.pair.json").write_text(
        json.dumps({"resid": 100.0, "stop": 3.0, "claim": 1.0, "bias": 1e-3}))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-rbf", "source": "https://example.org/toy",
                             "file": "lssvm_bench/configs/toy-rbf.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "toy-rbf.pair", "config": "toy-rbf",
                               "traffic": "pair", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "learns_done", "unit": "learns", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["toy-rbf.pair"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(bench_copy, "toy-rbf.pair")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert res["metrics"]["learns_done"]["value"] == res["attempted"]
    after = digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


FORBIDDEN = {"jax", "jaxlib", "flax", "plssvm_sparse_fp22_tpu"}
PROBE = """
import sys, json
import {mods}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level_after(mods):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = top_level_after("lssvm_bench.run, lssvm_bench.loop, lssvm_bench.trace, "
                           "lssvm_bench.checks, lssvm_bench.data.dense_classes, "
                           "lssvm_bench.data.sparse_docs, plssvm_sparse_fp22_tpu_torch")
    assert not tops & FORBIDDEN  # whole names: the port's begins with the JAX package's


def test_the_reference_loads_nothing_of_the_program():
    tops = top_level_after("lssvm_bench.reference.lssvm, lssvm_bench.reference.control, "
                           "lssvm_bench.checks")
    assert not tops & (FORBIDDEN | {"plssvm_sparse_fp22_tpu_torch"})


def test_a_loaded_jax_refuses_the_result(bench_copy, tmp_path):
    """A module named ``jax`` in the process once the window has closed: no
    result, a nonzero exit, the module named on standard error."""
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "jax.py").write_text("")
    (fake / "sitecustomize.py").write_text("import jax\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(fake), str(bench_copy), str(REPO)]))
    p = subprocess.run([sys.executable, "-m", "lssvm_bench.run", "--workload", CELLS[0],
                        "--seed", "5", "--seconds", "0.5", "--trace", "0", "--cpu"],
                       cwd=bench_copy, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "jax" in p.stderr
