"""The port's on-chip tools (``plssvm_sparse_fp22_tpu_torch/scripts``) on
the CPU at tiny sizes, where they run the plain versions: each returns (and
prints last) its JSON with the keys of its JAX twin in ``scripts/``.

- ``gpu_validate --cpu`` passes every check, and its check names are those
  of ``scripts/tpu_validate.py``;
- ``profile_cg``, ``precision_study`` and ``scaling_bench`` return their
  keys; the precision study's ``highest`` rows (float64) take the JAX
  ``CSVM``'s iterations and bias on the same data;
- the port's native parser builds into its own directory under a file
  lock: processes that start together on a fresh directory all load it.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import plssvm_sparse_fp22_tpu as jp
from plssvm_sparse_fp22_tpu.io.libsvm import ParsedData as JParsed

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.scripts import (_common, gpu_validate, precision_study,
                                                  profile_cg, scaling_bench)
from test_torch_model import cg_bias_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the names a format field of tpu_validate.py's check names runs over
EXPANSIONS = {"kernel.name": ("linear", "polynomial", "rbf"),
              "mode": ("linear", "cached", "implicit"), "label": ("dense", "sparse_panel")}


def _jax_check_names() -> set:
    """Every check name ``scripts/tpu_validate.py`` can print, read from its
    source: the literal first argument of each ``check(...)`` call, with
    its format fields expanded over what the script loops over."""
    with open(os.path.join(ROOT, "scripts", "tpu_validate.py")) as fh:
        src = fh.read()
    names = set()
    for name in re.findall(r'check\(\s*f?"([^"]+)"', src):
        field = re.search(r"\{([^}]+)\}", name)
        if field is None:
            names.add(name)
        else:
            names.update(name.replace(field.group(0), value)
                         for value in EXPANSIONS[field.group(1)])
    return names


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def validation():
    return gpu_validate.main(["--cpu"])


def test_gpu_validate_passes_every_check_on_the_cpu(validation):
    assert validation["failures"] == 0 and validation["failed"] == []
    assert validation["platform"] == "cpu" and validation["card"] is None
    # 21 names; the kernel, operator and panel checks at each of 3 tiers
    assert validation["checks"] == 49
    for tier, tol in gpu_validate.TIER_TOL.items():
        assert validation["max_rel_err_by_tier"][tier] <= max(tol, 5e-3)


def test_gpu_validate_checks_carry_the_jax_scripts_names(validation):
    assert set(validation["names"]) == _jax_check_names()
    assert len(validation["names"]) == 21


def test_gpu_validate_adaptive_learn_runs_both_tiers(validation):
    """The plan is forced onto the implicit mode, so its check holds the
    two-tier CG to the oracle."""
    info = validation["adaptive"]
    assert info["mode"] == "implicit"
    assert 0 < info["fast_iterations"] <= info["iterations"]


def test_gpu_validate_prints_its_json_last(capsys):
    res = gpu_validate.main(["--cpu"])
    assert _last_json(capsys) == json.loads(json.dumps(res))


def test_profile_cg_returns_its_keys(capsys):
    res = profile_cg.main(["--cpu", "--sizes", "256x16", "--reps", "2", "--caps", "2,6",
                           "--trials", "1"])
    assert _last_json(capsys)["metric"] == res["metric"] == "cg_profile"
    (shape,) = res["shapes"]
    assert (shape["rows"], shape["features"]) == (256, 16)
    assert shape["skeleton_it_per_s"] > 0
    assert set(shape["tiers"]) == {"exact", "bf16x3", "bf16cast"}
    for rec in shape["tiers"].values():
        assert {"k1_rbf_ms", "k1_linear_ms", "k1_polynomial_ms", "operator_ms", "cg_it_per_s",
                "cg_iteration_ms", "cg_wall_ms", "device_busy_ms", "idle_share", "chunk",
                "host_reads", "slots_issued", "steps_executed", "stopped_chunk_us"} <= set(rec)
        assert rec["cg_it_per_s"] > 0 and rec["operator_ms"] > 0
        # no device on the CPU: no idle share and no slot time is claimed
        assert rec["idle_share"] is None and rec["device_busy_ms"] is None
        assert rec["stopped_chunk_us"] is None
        # the profiled pinned solve of 6 iterations, eagerly: a read per step
        assert (rec["chunk"], rec["steps_executed"]) == (1, 6)
        assert rec["host_reads"] == rec["slots_issued"] == 6


N, F = 256, 16


@pytest.fixture(scope="module")
def study():
    return precision_study.main(["--cpu", "--n", str(N), "--f", str(F), "--caps", "2,6",
                                 "--trials", "1", "--max_iter", "200", "--dtype", "float64"])


def test_precision_study_returns_its_keys(study):
    assert study["metric"] == "precision_frontier" and study["dtype"] == "float64"
    cells = {(r["tier"], r["kernel"]) for r in study["results"]}
    assert cells == {(t, k) for t in ("highest", "high", "default", "plan")
                     for k in ("rbf", "polynomial", "linear")}
    for r in study["results"]:
        assert {"iterations", "converged", "accuracy_pct", "bias", "bias_delta_vs_highest",
                "alpha_max_delta_vs_highest", "alphas_head", "learn_s", "iters_per_s",
                "mode"} <= set(r)
        assert r["converged"] and r["accuracy_pct"] > 90.0 and r["iters_per_s"] > 0
        if r["tier"] == "plan":
            assert r["fast_iterations"] <= r["iterations"]
    # the torch backend's fixed tiers are exact, and float64 takes no plan
    assert max(r["alpha_max_delta_vs_highest"] for r in study["results"]) == 0.0


@pytest.mark.parametrize("kernel", ["rbf", "polynomial", "linear"])
def test_precision_study_highest_row_matches_the_jax_csvm(study, kernel):
    X, y = _common.two_blobs(N, F)
    p = jp.Parameter(kernel=jp.KernelType.from_string(kernel), gamma=1.0 / F, coef0=1.0,
                     cost=1.0, epsilon=1e-6, max_iter=200, dtype=np.float64, devices=1,
                     print_info=False)
    p.data = JParsed(csr=sp.csr_matrix(X.astype(np.float64)), values=y,
                     _dense=X.astype(np.float64))
    p.values = y
    svm = jp.make_csvm(p)
    svm.learn()
    row = next(r for r in study["results"] if (r["tier"], r["kernel"]) == ("highest", kernel))
    assert row["iterations"] == svm.last_cg_info["iterations"]
    # both stop at eps 1e-6 with the same count; their biases lie within
    # what the stopping residual allows (twice the JAX result's)
    btol = cg_bias_tolerance(X.astype(np.float64), y, p.kernel, 1.0, [svm.alphas] * 2,
                             np.float64, degree=3, gamma=1.0 / F, coef0=1.0)
    assert abs(row["bias"] - svm.bias_) <= btol


@pytest.mark.parametrize("data", ["dense", "sparse"])
def test_scaling_bench_returns_its_keys(data, capsys):
    res = scaling_bench.main(["--cpu", "--rows-per-dev", "64", "--features", "16", "--caps",
                              "2,6", "--grow-to", "0", "--data", data, "--density", "0.3"])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    suffix = "" if data == "dense" else "_sparse"
    assert res["metric"] == f"weak_scaling_rbf_implicit{suffix}_work"
    assert res["virtual_devices_share_host_cores"] is True
    assert "harness check" in res["note"]
    assert set(res["iters_per_s"]) == set(res["rows"]) == set(res["weak_efficiency"]) == {1, 2, 4}
    assert res["weak_efficiency"][1] == 1.0
    # rows ~ sqrt(p), a multiple of 8 per shard
    assert [res["rows"][p] for p in (1, 2, 4)] == [64, 96, 128]
    assert set(res["learn"].values()) == ({"implicit"} if data == "dense" else {"panel"})


def test_scaling_bench_rows_scaling_keeps_each_shards_rows():
    res = scaling_bench.main(["--cpu", "--rows-per-dev", "64", "--features", "16", "--caps",
                              "2,6", "--grow-to", "0", "--scaling", "rows", "--kernel", "linear",
                              "--mode", "linear"])
    assert res["rows"] == {1: 64, 2: 128, 4: 256}
    assert res["metric"] == "weak_scaling_linear_linear_rows"


NATIVE_PROBE = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from plssvm_sparse_fp22_tpu_torch.io import native
path = native.build_native(sys.argv[2])
lib = ctypes.CDLL(path)
assert lib.plssvm_native_parse_libsvm and lib.plssvm_native_write_model
print(path)
"""


def test_native_build_runs_once_for_processes_that_start_together(tmp_path):
    """Four processes on a fresh build directory: each loads the library
    (a half-written file would fail ``CDLL``), from the one path, and the
    directory holds the library, its stamp and the lock, no leftovers."""
    build = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", NATIVE_PROBE, ROOT, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    assert {out.strip() for out, _ in outs} == {str(build / "libplssvm_native.so")}
    assert sorted(os.listdir(build)) == ["libplssvm_native.so", "libplssvm_native.so.sha256",
                                         "lock"]
