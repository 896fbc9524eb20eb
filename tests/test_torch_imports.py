"""The port never imports JAX.

This process has JAX loaded already (``conftest.py``), so the check runs in
a fresh interpreter: import the package and every module of the slice, then
list what ``sys.modules`` holds of ``jax``, ``jaxlib`` and the JAX package.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "plssvm_sparse_fp22_tpu_torch",
    "plssvm_sparse_fp22_tpu_torch.exceptions",
    "plssvm_sparse_fp22_tpu_torch.version",
    "plssvm_sparse_fp22_tpu_torch.types",
    "plssvm_sparse_fp22_tpu_torch.constants",
    "plssvm_sparse_fp22_tpu_torch.params",
    "plssvm_sparse_fp22_tpu_torch.io.fmtlib",
    "plssvm_sparse_fp22_tpu_torch.io.file_reader",
    "plssvm_sparse_fp22_tpu_torch.io.libsvm",
    "plssvm_sparse_fp22_tpu_torch.io.arff",
    "plssvm_sparse_fp22_tpu_torch.io.model",
    "plssvm_sparse_fp22_tpu_torch.io.native",
    "plssvm_sparse_fp22_tpu_torch.utils.assertions",
    "plssvm_sparse_fp22_tpu_torch.ops.kernel_functions",
    "plssvm_sparse_fp22_tpu_torch.ops.gram_matvec",
    "plssvm_sparse_fp22_tpu_torch.ops._build",
    "plssvm_sparse_fp22_tpu_torch.ops.matvec",
    "plssvm_sparse_fp22_tpu_torch.ops.sparse",
    "plssvm_sparse_fp22_tpu_torch.solver.cg",
    "plssvm_sparse_fp22_tpu_torch.models.base",
    "plssvm_sparse_fp22_tpu_torch.models.sparse_learn",
    "plssvm_sparse_fp22_tpu_torch.models.factory",
    "plssvm_sparse_fp22_tpu_torch.cli.train",
    "plssvm_sparse_fp22_tpu_torch.cli.predict",
]

PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "plssvm_sparse_fp22_tpu")))
"""


def _run(*modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_port_imports_no_jax():
    assert _run(*MODULES) == "[]"


def test_a_cli_run_imports_no_jax(tmp_path):
    """Train and predict through the CLIs in the fresh interpreter too, on
    dense data and on data that takes the sparse path."""
    data = os.path.join(ROOT, "tests", "data", "reference", "libsvm", "5x4.libsvm")
    sparse = os.path.join(ROOT, "tests", "data", "reference", "libsvm", "5x4.sparse.libsvm")
    model, out = str(tmp_path / "m.model"), str(tmp_path / "p.predict")
    probe = (
        "import sys\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.train import main as t\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.predict import main as p\n"
        f"assert t(['-q', '-t', '2', {data!r}, {model!r}]) == 0\n"
        f"assert p(['-q', {data!r}, {model!r}, {out!r}]) == 0\n"
        f"assert t(['-q', '-t', '2', {sparse!r}, {model!r}]) == 0\n"
        f"assert p(['-q', {sparse!r}, {model!r}, {out!r}]) == 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'plssvm_sparse_fp22_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
