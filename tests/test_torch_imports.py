"""The port never imports JAX.

This process has JAX loaded already (``conftest.py``), so the check runs in
a fresh interpreter: import the package and every module of the slice, then
list what ``sys.modules`` holds of ``jax``, ``jaxlib`` and the JAX package.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _port_modules():
    """Every module of the port, found by walking its tree, so a new module
    is covered without being listed."""
    pkg = "plssvm_sparse_fp22_tpu_torch"
    names = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, pkg)):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build", "csrc"))
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for name in sorted(filenames):
            if name == "__init__.py":
                names.append(rel)
            elif name.endswith(".py"):
                names.append(f"{rel}.{name[:-3]}")
    return names


MODULES = _port_modules()
#: what this slice and the earlier ones added must be among them
EXPECTED = {
    "plssvm_sparse_fp22_tpu_torch", "plssvm_sparse_fp22_tpu_torch.params",
    "plssvm_sparse_fp22_tpu_torch.io.model", "plssvm_sparse_fp22_tpu_torch.ops.gram_matvec",
    "plssvm_sparse_fp22_tpu_torch.ops._build", "plssvm_sparse_fp22_tpu_torch.ops.sparse",
    "plssvm_sparse_fp22_tpu_torch.solver.cg", "plssvm_sparse_fp22_tpu_torch.solver.checkpoint",
    "plssvm_sparse_fp22_tpu_torch.models.base", "plssvm_sparse_fp22_tpu_torch.models.sparse_learn",
    "plssvm_sparse_fp22_tpu_torch.parallel", "plssvm_sparse_fp22_tpu_torch.parallel.mesh",
    "plssvm_sparse_fp22_tpu_torch.parallel.sharded",
    "plssvm_sparse_fp22_tpu_torch.parallel.distributed",
    "plssvm_sparse_fp22_tpu_torch.utils.timing",
    "plssvm_sparse_fp22_tpu_torch.utils.oracle", "plssvm_sparse_fp22_tpu_torch.utils.assertions",
    "plssvm_sparse_fp22_tpu_torch.cli.train", "plssvm_sparse_fp22_tpu_torch.cli.predict",
    "plssvm_sparse_fp22_tpu_torch.cli.detect", "plssvm_sparse_fp22_tpu_torch.cli.generate_data",
    "plssvm_sparse_fp22_tpu_torch.io.native", "plssvm_sparse_fp22_tpu_torch.scripts",
    "plssvm_sparse_fp22_tpu_torch.scripts.gpu_validate",
    "plssvm_sparse_fp22_tpu_torch.scripts.profile_cg",
    "plssvm_sparse_fp22_tpu_torch.scripts.precision_study",
    "plssvm_sparse_fp22_tpu_torch.scripts.comms_check",
    "plssvm_sparse_fp22_tpu_torch.scripts.scaling_bench",
    "plssvm_sparse_fp22_tpu_torch.scripts.gen_apidoc",
    "plssvm_sparse_fp22_tpu_torch.scripts.gen_man",
}

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
    assert EXPECTED <= set(MODULES) and len(MODULES) >= 30
    assert _run(*MODULES) == "[]"


def test_chip_smoke_imports_no_jax():
    """The GPU smoke script at the root imports (not runs) without JAX, and
    names no module of JAX or of the JAX package in an import."""
    probe = ("import importlib.util, sys\n"
             "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
             "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
             "print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'plssvm_sparse_fp22_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        lines = [ln.strip() for ln in fh if ln.strip().startswith(("import ", "from "))]
    assert not [ln for ln in lines if ln.split()[1].split(".")[0]
                in ("jax", "jaxlib", "plssvm_sparse_fp22_tpu")]


def test_a_cli_run_imports_no_jax(tmp_path):
    """Train and predict through the CLIs in the fresh interpreter too, on
    dense data and on data that takes the sparse path; then the detect and
    generate-data CLIs, a checkpointed verbose learn and a learn and predict
    over two shards."""
    data = os.path.join(ROOT, "tests", "data", "reference", "libsvm", "5x4.libsvm")
    sparse = os.path.join(ROOT, "tests", "data", "reference", "libsvm", "5x4.sparse.libsvm")
    model, out = str(tmp_path / "m.model"), str(tmp_path / "p.predict")
    gen, ckpt = str(tmp_path / "gen.libsvm"), str(tmp_path / "cg.npz")
    probe = (
        "import sys\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.train import main as t\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.predict import main as p\n"
        f"assert t(['-q', '-t', '2', {data!r}, {model!r}]) == 0\n"
        f"assert p(['-q', {data!r}, {model!r}, {out!r}]) == 0\n"
        f"assert t(['-q', '-t', '2', {sparse!r}, {model!r}]) == 0\n"
        f"assert p(['-q', {sparse!r}, {model!r}, {out!r}]) == 0\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.detect import main as d\n"
        "from plssvm_sparse_fp22_tpu_torch.cli.generate_data import main as g\n"
        "assert d(['--json']) == 0\n"
        f"assert g(['--output', {gen!r}, '--samples', '300', '--features', '4']) == 0\n"
        f"assert t(['-q', '-t', '2', '--checkpoint', {ckpt!r}, '--verbose_cg', {gen!r}, "
        f"{model!r}]) == 0\n"
        "import os\n"
        "os.environ['PLSSVM_DEVICES'] = '2'\n"
        f"assert t(['-q', '-t', '2', {gen!r}, {model!r}]) == 0\n"
        f"assert p(['-q', {gen!r}, {model!r}, {out!r}]) == 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'plssvm_sparse_fp22_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_suite_collects_without_torch(tmp_path):
    """Where torch is not installed (the repository's CI installs none), the
    suite still collects: every ``tests/test_torch_*.py`` skips at import,
    and the JAX package's tests are collected as before.  A stub ``torch``
    package first on the path raises what an interpreter without torch
    raises."""
    stub = tmp_path / "torch"
    stub.mkdir()
    (stub / "__init__.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'torch'\", name='torch')\n")
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-m", "pytest", "--collect-only", "-q",
                           "-p", "no:cacheprovider", "tests"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    summary = out.strip().splitlines()[-1]
    assert "tests collected" in summary and "error" not in summary, summary
    assert "ERROR collecting" not in out and "Interrupted" not in out, out
    ids = [ln for ln in out.splitlines() if "::" in ln]
    assert ids and not [ln for ln in ids if ln.startswith("tests/test_torch_")]
