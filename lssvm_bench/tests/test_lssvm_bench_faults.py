"""The comparison that decides ``correct`` catches a broken timed path and
the control: each fault a cell can have is planted in the program under the
harness, or the reference computed at TF32 is put in the program's place,
and a whole run on the CPU has to report ``correct`` false."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch.models.base as base  # noqa: E402
import plssvm_sparse_fp22_tpu_torch.models.sparse_learn as sparse_learn  # noqa: E402
from lssvm_bench import run  # noqa: E402

LEARN_CELLS = ["ijcnn1-rbf.grid", "rcv1-rbf.grid", "ijcnn1-rbf.predict"]


@pytest.fixture(autouse=True)
def few_threads():
    """Several workers share the host: each keeps to two threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def drive(monkeypatch, capsys, bench_copy, cell, *extra, seed=3000000033, seconds=0.5):
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "unset")
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "0",
                   "--cpu", "--bench", str(bench_copy / "BENCHMARK.json"), *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def patch_solver(monkeypatch, wrap):
    orig = base.cg_solve
    monkeypatch.setattr(base, "cg_solve", wrap(orig))
    monkeypatch.setattr(sparse_learn, "cg_solve", wrap(orig))


def unchanged(orig):
    """CG returns its starting state: no step taken."""
    def solve(matvec, b, mask, eps, imax, **kw):
        return orig(matvec, b, mask, eps, 0, **kw)
    return solve


def half_left_out(orig):
    """A·v over half of the points: the other half's rows and columns left
    out of every product."""
    def solve(matvec, b, mask, eps, imax, **kw):
        keep = torch.ones_like(b)
        keep[b.numel() // 2:] = 0.0
        return orig(lambda v: matvec(v * keep) * keep, b, mask, eps, imax, **kw)
    return solve


@pytest.mark.parametrize("cell", LEARN_CELLS)
def test_sound_run_is_correct(monkeypatch, capsys, bench_copy, cell):
    assert drive(monkeypatch, capsys, bench_copy, cell)["correct"] is True


@pytest.mark.parametrize("seed", [3000000041, 3000000042, 3000000043])
@pytest.mark.parametrize("cell", LEARN_CELLS)
def test_control_is_not_correct(monkeypatch, capsys, bench_copy, cell, seed):
    # a window long enough for the whole grid: the control misses the limit
    # at some (C, gamma) only
    res = drive(monkeypatch, capsys, bench_copy, cell, "--control", "tf32", seed=seed,
                seconds=2.0)
    assert res["correct"] is False


@pytest.mark.parametrize("fault", [unchanged, half_left_out])
@pytest.mark.parametrize("cell", LEARN_CELLS)
def test_broken_solve_is_not_correct(monkeypatch, capsys, bench_copy, cell, fault):
    patch_solver(monkeypatch, fault)
    assert drive(monkeypatch, capsys, bench_copy, cell)["correct"] is False


def stop_rule(fault, cfg, features):
    """The program's stopping rule changed where the timed path reads it:
    CG cut to 3 steps or to half of its cap, or stopped at 1000 times eps."""
    imax = cfg.get("max_iter") or features
    if fault == "cut3":
        return dict(cfg, max_iter=3)
    if fault == "cut_half":
        return dict(cfg, max_iter=imax // 2)
    return dict(cfg, epsilon=float(cfg["epsilon"]) * 1000)


@pytest.mark.parametrize("fault, cell", [("loose", c) for c in LEARN_CELLS] + [
    (f, c) for f in ("cut3", "cut_half") for c in ("ijcnn1-rbf.grid", "ijcnn1-rbf.predict")])
def test_solve_stopped_early_is_not_correct(monkeypatch, capsys, bench_copy, fault, cell):
    """A learn that stops before the configuration's rule (eps, max_iter)
    says it should: faster, and not correct.  The cut steps are planted
    only where CG takes more than three (rcv1 at eps 1e-3 takes one)."""
    orig = run.program_factory
    monkeypatch.setattr(run, "program_factory", lambda args, cfg, ds, chips, dev: orig(
        args, stop_rule(fault, cfg, ds.features), ds, chips, dev))
    assert drive(monkeypatch, capsys, bench_copy, cell)["correct"] is False


@pytest.mark.parametrize("cell", LEARN_CELLS)
def test_altered_alpha_is_not_correct(monkeypatch, capsys, bench_copy, cell):
    """One alpha of each learn altered where the learn produces it."""
    orig = base.CSVM.learn

    def learn(self):
        orig(self)
        self.alphas[len(self.alphas) // 3] += 0.5
    monkeypatch.setattr(base.CSVM, "learn", learn)
    assert drive(monkeypatch, capsys, bench_copy, cell)["correct"] is False


def half_mean(out):
    out[len(out) // 2:] = np.mean(out[: len(out) // 2])
    return out


def one_altered(out):
    out[len(out) // 3] += np.max(np.abs(out))
    return out


@pytest.mark.parametrize("fault", [half_mean, one_altered])
def test_broken_predict_is_not_correct(monkeypatch, capsys, bench_copy, fault):
    orig = base.CSVM.predict
    monkeypatch.setattr(base.CSVM, "predict", lambda self, p: fault(orig(self, p)))
    assert drive(monkeypatch, capsys, bench_copy, "ijcnn1-rbf.predict")["correct"] is False
