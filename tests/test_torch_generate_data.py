"""plssvm-generate-data-torch: ``tests/test_generate_data.py`` case for case
on the port's generator, and equal bytes with the JAX package's at the same
seed (the port draws the blobs and the ball itself, as sklearn draws them)."""

import numpy as np
import pytest

from plssvm_sparse_fp22_tpu.cli.generate_data import generate as jax_generate
from plssvm_sparse_fp22_tpu.cli.generate_data import main as jax_main

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.cli.generate_data import generate, main, minmax_scale
from plssvm_sparse_fp22_tpu_torch.io.arff import parse_arff_file
from plssvm_sparse_fp22_tpu_torch.io.libsvm import parse_libsvm_file

PROBLEMS = ["blobs", "blobs_merged", "planes", "planes_merged", "ball"]


@pytest.mark.parametrize("problem", PROBLEMS)
def test_problems_generate(problem):
    X, y = generate(problem, 60, 4, seed=1)
    assert X.shape == (60, 4)
    assert set(np.unique(y)) <= {-1.0, 1.0}


def test_paired_train_test_files(tmp_path):
    base = tmp_path / "pair"
    rc = main(["--output", str(base), "--format", "libsvm", "--samples", "50",
               "--test_samples", "20", "--features", "6"])
    assert rc == 0
    train = parse_libsvm_file(str(base) + ".libsvm")
    test = parse_libsvm_file(str(base) + "_test.libsvm")
    assert train.num_points == 50 and test.num_points == 20
    assert train.num_features == 6


def test_default_output_name_and_duplicate_extension(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["--format", "libsvm", "--samples", "10", "--features", "3"]) == 0
    assert (tmp_path / "10x3.libsvm").exists()
    # reference behavior: '--output x.libsvm --format libsvm' -> x.libsvm
    assert main(["--output", "dup.libsvm", "--format", "libsvm",
                 "--samples", "5", "--features", "2"]) == 0
    assert (tmp_path / "dup.libsvm").exists()
    assert not (tmp_path / "dup.libsvm.libsvm").exists()


def test_arff_output(tmp_path):
    out = tmp_path / "g.arff"
    assert main(["--output", str(out), "--samples", "12", "--features", "3",
                 "--problem", "ball"]) == 0
    parsed = parse_arff_file(str(out))
    assert parsed.num_points == 12 and parsed.num_features == 3


def test_minmax_scale_flag(tmp_path):
    out = tmp_path / "s.libsvm"
    assert main(["--output", str(out), "--samples", "40", "--features", "4",
                 "--minmax_scale"]) == 0
    parsed = parse_libsvm_file(str(out))
    X = parsed.dense
    assert X.min() >= -1.0 - 1e-12 and X.max() <= 1.0 + 1e-12


def test_minmax_scale_constant_feature():
    X = np.array([[1.0, 5.0], [1.0, 7.0], [1.0, 9.0]])
    S = minmax_scale(X)
    np.testing.assert_allclose(S[:, 0], -1.0)
    np.testing.assert_allclose(S[:, 1], [-1.0, 0.0, 1.0])


def test_invalid_counts_rejected(tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["--output", str(tmp_path / "x.libsvm"), "--samples", "0",
              "--features", "3"])
    err = capsys.readouterr().err
    assert "cannot be 0 or negative" in err


def test_plot_accepted_and_ignored(tmp_path, capsys):
    out = tmp_path / "p.libsvm"
    assert main(["--output", str(out), "--samples", "8", "--features", "2",
                 "--plot"]) == 0
    assert "ignored" in capsys.readouterr().out


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("samples,features,seed", [(60, 4, 1), (61, 7, 42), (5, 2, 3)])
def test_same_seed_same_samples_as_the_jax_generator(problem, samples, features, seed):
    X, y = generate(problem, samples, features, seed=seed)
    Xj, yj = jax_generate(problem, samples, features, seed=seed)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("fmt,extra", [("libsvm", []), ("arff", []),
                                       ("libsvm", ["--minmax_scale", "--problem", "ball"])])
def test_same_seed_same_bytes_as_the_jax_cli(tmp_path, fmt, extra):
    argv = ["--format", fmt, "--samples", "33", "--test_samples", "9", "--features", "5",
            "--seed", "7", *extra]
    assert main(["--output", str(tmp_path / "t"), *argv]) == 0
    assert jax_main(["--output", str(tmp_path / "j"), *argv]) == 0
    for suffix in (f".{fmt}", f"_test.{fmt}"):
        got = (tmp_path / ("t" + suffix)).read_bytes()
        want = (tmp_path / ("j" + suffix)).read_bytes()
        # an ARFF header names its relation after the file
        assert got.replace(b"t_test", b"j_test").replace(b"/t", b"/j") == want or got == want


def test_planes_without_sklearn_is_a_cli_error(monkeypatch, capsys, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *args, **kw):
        if name.split(".")[0] == "sklearn":
            raise ImportError("No module named 'sklearn'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    # the blobs and the ball need no sklearn
    assert main(["--output", str(tmp_path / "b.libsvm"), "--samples", "9", "--features", "3"]) == 0
    with pytest.raises(SystemExit):
        main(["--output", str(tmp_path / "p.libsvm"), "--samples", "9", "--features", "3",
              "--problem", "planes"])
    assert "needs scikit-learn" in capsys.readouterr().err
