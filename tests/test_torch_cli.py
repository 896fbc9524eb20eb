"""The port's CLIs end to end on the CPU, and model files crossing between
the two packages (mirrors ``test_cli.py`` and the reference's 5x4 and
500x200 golden predictions)."""

import numpy as np
import pytest

from plssvm_sparse_fp22_tpu.cli.predict import main as jax_predict
from plssvm_sparse_fp22_tpu.cli.train import main as jax_train

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
from plssvm_sparse_fp22_tpu_torch.cli.train import main as train_main
from plssvm_sparse_fp22_tpu_torch.io.model import parse_model_file
from plssvm_sparse_fp22_tpu_torch.types import KernelType


def _labels(path):
    return np.loadtxt(path)


def test_5x4_train_predict_prints_reference_labels(reference_data_dir, tmp_path, capsys):
    data = f"{reference_data_dir}/libsvm/5x4.libsvm"
    model, out = str(tmp_path / "v.model"), str(tmp_path / "v.predict")
    assert train_main(["-t", "2", "-e", "1e-6", "--max_iter", "100", data, model]) == 0
    assert predict_main([data, model, out]) == 0
    assert open(out).read().split() == ["1", "1", "-1", "-1", "-1"]
    printed = capsys.readouterr().out
    # the CLI names the device and backend that 'automatic' resolved to
    assert "device: cpu (CPU), backend: torch" in printed
    assert "Accuracy = 100% (5/5) (classification)" in printed


def test_golden_linear_predict_diffs_clean(reference_data_dir, tmp_path):
    out = tmp_path / "g.predict"
    assert predict_main(["-q", f"{reference_data_dir}/libsvm/500x200.libsvm.test",
                         f"{reference_data_dir}/models/500x200.libsvm.linear.model",
                         str(out)]) == 0
    golden = open(f"{reference_data_dir}/predict/500x200.libsvm.predict").read()
    assert out.read_text() == golden


@pytest.mark.parametrize("kernel_name", ["polynomial", "rbf"])
def test_golden_kernel_models_predict_like_jax(reference_data_dir, tmp_path, kernel_name):
    test = f"{reference_data_dir}/libsvm/500x200.libsvm.test"
    model = f"{reference_data_dir}/models/500x200.libsvm.{kernel_name}.model"
    assert predict_main(["-q", test, model, str(tmp_path / "t.predict")]) == 0
    assert jax_predict(["-q", test, model, str(tmp_path / "j.predict")]) == 0
    np.testing.assert_array_equal(_labels(tmp_path / "t.predict"), _labels(tmp_path / "j.predict"))
    np.testing.assert_array_equal(
        _labels(tmp_path / "t.predict"),
        _labels(f"{reference_data_dir}/predict/500x200.libsvm.predict"))


@pytest.mark.parametrize("kernel_flag", ["0", "1", "2"])
def test_models_cross_between_packages(reference_data_dir, tmp_path, kernel_flag):
    """A model written by the port loads in the JAX predict CLI with the
    same labels, and the reverse; both model files parse to the same
    kernel and support vectors."""
    data = f"{reference_data_dir}/libsvm/500x200.libsvm"
    test = f"{reference_data_dir}/libsvm/500x200.libsvm.test"
    flags = ["-q", "-t", kernel_flag, "-e", "1e-6", "--max_iter", "300"]
    t_model, j_model = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    assert train_main(flags + [data, t_model]) == 0
    assert jax_train(flags + [data, j_model]) == 0
    for model in (t_model, j_model):
        assert predict_main(["-q", test, model, str(tmp_path / "t.predict")]) == 0
        assert jax_predict(["-q", test, model, str(tmp_path / "j.predict")]) == 0
        np.testing.assert_array_equal(_labels(tmp_path / "t.predict"),
                                      _labels(tmp_path / "j.predict"))
    tm, jm = parse_model_file(t_model), parse_model_file(j_model)
    assert tm.kernel == jm.kernel == KernelType.from_string(kernel_flag)
    np.testing.assert_array_equal(tm.support_vectors.dense, jm.support_vectors.dense)


def test_cuda_requests_without_a_gpu_fail_cleanly(reference_data_dir, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    data = f"{reference_data_dir}/libsvm/5x4.libsvm"
    assert train_main(["-b", "cuda", data, str(tmp_path / "m.model")]) == 1
    assert "Backend 'cuda' requested" in capsys.readouterr().err
    assert train_main(["-p", "gpu_nvidia", data, str(tmp_path / "m.model")]) == 1
    assert "no CUDA device is visible" in capsys.readouterr().err


def test_flags_and_argument_errors(reference_data_dir, capsys):
    with pytest.raises(SystemExit) as e:
        train_main(["--help"])
    assert e.value.code == 0
    assert "cuda" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_main(["-b", "pallas", f"{reference_data_dir}/libsvm/5x4.libsvm"])
    assert "Unrecognized backend type 'pallas'!" in capsys.readouterr().err
    assert train_main(["-g", "0", f"{reference_data_dir}/libsvm/5x4.libsvm"]) == 1
    assert "gamma = 0.0 is not allowed" in capsys.readouterr().err
    assert train_main(["/nonexistent/data.libsvm"]) == 1
    assert "Couldn't find file" in capsys.readouterr().err


def test_train_arff(reference_data_dir, tmp_path):
    model = str(tmp_path / "arff.model")
    assert train_main(["-q", f"{reference_data_dir}/arff/5x4.arff", model]) == 0
    assert parse_model_file(model).support_vectors.num_points == 5
