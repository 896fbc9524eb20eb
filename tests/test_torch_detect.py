"""plssvm-detect-torch reports the devices PyTorch sees and the defaults the
port would pick; it changes nothing."""

import json

import pytest

torch = pytest.importorskip("torch")

import plssvm_sparse_fp22_tpu_torch as tp
from plssvm_sparse_fp22_tpu_torch.cli.detect import detect, main
from plssvm_sparse_fp22_tpu_torch.exceptions import BackendError
from plssvm_sparse_fp22_tpu_torch.ops import _build


def _nvcc_or_none():
    try:
        return _build._nvcc()
    except BackendError:
        return None


def test_json_has_the_jax_cli_keys_and_the_ports(capsys):
    assert main(["--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    info = json.loads(lines[0])
    assert {"platform", "num_devices", "devices", "default_backend"} <= set(info)
    assert {"nvcc", "torch", "cuda"} <= set(info)
    assert info["num_devices"] == len(info["devices"]) >= 1
    assert info["torch"] == torch.__version__ and info["cuda"] == torch.version.cuda
    assert info["nvcc"] == _nvcc_or_none()


def test_report_agrees_with_torch_and_with_csvm(capsys):
    info = detect()
    on_gpu = torch.cuda.is_available()
    assert info["platform"] == ("cuda" if on_gpu else "cpu")
    device = tp.CSVM._resolve_device(tp.TargetPlatform.automatic)
    backend = tp.CSVM._resolve_backend(tp.BackendType.automatic, device)
    assert info["default_backend"] == str(backend) == ("cuda" if on_gpu else "torch")
    if on_gpu:
        assert info["num_devices"] == torch.cuda.device_count()
        first = info["devices"][0]
        assert first["name"] == torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        assert first["compute_capability"] == f"{major}.{minor}"
        assert first["total_memory_bytes"] == torch.cuda.get_device_properties(0).total_memory
    else:
        assert info["devices"] == [{"device": "cpu", "name": "CPU", "compute_capability": None,
                                    "total_memory_bytes": None}]


def test_text_report(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    for label in ("platform:", "devices (", "default backend:", "nvcc:", "torch:"):
        assert label in out
    if _nvcc_or_none() is None:
        assert "not found" in out


def test_nvcc_is_looked_for_as_the_build_looks(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert detect()["nvcc"] == str(fake) == _build._nvcc()
