"""``plssvm-detect-torch``: report available hardware and the selected defaults.

Counterpart of the JAX package's ``plssvm-detect`` and of the reference's
``utility_scripts/plssvm_target_platforms.py``: prints the platform
(``cuda`` or ``cpu``), the visible devices with compute capability and
memory, the backend ``CSVM`` would pick for them, whether ``nvcc`` is found
where the kernel build looks for it, and the torch and CUDA versions.  It
reports what is there; it selects and changes nothing.
"""

from __future__ import annotations

import argparse
import json
import sys


def detect() -> dict:
    """The report as a dict (the ``--json`` object)."""
    import torch

    from ..exceptions import BackendError
    from ..models.base import CSVM
    from ..ops import _build
    from ..types import BackendType, TargetPlatform

    on_gpu = torch.cuda.is_available()
    devices = []
    if on_gpu:
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({
                "device": f"cuda:{i}",
                "name": props.name,
                "compute_capability": f"{props.major}.{props.minor}",
                "total_memory_bytes": int(props.total_memory),
            })
    else:
        devices.append({"device": "cpu", "name": "CPU", "compute_capability": None,
                        "total_memory_bytes": None})
    try:
        nvcc = _build._nvcc()
    except BackendError:
        nvcc = None
    device = CSVM._resolve_device(TargetPlatform.automatic)
    backend = BackendType.cuda if device.type == "cuda" else BackendType.torch
    return {
        "platform": "cuda" if on_gpu else "cpu",
        "num_devices": len(devices),
        "devices": devices,
        "default_backend": str(backend),
        "nvcc": nvcc,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="plssvm-detect-torch", description="detect available devices and defaults"
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    info = detect()
    if args.json:
        print(json.dumps(info))
        return 0
    print(f"platform:        {info['platform']}")
    print(f"devices ({info['num_devices']}):")
    for d in info["devices"]:
        if d["compute_capability"] is None:
            print(f"  {d['device']}")
        else:
            print(f"  {d['device']}: {d['name']}, compute capability "
                  f"{d['compute_capability']}, {d['total_memory_bytes'] / 1024**3:.1f} GiB")
    print(f"default backend: {info['default_backend']}")
    print(f"nvcc:            {info['nvcc'] or 'not found (the cuda backend cannot build its kernels)'}")
    print(f"torch:           {info['torch']} (CUDA {info['cuda']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
