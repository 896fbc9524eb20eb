"""Build and load the CUDA kernels of ``csrc/gram_matvec.cu``.

``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes``; nothing links against PyTorch, so a build
takes seconds.  The library goes to ``plssvm_sparse_fp22_tpu_torch/_build/``
(listed in ``.gitignore``) at first use and is rebuilt when the source's
hash changes.  There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..constants import CUDA_TILE
from ..exceptions import BackendError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "gram_matvec.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libgram_matvec.so")
_STAMP = LIBRARY + ".sha256"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BackendError("nvcc not found (set CUDA_HOME); the CUDA backend "
                       "builds csrc/gram_matvec.cu at first use")


def _source_hash() -> str:
    with open(SOURCE, "rb") as fh:
        return hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def build() -> dict:
    """Compile the library unless a build of the current source exists.
    Returns ``{"path", "seconds", "log", "cached"}``: the compile time and
    the compiler's output (``-Xptxas -v`` register and spill counts)."""
    digest = _source_hash()
    if os.path.exists(LIBRARY) and os.path.exists(_STAMP):
        with open(_STAMP) as fh:
            if fh.read().strip() == digest:
                return {"path": LIBRARY, "seconds": 0.0, "log": "", "cached": True}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    start = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise BackendError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    with open(_STAMP, "w") as fh:
        fh.write(digest)
    return {"path": LIBRARY, "seconds": seconds, "log": proc.stdout + proc.stderr,
            "cached": False}


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()["path"])
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gram_matvec_sym.argtypes = [P, P, P, P, P, I, I, I, I, F, F, P]
        lib.gram_matvec_sym.restype = I
        lib.gram_matvec_rect.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, F, F, P]
        lib.gram_matvec_rect.restype = I
        lib.gram_matvec_tile.argtypes = []
        lib.gram_matvec_tile.restype = I
        if lib.gram_matvec_tile() != CUDA_TILE:
            raise BackendError(f"kernel library tile {lib.gram_matvec_tile()} != "
                               f"CUDA_TILE {CUDA_TILE}")
        _lib = lib
        return _lib
