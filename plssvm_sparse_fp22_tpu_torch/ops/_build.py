"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (K1/K2 in ``gram_matvec.cu``, K3 in
``pair_contrib.cu``, both including ``gram_tile.cuh`` and
``gram_tile_wgmma.cuh``; the bf16x3 split in ``split_bf16.cu``; the CG
loop's chunk graph in ``cg_chunk.cu``; the sparse gram tier's light pairs
and its products with the last point in ``sparse_gram.cu``) into an
object, one ``nvcc`` per source, all started together, and links them into
one shared library with a plain C interface, loaded with ``ctypes``;
nothing links against PyTorch, so a build takes well under a minute.  Nothing links against ``libcuda``
either: the wgmma tile's tensor maps need that library's
``cuTensorMapEncodeTiled``, which the built code looks up at run time
through ``cudaGetDriverEntryPoint`` (PyTorch has ``libcuda`` loaded), so no
link flag and no stub path are needed.  The library goes to
``plssvm_sparse_fp22_tpu_torch/_build/`` (listed in ``.gitignore``) at first
use and is rebuilt when the hash of any source or header, or of the flags,
changes.  There is no fallback: a failed build raises.

Builds are serialised twice: a thread lock within the process and a file
lock (``flock`` on ``_build/lock``) across processes, so ranks that reach
the kernels at once on a fresh tree run ``nvcc`` once, the others load what
it built.  The operating system releases an ``flock`` when its holder
exits, however it exits, so a build cut short leaves no stale lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from ..constants import CUDA_TILE
from ..exceptions import BackendError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libgram_matvec.so")
_STAMP = LIBRARY + ".sha256"
_LOCK_FILE = "lock"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
COMPILE_FLAGS = ARCH_FLAGS + ["-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    """The kernel sources, ``csrc/*.cu``, in name order."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BackendError("nvcc not found (set CUDA_HOME); the CUDA backend "
                       "builds csrc/*.cu at first use")


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return digest.hexdigest()


@contextlib.contextmanager
def _build_lock():
    """The build directory to this process alone (it waits for the lock)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, _LOCK_FILE), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build() -> dict:
    """Compile the library unless a build of the current sources exists,
    under the build lock.  Returns ``{"path", "seconds", "log",
    "cached"}``: the wall time of the whole build and the compilers' output
    (``-Xptxas -v`` register and spill counts of every kernel)."""
    with _build_lock():
        return _build()


def _build() -> dict:
    digest = _source_hash()
    if os.path.exists(LIBRARY) and os.path.exists(_STAMP):
        with open(_STAMP) as fh:
            if fh.read().strip() == digest:
                return {"path": LIBRARY, "seconds": 0.0, "log": "", "cached": True}
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all running at once: a build costs its slowest
        # source, not their sum
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", f"{tmp}/{i}.o", src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for i, src in enumerate(sources())]
        log = [proc.communicate()[0] for proc in procs]
        failed = [f"nvcc failed on {proc.args[-1]}:\n{out}"
                  for proc, out in zip(procs, log) if proc.returncode != 0]
        if failed:
            raise BackendError("\n".join(failed))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", f"{tmp}/lib.so",
                               *(f"{tmp}/{i}.o" for i in range(len(procs)))],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise BackendError(f"nvcc failed to link {LIBRARY}:\n{link.stdout}{link.stderr}")
        os.replace(f"{tmp}/lib.so", LIBRARY)
    seconds = time.perf_counter() - start
    with open(_STAMP, "w") as fh:
        fh.write(digest)
    return {"path": LIBRARY, "seconds": seconds, "log": "".join(log), "cached": False}


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()["path"])
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # each entry point starts with the tier and its operand pointers
        lib.gram_matvec_sym.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, F, F, P]
        lib.gram_matvec_sym.restype = I
        lib.gram_matvec_rect.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, F, P]
        lib.gram_matvec_rect.restype = I
        lib.gram_pair_contrib.argtypes = [I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                          I, F, F, P]
        lib.gram_pair_contrib.restype = I
        lib.split_bf16_rows.argtypes = [P, P, P, ctypes.c_longlong, I, I, P]
        lib.split_bf16_rows.restype = I
        lib.sparse_gram_pairs.argtypes = [P, ctypes.c_longlong, I, P, P, P, P, P, P,
                                           ctypes.c_longlong, P]
        lib.sparse_gram_pairs.restype = I
        lib.sparse_rows_matvec.argtypes = [P, ctypes.c_longlong, ctypes.c_longlong, P, P, P,
                                            P, P]
        lib.sparse_rows_matvec.restype = I
        lib.cg_chunk_build.argtypes = [P, P, P, P, P, ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.POINTER(P), ctypes.POINTER(P)]
        lib.cg_chunk_build.restype = I
        lib.cg_chunk_launch.argtypes = [P, P]
        lib.cg_chunk_launch.restype = I
        lib.cg_chunk_destroy.argtypes = [P, P]
        lib.cg_chunk_destroy.restype = I
        lib.cg_error_name.argtypes = [I]
        lib.cg_error_name.restype = ctypes.c_char_p
        lib.gram_matvec_tile.argtypes = []
        lib.gram_matvec_tile.restype = I
        if lib.gram_matvec_tile() != CUDA_TILE:
            raise BackendError(f"kernel library tile {lib.gram_matvec_tile()} != "
                               f"CUDA_TILE {CUDA_TILE}")
        _lib = lib
        return _lib
