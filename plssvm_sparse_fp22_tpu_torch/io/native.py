"""ctypes bindings for the native (C++) LIBSVM parser and model writer.

The native layer plays the role of the reference's mmap + OpenMP parsing
path (``file_reader.cpp:72-100``, ``parameter.cpp:41-116``) and its
OpenMP-parallel model writer (``csvm.cpp:60-204``).  The shared library is
built from ``native/*.cpp`` by ``native/Makefile``; this module loads it,
building it once if the compiler is available, and falls back silently to
the pure-Python implementations otherwise.

The port builds its own copy, into ``_build/native/`` of this package
(git-ignored), never into ``native/build/``: ``make -s BUILD=<a temporary
directory>`` under an ``flock`` on ``_build/native/lock``, then an atomic
``os.replace`` onto the library, as ``ops/_build.py`` builds the CUDA
kernels.  So processes that start together on a fresh tree (test workers,
ranks) build once and never load a half-written file; the library is
rebuilt when the hash of the sources or the Makefile changes.

Set ``PLSSVM_NO_NATIVE_PARSER=1`` to force the Python paths.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import scipy.sparse as sp

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build", "native")
_LIB_NAME = "libplssvm_native.so"

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _source_hash() -> str:
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp"))
                       + glob.glob(os.path.join(_NATIVE_DIR, "*.h*"))
                       + [os.path.join(_NATIVE_DIR, "Makefile")]):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return digest.hexdigest()


@contextlib.contextmanager
def _build_lock(build_dir: str):
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build_native(build_dir: str = BUILD_DIR) -> str | None:
    """The path of the native library in ``build_dir``, built there first
    unless a build of the current sources exists; None where the sources or
    the compiler are missing or the build fails.  Holds the directory's
    build lock throughout, so a concurrent caller waits and then finds the
    finished library."""
    if not os.path.isfile(os.path.join(_NATIVE_DIR, "Makefile")):
        return None
    lib_path = os.path.join(build_dir, _LIB_NAME)
    stamp = lib_path + ".sha256"
    with _build_lock(build_dir):
        digest = _source_hash()
        if os.path.exists(lib_path) and os.path.exists(stamp):
            with open(stamp) as fh:
                if fh.read().strip() == digest:
                    return lib_path
        try:
            with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                subprocess.run(["make", "-s", f"BUILD={tmp}"], cwd=_NATIVE_DIR, check=True,
                               stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                               timeout=120)
                os.replace(os.path.join(tmp, _LIB_NAME), lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
        with open(stamp, "w") as fh:
            fh.write(digest)
        return lib_path


def get_native_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if os.environ.get("PLSSVM_NO_NATIVE_PARSER") == "1":
        return None
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        lib_path = build_native()
        if lib_path is None:
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        lib.plssvm_native_parse_libsvm.restype = ctypes.c_int
        lib.plssvm_native_parse_libsvm.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.plssvm_native_free.restype = None
        lib.plssvm_native_free.argtypes = [ctypes.c_void_p]
        lib.plssvm_native_parse_arff.restype = ctypes.c_int
        lib.plssvm_native_parse_arff.argtypes = lib.plssvm_native_parse_libsvm.argtypes
        lib.plssvm_native_write_model.restype = ctypes.c_int
        lib.plssvm_native_write_model.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        _lib = lib
        return _lib


def parse_libsvm_native(filename: str, dtype=np.float64):
    """Parse via the native library.

    Returns ``(csr, raw_values, any_unlabeled)`` like
    :func:`..libsvm.parse_libsvm_content`, or ``None`` when the native
    library is unavailable.  Raises the same exception types as the Python
    parser on malformed input.
    """
    from ..exceptions import FileNotFoundError_, InvalidFileFormatError

    lib = get_native_lib()
    if lib is None:
        return None

    indptr_p = ctypes.POINTER(ctypes.c_int64)()
    indices_p = ctypes.POINTER(ctypes.c_int32)()
    values_p = ctypes.POINTER(ctypes.c_double)()
    labels_p = ctypes.POINTER(ctypes.c_double)()
    n_rows = ctypes.c_int64()
    nnz = ctypes.c_int64()
    n_features = ctypes.c_int64()
    has_labels = ctypes.c_int()
    err = ctypes.create_string_buffer(512)

    rc = lib.plssvm_native_parse_libsvm(
        os.fspath(filename).encode(), ctypes.byref(indptr_p), ctypes.byref(indices_p),
        ctypes.byref(values_p), ctypes.byref(labels_p), ctypes.byref(n_rows),
        ctypes.byref(nnz), ctypes.byref(n_features), ctypes.byref(has_labels),
        err, ctypes.sizeof(err),
    )
    if rc != 0:
        msg = err.value.decode(errors="replace")
        if msg.startswith("Couldn't find file"):
            raise FileNotFoundError_(msg)
        raise InvalidFileFormatError(msg)

    try:
        n = n_rows.value
        m = nnz.value
        indptr = np.ctypeslib.as_array(indptr_p, shape=(n + 1,)).copy()
        indices = np.ctypeslib.as_array(indices_p, shape=(max(m, 1),))[:m].copy()
        values = np.ctypeslib.as_array(values_p, shape=(max(m, 1),))[:m].astype(dtype)
        labels = np.ctypeslib.as_array(labels_p, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.plssvm_native_free(indptr_p)
        lib.plssvm_native_free(indices_p)
        lib.plssvm_native_free(values_p)
        lib.plssvm_native_free(labels_p)

    csr = sp.csr_matrix(
        (values, indices.astype(np.int64), indptr), shape=(n, n_features.value),
        dtype=dtype,
    )
    csr.sort_indices()
    return csr, labels, has_labels.value == 0


def write_model_native(filename, header: str, csr, alphas, order) -> bool:
    """Write the SV block via the native multi-threaded writer.

    ``csr`` is a scipy CSR matrix of all data rows, ``order`` the row indices
    in output order (positives first, ``csvm.cpp:157-195``).  Returns False
    when the native library is unavailable (caller falls back to Python);
    raises on an actual write failure.
    """
    lib = get_native_lib()
    if lib is None:
        return False

    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    values = np.ascontiguousarray(csr.data, dtype=np.float64)
    alphas = np.ascontiguousarray(alphas, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    err = ctypes.create_string_buffer(512)

    rc = lib.plssvm_native_write_model(
        os.fspath(filename).encode(), header.encode(),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        alphas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(order), err, ctypes.sizeof(err),
    )
    if rc != 0:
        raise OSError(err.value.decode(errors="replace"))
    return True


def parse_arff_native(filename: str, dtype=np.float64):
    """Parse an ARFF file via the native library.

    Returns ``(csr, labels_or_None)`` matching
    :func:`..arff.parse_arff_file` semantics (labels already sign-mapped),
    or ``None`` when the native library is unavailable.
    """
    from ..exceptions import FileNotFoundError_, InvalidFileFormatError

    lib = get_native_lib()
    if lib is None:
        return None

    indptr_p = ctypes.POINTER(ctypes.c_int64)()
    indices_p = ctypes.POINTER(ctypes.c_int32)()
    values_p = ctypes.POINTER(ctypes.c_double)()
    labels_p = ctypes.POINTER(ctypes.c_double)()
    n_rows = ctypes.c_int64()
    nnz = ctypes.c_int64()
    n_features = ctypes.c_int64()
    has_labels = ctypes.c_int()
    err = ctypes.create_string_buffer(512)

    rc = lib.plssvm_native_parse_arff(
        os.fspath(filename).encode(), ctypes.byref(indptr_p), ctypes.byref(indices_p),
        ctypes.byref(values_p), ctypes.byref(labels_p), ctypes.byref(n_rows),
        ctypes.byref(nnz), ctypes.byref(n_features), ctypes.byref(has_labels),
        err, ctypes.sizeof(err),
    )
    if rc != 0:
        msg = err.value.decode(errors="replace")
        if msg.startswith("Couldn't find file"):
            raise FileNotFoundError_(msg)
        raise InvalidFileFormatError(msg)

    try:
        n = n_rows.value
        m = nnz.value
        indptr = np.ctypeslib.as_array(indptr_p, shape=(n + 1,)).copy()
        indices = np.ctypeslib.as_array(indices_p, shape=(max(m, 1),))[:m].copy()
        values = np.ctypeslib.as_array(values_p, shape=(max(m, 1),))[:m].astype(dtype)
        labels = np.ctypeslib.as_array(labels_p, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.plssvm_native_free(indptr_p)
        lib.plssvm_native_free(indices_p)
        lib.plssvm_native_free(values_p)
        lib.plssvm_native_free(labels_p)

    csr = sp.csr_matrix(
        (values, indices.astype(np.int64), indptr), shape=(n, n_features.value),
        dtype=dtype,
    )
    return csr, (labels if has_labels.value == 1 else None)
