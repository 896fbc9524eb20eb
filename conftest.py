"""Prepare the pytest-xdist controller before it starts its workers: give the
workers one CPU-thread budget, and build the JAX package's native parser
once.

**The thread budget.**  PyTorch and OpenBLAS start one OpenMP thread per
core in every process, so ``-n 6`` on 8 cores runs 6 x 8 threads, and the
idle ones spin on the cores the other workers need.  On an 8-core host six
of the port's test files (``test_torch_cg``, ``_learn_setup``,
``_sparse_learn``, ``_precision``, ``_checkpoint``, ``_scratch_strips``)
under ``-n 6 --dist loadfile -m 'not slow'`` took 198.7 s at the defaults
and 41.4 s with one thread a worker, with the same 284 passes.  So the controller
sets ``OMP_NUM_THREADS``, ``MKL_NUM_THREADS`` and
``OPENBLAS_NUM_THREADS`` to the worker's share of the cores it may run on,
at least one, before xdist starts a worker; every worker, and every process
a test spawns, inherits it.  A value already in the environment wins.

**The native build.**  ``tests/test_native.py`` decides whether to skip its
cases by building ``native/build/libplssvm_native.so`` while it is imported
(``plssvm_sparse_fp22_tpu/io/native.py`` runs ``make -s`` in ``native/``).
Every xdist worker imports it, and on a fresh checkout all of them would run
``make`` at once; the Makefile links straight onto its target, so one worker
can load the library while another is still writing it, fail, and skip the
file's cases.  Built here first, in the controller, the library is up to
date when the workers start and their ``make`` does nothing.  A failed or
missing build is left for the tests to find: whether the native cases skip
stays their own decision.

Workers and runs without ``-n`` set and build nothing here.
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
THREAD_VARIABLES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", default=None):
        return
    # xdist's pytest_cmdline_main has resolved -n (auto, --maxprocesses)
    # into one "popen" gateway a worker
    workers = len(config.getoption("tx", default=None) or ()) or 1
    share = str(max(1, len(os.sched_getaffinity(0)) // workers))
    for name in THREAD_VARIABLES:
        os.environ.setdefault(name, share)
    if not os.path.isdir(NATIVE):
        return
    try:
        subprocess.run(["make", "-s"], cwd=NATIVE, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=120, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
