"""Build the JAX package's native parser once before pytest-xdist starts its
workers.

``tests/test_native.py`` decides whether to skip its cases by building
``native/build/libplssvm_native.so`` while it is imported
(``plssvm_sparse_fp22_tpu/io/native.py`` runs ``make -s`` in ``native/``).
Every xdist worker imports it, and on a fresh checkout all of them would run
``make`` at once; the Makefile links straight onto its target, so one worker
can load the library while another is still writing it, fail, and skip the
file's cases.  Built here first, in the controller, the library is up to
date when the workers start and their ``make`` does nothing.

A failed or missing build is left for the tests to find: whether the
native cases skip stays their own decision.  Workers and runs without
``-n`` build nothing here.
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", default=None):
        return
    if not os.path.isdir(NATIVE):
        return
    try:
        subprocess.run(["make", "-s"], cwd=NATIVE, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=120, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
