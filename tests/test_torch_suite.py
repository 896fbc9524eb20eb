"""The test suite's own set-up: the CPU-thread budget the root ``conftest.py``
gives pytest-xdist's workers."""

import os

import pytest

torch = pytest.importorskip("torch")


def test_xdist_worker_runs_within_its_share_of_the_cores():
    """Inside an xdist worker ``OMP_NUM_THREADS`` is set and PyTorch runs at
    most the worker's share of the cores (one thread at least), so the
    workers do not spin on each other's cores."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        pytest.skip("not an xdist worker: the budget is set only under -n")
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    assert "OMP_NUM_THREADS" in os.environ
    assert 1 <= torch.get_num_threads() <= share
