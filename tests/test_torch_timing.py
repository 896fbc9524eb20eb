"""utils/timing.py of the port: the slope estimator, the sink and the
scoped timer's line."""

import re
import time

import pytest

torch = pytest.importorskip("torch")

from plssvm_sparse_fp22_tpu.utils import timing as jtiming
from plssvm_sparse_fp22_tpu_torch.utils import timing
from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings, scoped_timer, slope_rate


def test_slope_rate_recovers_a_known_slope():
    """A synthetic run: 0.5 s of set-up plus 2 ms per iteration is 500 it/s,
    whatever the set-up."""
    calls = []

    def run(seed, n):
        calls.append((seed, n))
        return 0.5 + 0.002 * n

    assert slope_rate(run, 10, 110) == pytest.approx(500.0, rel=1e-9)
    assert calls[0] == (0, 10)                      # the warm-up
    assert len(calls) == 1 + 2 * 5                  # five trials of two caps
    assert {n for _, n in calls} == {10, 110}
    # the call order alternates between trials
    assert [n for _, n in calls[1:5]] == [10, 110, 110, 10]
    # the same estimator as the JAX package's
    assert jtiming.slope_rate(run, 10, 110) == pytest.approx(500.0, rel=1e-9)


def test_slope_rate_with_an_early_stopping_run():
    """A solve that stops at 40 iterations whatever the cap reports what it
    executed: the slope uses the executed counts."""
    def run(seed, n):
        k = min(n, 40)
        return 0.1 + 0.01 * k, k

    assert slope_rate(run, 10, 100) == pytest.approx(100.0, rel=1e-9)

    def stalled(seed, n):  # both caps execute the same count: no slope to take
        return 0.25, 20

    assert slope_rate(stalled, 30, 60) == pytest.approx(80.0)


def test_slope_rate_grows_the_span_until_it_dwarfs_noise():
    seen = []

    def run(seed, n):
        seen.append(n)
        return 0.001 * n

    rate = slope_rate(run, 4, 16, trials=3, grow_to_seconds=0.2, max_hi=4096)
    assert rate == pytest.approx(1000.0, rel=1e-9)
    assert max(seen) == 1024  # (64, 256) spans 0.192 s, (256, 1024) 0.768 >= 0.2


def test_slope_rate_takes_the_median():
    times = iter([0.0,            # warm-up
                  1.0, 2.0,       # trial 0: lo, hi -> 1 s / 10 it
                  9.0, 1.0,       # trial 1: hi, lo -> 8 s
                  1.0, 3.0])      # trial 2: lo, hi -> 2 s

    def run(seed, n):
        return next(times)

    assert slope_rate(run, 10, 20, trials=3) == pytest.approx(10 / 2.0)


def test_timings_accumulates_and_sums():
    sink = Timings()
    sink("cg", 2.0)
    sink("cg", 3.5)
    sink("setup", 1.0)
    assert sink.records == {"cg": [2.0, 3.5], "setup": [1.0]}
    assert sink.summary() == {"cg": 5.5, "setup": 1.0}


def test_scoped_timer_line_and_sink(capsys):
    sink = Timings()
    with scoped_timer("Parsed 5 data points", sink=sink, device=torch.device("cpu")):
        time.sleep(0.02)
    out = capsys.readouterr().out
    m = re.fullmatch(r"Parsed 5 data points in (\d+)ms\.\n", out)
    assert m is not None and 15 <= int(m.group(1)) < 2000
    assert 15.0 <= sink.records["Parsed 5 data points"][0] < 2000.0
    with scoped_timer("quiet", print_info=False, sink=sink, device=["cpu", None]):
        pass
    assert capsys.readouterr().out == "" and "quiet" in sink.records
    # the JAX package prints the same line
    with jtiming.scoped_timer("Parsed 5 data points"):
        pass
    assert re.fullmatch(r"Parsed 5 data points in \d+ms\.\n", capsys.readouterr().out)


def test_scoped_timer_synchronises_the_device_it_is_given(monkeypatch):
    waited = []
    monkeypatch.setattr(timing.torch.cuda, "synchronize", lambda dev=None: waited.append(dev))
    with scoped_timer("span", print_info=False, device="cuda:0"):
        pass
    assert waited == [torch.device("cuda:0")] * 2  # before the clock starts and before it stops
    with scoped_timer("span", print_info=False, device="cpu"):
        pass
    with scoped_timer("span", print_info=False):
        pass
    assert len(waited) == 2

