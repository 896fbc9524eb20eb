"""Host milliseconds of a profiled ``CSVM.predict`` outside its kernel
part: the ``predict`` span less its ``predict/kernel`` part (the float64
check, the casts and copies, the read-back), mean per call, from the
program's ``utils.timing.TRACED``; None in an untraced run."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    calls = traced.records.get("predict", [])
    kernel = traced.parts.get("predict", {}).get("kernel", [])
    return (sum(calls) - sum(kernel)) / len(calls) if calls else None
