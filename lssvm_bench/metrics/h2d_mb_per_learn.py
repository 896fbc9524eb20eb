"""Megabytes (1e6 bytes) of host arrays a profiled learn copies to its
device: the program's counter ``h2d_bytes`` (``utils.timing.TRACED``) over
its ``learn`` spans; None in an untraced run."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    learns = len(traced.records.get("learn", ()))
    h2d = getattr(traced, "counters", {}).get("h2d_bytes")
    return h2d / learns / 1e6 if learns and h2d is not None else None
