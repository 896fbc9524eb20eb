"""Segments the caching allocator took from CUDA (``cudaMalloc`` calls)
per profiled learn: the program's counter ``alloc_segments``
(``utils.timing.TRACED``, 0 on the CPU) over its ``learn`` spans; None in
an untraced run."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    learns = len(traced.records.get("learn", ()))
    segments = getattr(traced, "counters", {}).get("alloc_segments")
    return segments / learns if learns and segments is not None else None
