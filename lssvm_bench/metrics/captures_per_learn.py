"""CG chunk graphs captured per profiled learn: the program's counter
``cg_captures`` (``solver/cg.py``, ``utils.timing.TRACED``) over its
``learn`` spans, 0 where the learns replayed kept graphs; None in an
untraced run."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    learns = len(traced.records.get("learn", ()))
    return getattr(traced, "counters", {}).get("cg_captures", 0) / learns if learns else None
