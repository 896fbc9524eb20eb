"""Megabytes (1e6 bytes) of row blocks a profiled learn's ring moves
between cards: the program's counter ``ring_bytes`` (``parallel/sharded.py``:
the block copies from one card to another and the blocks sent to other
processes; ``utils.timing.TRACED``) over its ``learn`` spans; None in an
untraced run or where the program has no such counter."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    learns = len(traced.records.get("learn", ()))
    moved = getattr(traced, "counters", {}).get("ring_bytes")
    return moved / learns / 1e6 if learns and moved is not None else None
