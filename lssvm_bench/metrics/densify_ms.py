"""Mean per profiled learn of the sparse gram tier's ``setup/densify`` part
(``plssvm::setup/densify``): the sparse rows densified into the padded
host array.  Read from the program's ``utils.timing.TRACED``, which holds
the calls made while the profiler recorded; None in an untraced run."""

import sys


def read(ctx):
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    traced = getattr(timing, "TRACED", None)
    if traced is None:
        return None
    learns = len(traced.records.get("learn", ()))
    densify = traced.parts.get("setup", {}).get("densify")
    return sum(densify) / learns if learns and densify else None
