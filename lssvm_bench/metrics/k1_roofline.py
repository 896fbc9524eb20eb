"""K1's share of its roofline: Σ least time / Σ device time over its calls
in the traced window (strips and reductions included), each call the
learn's system of ``rows - 1`` unknowns at the data's width."""

from lssvm_bench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n, f = ctx["rows"] - 1, ctx["features"]
    return roofline.share(tr.kernels, "K1", lambda tier: roofline.k1_call(n, f, tier))
