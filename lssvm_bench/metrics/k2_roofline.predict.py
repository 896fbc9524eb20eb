"""K2's share of its roofline in the predict: each call a whole test set
against every training point as support vector."""

from lssvm_bench import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    rows, cols, f = ctx["points_per_call"], ctx["rows"], ctx["features"]
    return roofline.share(tr.kernels, "K2", lambda tier: roofline.k2_call(rows, cols, f, tier))
