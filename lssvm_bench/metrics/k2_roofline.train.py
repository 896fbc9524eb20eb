"""K2's share of its roofline in a row-ring learn: Σ least time / Σ device
time over every card's K2 launches in the traced window (strips and their
slab sums included).  One hop of the ring is one K2 call of ``m`` x ``m``
points, ``m = (rows - 1) / chips``, at the data's width.

The hops are counted by the program (counter ``ring_hops``), not from how
the launches group: two hops back to back on a card, with nothing between
them, are one run of launches, and a card-to-card copy on a side stream
can start between a strip and its slab sum.  So the copies are left out
of the cards' events, and each tier's calls share the work of that tier's
hops, which follow its share of the K2 launches (a hop launches as many
strips at every tier).  None in an untraced run, or where the program
counts no hops."""

import sys

from lssvm_bench import roofline


def read(ctx):
    tr = ctx["trace"]
    timing = sys.modules.get("plssvm_sparse_fp22_tpu_torch.utils.timing")
    hops = getattr(getattr(timing, "TRACED", None), "counters", {}).get("ring_hops")
    if tr is None or not hops:
        return None
    kernels = {dev: [e for e in evs if not e[0].startswith("Memcpy")]
               for dev, evs in tr.kernels.items()}
    launches, calls = {}, {}
    for events in kernels.values():
        for name, _, _ in events:
            c = roofline.classify(name)
            if c is not None and c[0] == "K2" and c[1] != "reduce":
                launches[c[1]] = launches.get(c[1], 0) + 1
        for tier, _ in roofline.calls(events, "K2"):
            calls[tier] = calls.get(tier, 0) + 1
    total = sum(launches.values())
    m, f = (ctx["rows"] - 1) / ctx["chips"], ctx["features"]

    def work(tier):
        flops, nbytes = roofline.k2_call(m, m, f, tier)
        per_call = hops * launches[tier] / total / calls[tier]
        return flops * per_call, nbytes * per_call

    return roofline.share(kernels, "K2", work) if total else None
