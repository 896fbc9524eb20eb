"""Mean per learn of the program's ``setup`` span (``CSVM.timings``):
packing, transfer, operators, the Gram of the sparse gram tier."""


def read(ctx):
    vals = [i["setup"] for i in ctx["learns"] if "setup" in i]
    return sum(vals) / len(vals) if vals else None
