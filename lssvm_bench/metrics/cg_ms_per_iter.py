"""The ``cg`` span's milliseconds over the CG steps executed
(``CSVM.last_cg_loop["executed"]``), summed over the window's learns."""


def read(ctx):
    learns = [i for i in ctx["learns"] if "cg" in i and i.get("executed")]
    steps = sum(i["executed"] for i in learns)
    return sum(i["cg"] for i in learns) / steps if steps else None
