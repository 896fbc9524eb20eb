"""Mean CG iterations per learn (``CSVM.last_cg_info["iterations"]``)."""


def read(ctx):
    its = [i["iterations"] for i in ctx["learns"] if i.get("iterations") is not None]
    return sum(its) / len(its) if its else None
