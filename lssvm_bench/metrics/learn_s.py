"""The window's seconds over the learns it completed (the learn in flight
at the end of ``--seconds`` finished and counted)."""


def read(ctx):
    return ctx["window_s"] / len(ctx["call_s"]) if ctx["call_s"] else None
