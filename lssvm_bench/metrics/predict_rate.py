"""Points classified per second over the whole window, decision values back
on the host."""


def read(ctx):
    if not ctx["call_s"]:
        return None
    return ctx["points_per_call"] * len(ctx["call_s"]) / ctx["window_s"]
