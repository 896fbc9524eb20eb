"""Idle share of the device in the traced window: 1 - (union of device
activity) / window, the mean over the cards used, in %.  Serves every
``device_idle.<kind>`` metric (``device_idle.train``, ``device_idle.predict``):
the window is the cell's own."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or not tr.busy_s:
        return None
    return 100.0 * (1.0 - sum(tr.busy_s.values()) / ctx["chips"] / tr.window_s)
