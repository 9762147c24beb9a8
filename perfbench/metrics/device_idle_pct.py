"""device_idle_pct: the share of the traced slice in which nothing ran on
the device (no kernel, copy or fill), from the profiler's activity."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
