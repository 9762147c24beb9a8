"""launches_per_request: the device activities (kernels, copies, fills) in
the traced slice, from the profiler, over the requests that started in it."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.calls or not tr.device:
        return None
    return len(tr.device) / tr.calls
