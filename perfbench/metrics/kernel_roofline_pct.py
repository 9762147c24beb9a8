"""kernel_roofline_pct: the least time of one call's work (the larger of
its bytes, each input read once and each output written once, at the HBM
rate, and its operations at the published peaks; counted from the cell's
shapes by the configuration's `work`) over the device's busy time a call in
the traced slice (the union of all its activity, over the calls)."""

from perfbench.peaks import share_pct


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.calls or tr.busy_s() <= 0:
        return None
    return share_pct(ctx.work, ctx.kind, tr.busy_s() / tr.calls)
