"""fused_chain_roofline: the least time of one call's work over the time a
call of the fused chain kernel (``fused_chain_kernel``) ran on the device
in the traced slice.  Silent where the kernel did not run."""

from perfbench.peaks import share_pct


def read(ctx):
    tr = ctx.trace
    s = tr.kernel_s("fused_chain_kernel") if tr is not None else 0.0
    if not s or not tr.calls:
        return None
    return share_pct(ctx.work, ctx.kind, s / tr.calls)
