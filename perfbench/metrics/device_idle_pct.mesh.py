"""device_idle_pct.mesh: the share of the cards' traced time in which
nothing ran on them (no kernel, copy or fill), from the profiler's activity
on every card: 1 − Σ busy / Σ traced window, over the cards.  An NCCL
kernel waiting for another rank counts as busy; `allreduce_ms` shows it."""


def read(ctx):
    traces = [tr for tr in ctx.traces if tr is not None]
    busy, window = sum(tr.busy_s() for tr in traces), sum(tr.window_s for tr in traces)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
