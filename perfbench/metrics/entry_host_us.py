"""entry_host_us: the host's time in the entry a call, from calling it to
its return with no fence (checks, allocation of the outputs, the launch),
the median over the window's calls before the traced slice, on the
benchmark's own host clock."""

import statistics


def read(ctx):
    ns = ctx.records.entry_ns
    return statistics.median(ns) / 1e3 if ns else None
