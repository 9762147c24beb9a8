"""step_host_us: the host's time in one device stream step, the median over
the steps whose ``entry.stream_step`` span started in the traced slice,
read from the program's span ring on the profiler's clock.  Silent where
the program records no such span."""

import statistics

from perfbench import program_spans


def read(ctx):
    sp, tr = program_spans.module(), ctx.trace
    if sp is None or tr is None:
        return None
    w0, w1 = tr.window
    steps = [r.end_ns - r.start_ns for r in sp.records()
             if r.name == "entry.stream_step" and r.parent is None and w0 <= r.start_ns < w1]
    return statistics.median(steps) / 1e3 if steps else None
