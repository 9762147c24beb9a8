"""entry_self_us: the host's time in an entry call outside the spans
directly inside it (its ``entry.*`` span's duration less what those
spans cover), the median over the calls whose entry span started in the
traced slice, read from the program's span ring on the profiler's clock.
Silent where the program records no entry span."""

from perfbench import program_spans


def read(ctx):
    return program_spans.self_us(ctx)
