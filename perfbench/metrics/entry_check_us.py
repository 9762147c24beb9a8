"""entry_check_us: the host's time in an entry call's argument checks (the
program's ``check`` span directly inside its ``entry.*`` span), the median
over the calls whose entry span started in the traced slice, read from the
program's span ring on the profiler's clock.  Silent where the program
records no such span."""

from perfbench import program_spans


def read(ctx):
    return program_spans.part_us(ctx, "check")
