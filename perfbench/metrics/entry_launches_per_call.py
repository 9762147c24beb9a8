"""entry_launches_per_call: the device launches the program issued (its
``launch.*`` counters: its kernels, and the kernels a wrapper issues
through PyTorch) over its entry calls (its ``call.*`` counters), over the
process.  Silent where the program keeps no such counters."""

from perfbench import program_spans


def read(ctx):
    return program_spans.launches_per_call(ctx)
