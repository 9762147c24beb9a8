"""step_launches_per_call: the device launches the program issued (its
``launch.*`` counters: its kernels, and the kernels it issues through
PyTorch) over its device stream steps (its ``call.stream_step`` counter),
over the process.  Silent where the program counts no such step."""

from perfbench import program_spans


def read(ctx):
    sp = program_spans.module()
    if sp is None:
        return None
    c = sp.counters.snapshot()
    steps = c.get("call.stream_step", 0)
    launches = sum(v for k, v in c.items() if k.startswith("launch."))
    return launches / steps if steps else None
