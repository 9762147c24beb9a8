"""setup_program_s: the seconds the process spent in the program's own
set-up (its ``setup.*`` spans: the nvcc builds, the library loads, the
chain's constants, the transmit spectra), their union over the process,
read from the program's span ring.  Silent where the program records no
set-up span."""

from perfbench import program_spans


def read(ctx):
    return program_spans.setup_s(ctx)
