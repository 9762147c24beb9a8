"""setup_s: from the start of the process to the first timed call: imports,
the card's context, the build of the program's kernels where they are not
built yet, the inputs, the program's set-up and the warm-up."""


def read(ctx):
    return ctx.setup_s
