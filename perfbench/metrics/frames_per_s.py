"""frames_per_s: every frame (a raw stream carries one) whose outputs
completed in the window, over the window, from the first dispatch to the
last completion, on the host clock."""


def read(ctx):
    rec = ctx.records
    return rec.frames / rec.window_s if rec.frames and rec.window_s > 0 else None
