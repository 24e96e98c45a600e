"""Share of the traced window in which nothing (kernel, copy, memset) runs
on the card, in %."""


def read(ctx):
    window = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s() / window) if window > 0 else None
