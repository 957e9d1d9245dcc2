"""The share of the traced stretch in which no operation ran on the
card, from the profiler's device intervals (kernels, copies, sets)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.stretch_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.stretch_s)
