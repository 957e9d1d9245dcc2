"""The coalescer's queue wait, mean ms a submitted search over the
window (``StageTimer`` ``coalesce_wait``: from ``submit`` to the start
of the dispatch of the group that holds the call, on whichever thread
runs it)."""


def read(ctx):
    return ctx.stage_ms("coalesce_wait")
