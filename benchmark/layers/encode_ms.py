"""The query encoder's mean ms a call over the window (``StageTimer``
``encode``: host time around tokenize, fill, replay and copy-out; under
concurrency it includes the wait for the graph set's lock)."""


def read(ctx):
    return ctx.stage_ms("encode")
