"""The hybrid search's mean ms a call over the window (``StageTimer``
``device_search``: fill, replay and copy-out of the search program;
under concurrency it includes the wait for the graph set's lock)."""


def read(ctx):
    return ctx.stage_ms("device_search")
