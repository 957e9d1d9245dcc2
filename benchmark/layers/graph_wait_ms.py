"""The wait for the graph set's lock, mean ms a replay over the window
(``StageTimer`` ``graph_wait``: inside ``encode``, ``device_search`` and
``ce``, whose spans include it)."""


def read(ctx):
    return ctx.stage_ms("graph_wait")
