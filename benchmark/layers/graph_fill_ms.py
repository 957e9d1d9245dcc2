"""The staging of a captured program's inputs (host array -> pinned
staging -> device), mean ms a replay or capture over the window
(``StageTimer`` ``graph_fill``: inside ``encode``, ``device_search`` and
``ce``, whose spans include it). Nothing from a program without the
span."""


def read(ctx):
    return ctx.stage_ms("graph_fill")
