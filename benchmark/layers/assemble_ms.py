"""Result assembly's mean ms a dispatch over the window (``StageTimer``
``assemble``: the ``SearchResult`` rows built from a search's outputs)."""


def read(ctx):
    return ctx.stage_ms("assemble")
